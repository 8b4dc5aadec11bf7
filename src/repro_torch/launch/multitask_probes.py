"""The paper's technique as a framework feature: communication-efficient
multi-task sparse probes on frozen backbone features.

    PYTHONPATH=src python -m repro_torch.launch.multitask_probes [--device cpu]

The port's counterpart of the JAX package's `examples/multitask_probes.py`,
with its printout and `--device` (the card unless told otherwise). Four
"machines" each own a task (their own labelled data); the backbone,
granite-3-2b reduced by `smoke` in float32, is shared and frozen. DSML
recovers the common sparse support over feature dimensions with ONE
round of communication. Parameters and tasks come from seeded
`torch.Generator`s (seeds 0 and 1), so their numbers differ from the
reference example's.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config, smoke
from repro_torch.models import init_params
from repro_torch.multitask import (
    probe_predict, sparse_probe_fit, synthetic_probe_tasks,
)


def main(argv=None):
    """Run the probe demo; returns (fit result, R^2)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    cfg = smoke(get_config("granite-3-2b")).replace(
        compute_dtype="float32", param_dtype="float32")
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    print(f"backbone: {cfg.name} (reduced) d_model={cfg.d_model}")

    data, support = synthetic_probe_tasks(
        torch.Generator(device=dev).manual_seed(1), params, cfg, m=4, n=96,
        s_active=6)
    print(f"tasks=4, samples/task=96, active feature dims="
          f"{int(support.sum())}")

    res = sparse_probe_fit(data)
    tp = int(torch.sum(res.support & support))
    fp = int(torch.sum(res.support & ~support))
    print(f"recovered support: {tp}/{int(support.sum())} true dims, "
          f"{fp} false positives")

    pred = probe_predict(res, data.features)
    r2 = 1 - float(torch.var(pred - data.targets, correction=0)
                   / torch.var(data.targets, correction=0))
    print(f"fit R^2 = {r2:.3f}")
    d = cfg.d_model
    print(f"communication: one round of {d} floats per task "
          f"(vs shipping {data.features.shape[1]}x{d} features per task)")
    return res, r2


if __name__ == "__main__":
    main()
