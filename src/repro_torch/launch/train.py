"""Training launcher: any --arch at the smoke size, on one card or
sharded over the ranks of a process group.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-moe-30b-a3b \
        --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 2 \
        --checkpoint /tmp/state        # then --resume /tmp/state

The JAX package's `launch/train.py` with the same flags and defaults,
plus `--device` (the card unless told otherwise). As there, `--reduced`
is `store_true` with `default=True`, so the smoke-sized model always
runs. Parameters come from a `torch.Generator` seeded 0 on the device,
batches from `data.synth_tokens` seeded 1. `--checkpoint` saves the whole
`TrainState` (parameters, AdamW master and moments, counts) after the
last step and `--resume` restores one before the first
(`checkpoint/io.py`).

Sharded, as the reference runs it under `make_host_mesh(--model-axis)`:
started as ranks of a process group (`RANK`, `WORLD_SIZE`,
`REPRO_INIT_FILE` set, as `repro_torch.substrate.run_probe` or
`hostenv.rank_env` sets them), each rank joins the group (gloo, or NCCL
with `REPRO_BACKEND=nccl`), builds the (world // model-axis, model-axis)
(data, model) mesh, builds the same full state from seed 0 and keeps its
blocks (`init_sharded_train_state`: parameters by `param_pspecs`,
AdamW's master and moments by `opt_pspecs`, ZeRO-1), and takes its block of
each global batch; the step places the logits by `logits_pspec` and the
gradients by the opt specs, as the reference's jit does. Every rank
prints; a checkpoint is one global file, written by rank 0. Without the
rank environment `--model-axis` above 1 is refused. Every family trains
at any model axis its widths allow: the MoE expert parallel with the
global batch's routing, the RG-LRU and SSD blocks on each rank's
channels and heads.

On the CPU, four gloo ranks on a (2, 2) mesh:
`run_probe("from repro_torch.launch import train; train.main(['--device',
'cpu', '--model-axis', '2', '--steps', '2'])", world=4)`.
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch.checkpoint.io import restore_pytree, save_pytree
from repro_torch.configs import ASSIGNED, get_config, smoke
from repro_torch.data.synth_tokens import (
    sharded_lm_batches, synthetic_lm_batches,
)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.sharding.rules import (
    NamedSharding, logits_pspec, named, opt_pspecs,
)
from repro_torch.substrate.hostenv import init_from_env
from repro_torch.training.step import (
    init_sharded_train_state, init_train_state, make_train_step,
)

RANK_ENV = ("RANK", "WORLD_SIZE", "REPRO_INIT_FILE")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b", choices=ASSIGNED)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sharded = all(k in os.environ for k in RANK_ENV)
    if args.model_axis > 1 and not sharded:
        raise SystemExit(
            f"--model-axis {args.model_axis} trains sharded, as ranks of a "
            "process group (ROADMAP.md, queue A item 8): start one process "
            f"a rank with {', '.join(RANK_ENV)} set "
            "(repro_torch.substrate.run_probe or hostenv.rank_env)")

    dev = torch.device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = smoke(cfg)
    mesh = None
    if sharded:
        init_from_env(dev if os.environ.get("REPRO_BACKEND") == "nccl"
                      else None)
        mesh = make_host_mesh(args.model_axis, device_type=dev.type)
        print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
              f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))} "
              f"device={dev}")
    else:
        print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
              f"device={dev}")

    gen = torch.Generator(device=dev).manual_seed(0)
    kw = {}
    if mesh is None:
        state = init_train_state(gen, cfg)
    else:
        state = init_sharded_train_state(gen, cfg, mesh)
        kw = dict(logits_pspec=NamedSharding(
                      mesh, logits_pspec(mesh, cfg.padded_vocab, args.seq)),
                  grads_pspec=named(mesh, opt_pspecs(state.params, mesh)))
    if args.resume:
        state = restore_pytree(args.resume, state)
        print(f"resumed from {args.resume} at step {int(state.step)}")

    step = make_train_step(cfg, peak_lr=args.lr, warmup=20,
                           total_steps=args.steps,
                           microbatches=args.microbatches, **kw)
    fe_shape = ((cfg.n_frontend_tokens, cfg.d_model)
                if cfg.frontend else None)
    gen = torch.Generator(device=dev).manual_seed(1)
    shape = dict(vocab=cfg.vocab, batch=args.batch, seq=args.seq,
                 frontend_shape=fe_shape)
    batches = (synthetic_lm_batches(gen, **shape) if mesh is None
               else sharded_lm_batches(gen, mesh, **shape))
    losses = []
    t0 = time.time()
    for i, batch in zip(range(args.steps), batches):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        if i % max(1, args.steps // 10) == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss={losses[-1]:.4f}  "
                  f"grad={float(metrics['grad_norm']):.3f}  "
                  f"{(time.time()-t0)/(i+1):.2f}s/step", flush=True)
    if args.checkpoint:
        save_pytree(args.checkpoint, state)
        print(f"saved checkpoint to {args.checkpoint}")
    return state, losses


if __name__ == "__main__":
    main()
