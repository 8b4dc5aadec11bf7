"""The port's sharded train step for the MoE, RG-LRU hybrid and SSM
families against the JAX package's unsharded one, on gloo ranks on the
CPU.

Smoke configurations in f32, the reference's state and one batch made
with numpy, each step held to the reference's jitted step on the same
state and batch by `test_torch_train_sharded.py`'s bars (its helpers):

* all four families at (data, model) = (1, 2): deepseek-moe-16b and
  qwen3-moe-30b-a3b expert parallel (2 of the 4 smoke experts a rank,
  the router's columns split, the routing global), recurrentgemma-9b
  channel parallel (128 of the 256 RG-LRU channels a rank) with its one
  kv head replicated, mamba2-1.3b head parallel (2 of 4 heads a rank,
  `w_in` and `conv_w` gathered: their even split is not by heads);
* deepseek-moe-16b at (2, 2) with two microbatches and its capacity
  binding, against the reference's step with two (each microbatch
  routed as one global batch; the reference drops tokens there);
* mamba2-1.3b at (1, 4), one head a rank;
* the collectives of one step by the op that ran them, for
  deepseek-moe-16b and mamba2-1.3b at (1, 2): the ledger's synchronous
  all-gathers and reduce-scatters and DTensor's all-reduces, and no
  DTensor (functional) all-gather, which crashes gloo ranks that hold
  CUDA tensors on the card's PyTorch;
* `launch/train.py --model-axis 2` on 2 ranks for each of the four
  families.

mamba2-1.3b's cases take `port_floor`: the gradient of layer 0's `D`
sums terms that cancel (its first head's is a tenth of the others'),
and the f32 rounding of the input projection alone moves it by about
7e-6 of the leaf's largest value between the reference and the one-card
port, so the one-card port's own step is outside the nu bar (2 × that)
there. Such a leaf is held to the one-card port's step by the same bar:
the sharding adds nothing measurable (1e-6 there). Every other leaf is
held to the reference.
"""
from __future__ import annotations

import math
import re

import numpy as np
import pytest

from repro_torch.substrate import run_probe
from test_torch_train_sharded import (
    BINDING, _batch_arrays, _configs, _held_to_reference, _init_state,
    _reference_drops, _run,
)

FAMILIES = ["deepseek-moe-16b", "qwen3-moe-30b-a3b", "recurrentgemma-9b",
            "mamba2-1.3b"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_model_parallel_step_matches_reference(tmp_path, arch):
    _held_to_reference(tmp_path, arch, (1, 2),
                       port_floor=arch == "mamba2-1.3b")


def test_moe_routes_each_microbatch_globally(tmp_path):
    """(2, 2), two microbatches: each microbatch's rows, split over the
    data ranks, are gathered and routed as one batch with the binding
    capacity, as the reference's scan routes its microbatch."""
    jc, tc = _configs("deepseek-moe-16b", **BINDING)
    arrays = _batch_arrays(tc)
    half = {k: v[: v.shape[0] // 2] for k, v in arrays.items()}
    drops = _reference_drops("deepseek-moe-16b", half, **BINDING)
    assert drops and min(drops) > 0, drops
    _held_to_reference(tmp_path, "deepseek-moe-16b", (2, 2), microbatches=2,
                       **BINDING)


def test_ssd_one_head_a_rank_matches_reference(tmp_path):
    _held_to_reference(tmp_path, "mamba2-1.3b", (1, 4), port_floor=True)


def test_step_collectives_go_through_the_ledger(tmp_path):
    """(1, 2), one step from the port's seed-0 state, the collectives by
    op. deepseek-moe-16b (a dense layer, then one MoE layer under remat):
    the router gathered over `model` in the forward and again in the
    recompute, its gradient reduce-scattered once. mamba2-1.3b (two SSD
    layers under remat): `w_in` and `conv_w` gathered in the forward and
    the recompute and their gradients reduce-scattered, 4 gathers and 2
    reduce-scatters a layer. Every all-gather and reduce-scatter is the
    ledger's (`c10d.*`); DTensor's own collectives are all-reduces
    alone."""
    want = {"deepseek-moe-16b": (2, 1), "mamba2-1.3b": (8, 4)}
    tc = _configs("granite-3-2b")[1]
    np.savez(tmp_path / "batch.npz", **_batch_arrays(tc))
    for arch, (gathers, scatters) in want.items():
        tc = _configs(arch)[1]
        got = _run(tmp_path, arch, 2, arch=arch, model=2,
                   states=[_init_state(tmp_path, tc, arch)],
                   batch=str(tmp_path / "batch.npz"))[0]
        ops = got["ops"]
        functional = {k: v for k, v in ops.items()
                      if k.startswith("_c10d_functional")
                      and "all_reduce" not in k}
        assert not functional, (arch, ops)
        assert got["calls"]["all-gather"] == gathers, (arch, ops)
        assert got["calls"]["reduce-scatter"] == scatters, (arch, ops)
        assert got["calls"]["all-reduce"] > 0, (arch, ops)


@pytest.mark.parametrize("arch", FAMILIES)
def test_launcher_trains_the_family_at_model_axis_2(arch):
    run = run_probe(
        "from repro_torch.launch import train; train.main(['--device', "
        f"'cpu', '--arch', '{arch}', '--model-axis', '2', '--steps', '1', "
        "'--batch', '2', '--seq', '64'])", world=2, timeout=120,
        pg_timeout=60)
    assert run.ok, run.report()
    for r in run.ranks:
        assert "mesh={'data': 1, 'model': 2}" in r.stdout, r.stdout
        loss = re.search(r"step +0 +loss=(\S+)", r.stdout)
        assert loss and math.isfinite(float(loss.group(1))), r.stdout
