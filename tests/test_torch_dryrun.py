"""The port's dry run and its counters, on the CPU.

* `launch.hlo.Counters` counts 7 · 2 · 64³ FLOPs for a loop of 7
  `tanh(c @ w)` on (64, 64): the counterpart of the reference's
  `test_analyze_hlo_scan_flops_exact` (a scanned loop's dots, counted
  once an iteration);
* `roofline` names compute, memory or the collectives as the bottleneck
  at the port's `HW`;
* `python -m repro_torch.launch.dryrun --arch granite-3-2b --shape
  train_4k --mesh 2x2 --reduced` (the smoke size, where every rule
  divides), in a subprocess: the fake group it starts becomes the
  process's default group. Its rank-0 argument bytes equal the sum over
  the leaves of the reference's train state and batch of the local-shard
  bytes the reference's own specs give them on a (2, 2) mesh, and its
  rank-0 FLOPs equal a quarter of the unsharded step's, counted by
  `torch.utils.flop_counter.FlopCounterMode` on fake tensors: the batch
  is split over `data` and every product's heads, ffn width or
  vocabulary over `model`;
* the reduced `prefill_32k`, `decode_32k` and `long_500k` records of
  granite-3-2b, deepseek-moe-16b and mamba2-1.3b on a fake 2 x 2 group
  (one subprocess): each `ok`, with collective bytes and model FLOPs of
  2 · active parameters · tokens; granite's prefill at a quarter of the
  unsharded prefill's FLOPs (`FlopCounterMode`), its decode steps at the
  count the split gives (the formula in
  `test_dryrun_decode_flops_follow_the_split`).
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config, smoke
from repro.sharding import rules as jrules
from repro.training.step import init_train_state as jax_init_train_state
import repro_torch.configs as tconfigs
from repro_torch.launch.hlo import Counters, roofline
from repro_torch.launch.mesh import HW
from repro_torch.launch.specs import SHAPES
from repro_torch.models import Batch
from repro_torch.substrate import REPO_ROOT
from repro_torch.training.step import init_train_state, make_train_step


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def test_counters_count_a_loop_of_products_exactly():
    c = torch.randn(64, 64)
    w = torch.randn(64, 64)
    with Counters() as k:
        x = c
        for _ in range(7):
            x = torch.tanh(x @ w)
    assert k.flops == 7 * 2 * 64 ** 3
    assert k.collectives() == {"total": 0}
    # each product reads two (64, 64) f32 operands and writes one, and
    # each tanh reads one and writes one
    assert k.bytes == 7 * (3 + 2) * 64 * 64 * 4


@pytest.mark.parametrize("flops, nbytes, coll, want", [
    (1e15, 1e9, 1e6, "compute"), (1e9, 1e13, 1e6, "memory"),
    (1e9, 1e9, 1e12, "collective")])
def test_roofline_picks_the_largest_term(flops, nbytes, coll, want):
    r = roofline(flops, nbytes, coll)
    assert r["bottleneck"] == want
    assert r["compute_s"] == flops / HW["peak_flops_bf16"]
    assert r["memory_s"] == nbytes / HW["hbm_bw"]
    assert r["collective_s"] == coll / HW["link_bw"]


def _reference_local_bytes(cfg, mesh_sizes, batch, seq) -> int:
    """One rank's bytes of the reference's train state and batch under its
    own specs: each leaf's bytes over the sizes of the axes its spec
    names."""
    class Mesh:
        shape = mesh_sizes
        axis_names = tuple(mesh_sizes)
    state = jax.eval_shape(lambda: jax_init_train_state(
        jax.random.PRNGKey(0), cfg))
    specs = jrules.train_state_pspecs(state, Mesh)
    bspec = jrules.batch_pspecs(Mesh, batch)
    tok = jax.ShapeDtypeStruct((batch, seq), np.int32)
    total = 0
    for leaf, spec in zip(
            jax.tree.leaves((state, (tok, tok))),
            jax.tree.leaves((specs, (bspec.tokens, bspec.labels)),
                            is_leaf=lambda x: isinstance(x, JP))):
        n = math.prod(leaf.shape) * np.dtype(leaf.dtype).itemsize
        for ax in spec:
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                if a is not None:
                    n //= mesh_sizes[a]
        total += n
    return total


def test_dryrun_counts_a_ranks_bytes_and_flops(tmp_path):
    out = tmp_path / "dryrun"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO_ROOT, "src"),
               OMP_NUM_THREADS="2")
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "granite-3-2b", "--shape", "train_4k", "--mesh", "2x2",
         "--reduced", "--out", str(out)],
        capture_output=True, text=True, timeout=120, cwd=REPO_ROOT, env=env)
    assert run.returncode == 0, run.stderr[-3000:]
    rec = json.loads(
        (out / "granite-3-2b__train_4k__2x2__reduced.json").read_text())
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["memory"]["temp_size_in_bytes"] is None
    B, S = 256, 4096
    jc = smoke(get_config("granite-3-2b"))
    assert rec["memory"]["argument_size_in_bytes"] == _reference_local_bytes(
        jc, {"data": 2, "model": 2}, B, S)

    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    tc = tconfigs.smoke(tconfigs.get_config("granite-3-2b"))
    with FakeTensorMode():
        state = init_train_state(torch.Generator(), tc)
        tok = torch.zeros((B, S), dtype=torch.int32)
        with FlopCounterMode(display=False) as f:
            make_train_step(tc)(state, Batch(tok, tok))
    assert rec["microbatches"] == 1
    assert rec["flops_per_chip"] == f.get_total_flops() / 4
    assert rec["model_flops"] == 6 * tc.active_param_count() * B * S
    assert rec["collective_bytes_per_chip"]["total"] > 0
    assert rec["roofline"]["bottleneck"] in ("compute", "memory",
                                             "collective")


def _routed_and_replicated_flops(tc, T: int, model: int) -> float:
    """What a rank of a (4, `model`) mesh does beyond 1/16 of the
    unsharded step, from the shapes (each product counted 4 times: the
    forward, remat's recompute, the two products of its backward): the
    MoE's router on all T tokens (every rank routes the global batch),
    its E/M experts on all their C slots (the expert batch is the same on
    every data rank), the k and v projections where the kv heads do not
    divide `model` (replicated: 3 times in the dense head layer, which
    runs outside remat); the SSD's B and C columns of `w_in`, which every
    rank of `model` projects."""
    d, ranks = tc.d_model, 4 * model
    if tc.moe is not None:
        mc = tc.moe
        E, K = mc.n_experts, mc.top_k
        C = math.ceil(T * K * mc.capacity_factor / E)
        router = 4 * 2 * T * d * E
        experts = 4 * 3 * 2 * E * C * d * mc.d_expert
        extra = router * (1 - 1 / ranks) + experts * (1 / model - 1 / ranks)
        if tc.n_kv_heads % model:
            kv = (3 + 4) * 2 * 2 * T * d * tc.n_kv_heads * tc.resolved_head_dim
            extra += kv * (1 / 4 - 1 / ranks)
        return extra
    sc = tc.ssd
    bc = tc.n_layers * 4 * 2 * T * d * 2 * sc.n_groups * sc.state_dim
    return bc * (1 / 4 - 1 / ranks)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mamba2-1.3b"])
def test_dryrun_runs_the_moe_and_ssm_sharded_step(tmp_path, arch):
    """At the smoke size on a fake 4 x 4 group the MoE and SSM families'
    sharded step runs (`status: "ok"`), and rank 0's FLOPs are 1/16 of
    the unsharded step's (counted on fake tensors as above) but for the
    work each rank of `model` does whole (`_routed_and_replicated_flops`):
    the MoE's router and its E/M = 1 expert's slots, the SSD's H/M = 1
    head with B and C projected on every rank."""
    out = tmp_path / "dryrun"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO_ROOT, "src"),
               OMP_NUM_THREADS="2")
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", "train_4k", "--mesh", "4x4", "--reduced", "--out",
         str(out)],
        capture_output=True, text=True, timeout=180, cwd=REPO_ROOT, env=env)
    assert run.returncode == 0, run.stderr[-3000:]
    rec = json.loads((out / f"{arch}__train_4k__4x4__reduced.json").read_text())
    assert rec["status"] == "ok", rec.get("traceback")
    calls = rec["collective_calls"]
    assert calls["all-gather"] > 0 and calls["reduce-scatter"] > 0, calls

    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    B, S = 256, 4096
    tc = tconfigs.smoke(tconfigs.get_config(arch))
    with FakeTensorMode():
        state = init_train_state(torch.Generator(), tc)
        tok = torch.zeros((B, S), dtype=torch.int32)
        with FlopCounterMode(display=False) as f:
            make_train_step(tc)(state, Batch(tok, tok))
    assert rec["microbatches"] == 1
    assert rec["flops_per_chip"] == \
        f.get_total_flops() / 16 + _routed_and_replicated_flops(tc, B * S, 4)


SERVE_ARCHS = ["granite-3-2b", "deepseek-moe-16b", "mamba2-1.3b"]
SERVE_SHAPES = ["prefill_32k", "decode_32k", "long_500k"]


@pytest.fixture(scope="module")
def serve_records(tmp_path_factory):
    """The reduced prefill, decode and `long_500k` records of three
    family kinds on a fake 2 x 2 group, from one dry run (a subprocess)."""
    out = tmp_path_factory.mktemp("dryrun_serve")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO_ROOT, "src"),
               OMP_NUM_THREADS="2")
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         ",".join(SERVE_ARCHS), "--shape", ",".join(SERVE_SHAPES),
         "--mesh", "2x2", "--reduced", "--out", str(out)],
        capture_output=True, text=True, timeout=300, cwd=REPO_ROOT, env=env)
    assert run.returncode == 0, run.stderr[-3000:]
    return {(a, s): json.loads(
        (out / f"{a}__{s}__2x2__reduced.json").read_text())
        for a in SERVE_ARCHS for s in SERVE_SHAPES}


@pytest.mark.parametrize("arch", SERVE_ARCHS)
@pytest.mark.parametrize("shape", SERVE_SHAPES)
def test_dryrun_counts_the_sharded_serving_steps(serve_records, arch,
                                                 shape):
    """Each record ran its step (`status: "ok"`, no `bytes_only`), moved
    bytes over the ranks, and counts 2 · active parameters · tokens as
    its model FLOPs: B · S tokens for the prefill, B for a decode
    step."""
    rec = serve_records[(arch, shape)]
    assert rec["status"] == "ok", rec.get("traceback")
    assert "bytes_only" not in json.dumps(rec)
    assert rec["collective_bytes_per_chip"]["total"] > 0
    assert rec["microbatches"] == 0
    info = SHAPES[shape]
    tc = tconfigs.smoke(tconfigs.get_config(arch))
    tokens = info["batch"] * (info["seq"] if info["mode"] == "prefill"
                              else 1)
    assert rec["model_flops"] == 2 * tc.active_param_count() * tokens
    assert rec["flops_per_chip"] > 0
    assert rec["roofline"]["bottleneck"] in ("compute", "memory",
                                             "collective")


def test_dryrun_prefill_flops_are_a_quarter_of_the_unsharded(serve_records):
    """Granite's sharded prefill on 2 x 2: the batch split over `data`,
    every product's heads, ffn width or vocabulary over `model`, so rank
    0's FLOPs are a quarter of the unsharded prefill's, counted by
    `FlopCounterMode` on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.models import init_params
    from repro_torch.serving.engine import make_prefill_step
    info = SHAPES["prefill_32k"]
    B, S = info["batch"], info["seq"]
    tc = tconfigs.smoke(tconfigs.get_config("granite-3-2b"))
    with FakeTensorMode():
        params = init_params(torch.Generator(), tc)
        tok = torch.zeros((B, S), dtype=torch.int32)
        with FlopCounterMode(display=False) as f:
            make_prefill_step(tc, cache_len=S)(params, Batch(tok))
    rec = serve_records[("granite-3-2b", "prefill_32k")]
    assert rec["flops_per_chip"] == f.get_total_flops() / 4


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_dryrun_decode_flops_follow_the_split(serve_records, shape):
    """Granite's decode step on 2 x 2, rank 0: its B / 2 rows, and over
    `model` M = 2 its share of the heads, the ffn width and the
    vocabulary, and L / M of the cache's L slots for every one of the N
    heads (the split softmax). Per layer, 2 · (B / 2) · [d H (N + 2K) / M
    (q, k, v) + 2 N H L / M (the scores and p · v) + N H d / M (wo) +
    3 d F / M (the gated MLP)], and the head's 2 · (B / 2) · d · V / M.
    `long_500k` is the sliding-window form: L is the window."""
    info = SHAPES[shape]
    tc = tconfigs.smoke(tconfigs.get_config("granite-3-2b"))
    if shape == "long_500k":
        tc = tconfigs.smoke(tc.replace(window=4096))
    B, M = info["batch"], 2
    rows = max(B // 2, 1) if B % 2 == 0 else B
    L = min(info["seq"], tc.window) if tc.window else info["seq"]
    d, N, K, H = tc.d_model, tc.n_heads, tc.n_kv_heads, tc.resolved_head_dim
    layer = (d * H * (N + 2 * K) // M + 2 * N * H * L // M
             + N * H * d // M + 3 * d * tc.d_ff // M)
    want = 2 * rows * (tc.n_layers * layer + d * tc.padded_vocab // M)
    rec = serve_records[("granite-3-2b", shape)]
    assert rec["flops_per_chip"] == want
