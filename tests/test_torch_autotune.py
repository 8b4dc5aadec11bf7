"""The port's launch-plan autotuning (`repro_torch.kernels.autotune`) and
the `block=` API it feeds, on the CPU.

The sweep times on the card, so here `_time_candidate` is replaced by a
fake that counts its calls and makes the last candidate the fastest: the
tests hold the cache's round trip (a sweep, then a memory hit, then a
disk hit), its keys and file, its guards (several ranks, CUDA graph
capture, `torch.compile`), and the engine's policies. Every `block=` of
the kernel wrappers and the engine is validated on the CPU path too; the
plain versions ignore it, so the engine gives the same result with every
plan as with None, and holds to the JAX reference within 1e-5 on the
reference's own synthetic data. The card's side (each plan launched and
held to the plain version, a real sweep) is in `tests/test_torch_gpu.py`.
"""
from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import synth as jsynth
from repro_torch import obs
from repro_torch.core import engine
from repro_torch.kernels import autotune
from repro_torch.kernels.common import LAUNCHES
from repro_torch.kernels.ista_step import ops as ista_ops
from repro_torch.kernels.logistic_grad import ops as logistic_ops
from repro_torch.kernels.rank_update import ops as rank_ops
from repro_torch.stream import service as service_mod
from repro_torch.stream.service import StreamingDsmlService
from tools.repro_lint.cachecheck import KEY_RE

ATOL = 1e-5
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    """A fresh cache file and an empty memory cache and registry."""
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path))
    autotune.clear_memory_cache()
    obs.reset()
    yield tmp_path
    autotune.clear_memory_cache()


@pytest.fixture
def timed(monkeypatch):
    """Replace the sweep's timing: every call is recorded, and each
    candidate times faster than the one before it."""
    calls = []

    def fake(fn, reps):
        calls.append(reps)
        return 100.0 - len(calls)

    monkeypatch.setattr(autotune, "_time_candidate", fake)
    return calls


# (entry point, dims, candidates): small shapes; p = 2048 gives the fused
# logistic gradient two cluster sizes
KERNELS = {
    "fista_step_r1": (autotune.autotune_block, (2, 8, 1),
                      autotune.block_candidates),
    "fista_step_rp": (autotune.autotune_block, (2, 8, 8),
                      autotune.block_candidates),
    "fista_step_grid": (autotune.autotune_grid_block, (2, 8, 3),
                        lambda m, p, k: autotune.block_candidates(m, p, 1)),
    "logistic_grad": (autotune.autotune_logistic_block, (2, 4, 2048),
                      autotune.logistic_candidates),
    "rank_update": (autotune.autotune_rank_block, (2, 4, 8),
                    autotune.rank_candidates),
}


def _events(event: str) -> float:
    return obs.counter_total("autotune.cache", event=event)


@pytest.mark.parametrize("name", list(KERNELS))
def test_cache_round_trip(name, cache_dir, timed):
    """A first lookup times every candidate once and keeps the fastest;
    a second is a memory hit; after the memory cache is cleared, a disk
    hit. None of them times anything again."""
    fn, dims, candidates = KERNELS[name]
    want = candidates(*dims)
    first = fn(*dims, device=CPU)
    assert len(timed) == len(want) and first == want[-1]
    assert _events("miss_sweep") == 1
    assert obs.hist_stats("autotune.candidate_us")["count"] == len(want)
    assert fn(*dims, device=CPU) == first and len(timed) == len(want)
    assert _events("hit_memory") == 1
    autotune.clear_memory_cache()
    assert fn(*dims, device=CPU) == first and len(timed) == len(want)
    assert _events("hit_disk") == 1
    entries = json.loads(autotune.cache_path().read_text())
    assert len(entries) == 1
    stored = next(iter(entries.values()))
    plan = stored["plan"]
    assert (tuple(plan) if isinstance(plan, list) else plan) == first
    assert stored["among"] == [list(c) if isinstance(c, tuple) else c
                               for c in want]


def test_a_sweep_does_not_count_as_launches(cache_dir, monkeypatch):
    """A sweep's launches are restored out of LAUNCHES: they are not the
    path's."""
    def launching(fn, reps):
        LAUNCHES["fista_step_gemv"] += 1 + reps
        return 1.0

    monkeypatch.setattr(autotune, "_time_candidate", launching)
    before = dict(LAUNCHES)
    autotune.autotune_block(2, 8, 1, device=CPU)
    assert dict(LAUNCHES) == before


TILES = [list(t) for t in rank_ops.RANK_TILES]
STALE = {
    "a plan not among the candidates (a hand edit)":
        {"plan": [128, 128], "among": TILES},
    "timed among another table": {"plan": TILES[0], "among": TILES[1:]},
    "a bare plan, without the candidates it was timed among":
        TILES[0],
}


@pytest.mark.parametrize("case", list(STALE))
def test_a_stale_disk_entry_is_timed_again(case, cache_dir, timed):
    """An entry whose plan is not among the candidates, or that was timed
    among other candidates than the table's now, is a miss, and the
    sweep's winner replaces it."""
    key = autotune.cache_key("rank_update", "cpu",
                             {"m": 2, "n": 4, "p": 8}, torch.float32)
    autotune.cache_path().write_text(json.dumps({key: STALE[case]}))
    got = autotune.autotune_rank_block(2, 4, 8, device=CPU)
    assert got == rank_ops.RANK_TILES[-1] and timed
    assert _events("miss_sweep") == 1 and _events("hit_disk") == 0
    assert json.loads(autotune.cache_path().read_text())[key] == {
        "plan": list(got), "among": TILES}


def test_keys_are_namespaced_per_kernel(cache_dir, timed, monkeypatch):
    """Three kernels whose dimensions coincide get a key each, every key
    in the grammar the repository's cache lint reads, all in the port's
    own file, never `.cache/autotune.json`."""
    autotune.autotune_block(4, 8, 8, device=CPU)
    autotune.autotune_logistic_block(4, 8, 8, device=CPU)
    autotune.autotune_rank_block(4, 8, 8, device=CPU)
    entries = json.loads(autotune.cache_path().read_text())
    assert sorted(k.split("/")[0] for k in entries) == [
        "fista_step", "logistic_grad", "rank_update"]
    assert all(KEY_RE.match(k) for k in entries), list(entries)
    assert "rank_update/cpu_m4_n8_p8_float32" in entries
    assert sorted(p.name for p in cache_dir.iterdir()) == [
        "repro_torch_autotune.json"]
    monkeypatch.delenv("REPRO_TORCH_CACHE_DIR")
    default = autotune.cache_path()
    assert default.name == "repro_torch_autotune.json"
    assert default.parent.name == ".cache"
    assert autotune.backend_slug(CPU) == "cpu"


EARLIER = {
    # the file as the table of two tiles (128 x 64, 64 x 64) left it
    "a bare winner": [128, 64],
    # an entry timed over the two tiles of 16-deep, 4-stage rings
    "timed over the earlier table": {
        "plan": [128, 64, 16, 4],
        "among": [[128, 64, 16, 4], [64, 64, 16, 4]]},
}


@pytest.mark.parametrize("case", list(EARLIER))
def test_an_r_gt_1_entry_of_the_earlier_table_is_not_read(case, cache_dir,
                                                          timed):
    """An r > 1 entry written over an earlier tile table (its winner,
    128 x 64, still a tile of the table) is not read: the step is timed
    again over every tile, the short-row one among them, and the entry
    replaced under the same key. The r = 1 and grid keys are as they
    were."""
    dims = {"m": 2, "p": 8, "r": 8}
    key = autotune.cache_key("fista_step", "cpu", dims, torch.float32)
    assert key == "fista_step/cpu_m2_p8_r8_float32"
    autotune.cache_path().write_text(json.dumps({key: EARLIER[case]}))
    assert ista_ops.check_block("test", 8, (128, 64)) == 0
    got = autotune.autotune_block(2, 8, 8, device=CPU)
    assert got == ista_ops.GEMM_TILES[-1]
    assert len(timed) == len(ista_ops.GEMM_TILES)
    assert _events("miss_sweep") == 1 and _events("hit_disk") == 0
    entries = json.loads(autotune.cache_path().read_text())
    assert entries == {key: {"plan": list(got), "among": [
        list(t) for t in ista_ops.GEMM_TILES]}}
    autotune.autotune_block(2, 8, 1, device=CPU)
    autotune.autotune_grid_block(2, 8, 3, device=CPU)
    entries = json.loads(autotune.cache_path().read_text())
    assert {"fista_step/cpu_m2_p8_r1_float32",
            "fista_step/cpu_m2_p8_k3_float32"} <= set(entries)
    assert all(KEY_RE.match(k) for k in entries), list(entries)


def test_grid_key_is_not_the_r1_key(cache_dir, timed, monkeypatch):
    """The lambda grid's step keeps a key of its own, with k: neither the
    r = 1 key of the same m and p nor that of the k m problems tiled, and
    the grid's solve asks for it."""
    autotune.autotune_block(2, 8, 1, device=CPU)
    autotune.autotune_block(6, 8, 1, device=CPU)
    autotune.autotune_grid_block(2, 8, 3, device=CPU)
    entries = json.loads(autotune.cache_path().read_text())
    assert sorted(entries) == ["fista_step/cpu_m2_p8_k3_float32",
                               "fista_step/cpu_m2_p8_r1_float32",
                               "fista_step/cpu_m6_p8_r1_float32"]
    assert all(KEY_RE.match(k) for k in entries), list(entries)
    asked = []
    monkeypatch.setattr(engine, "_on_kernel", lambda use_kernel, dev: True)
    monkeypatch.setattr(autotune, "autotune_grid_block",
                        lambda *a, **kw: asked.append(a) or None)
    engine.resolve_block_policy(2, 8, 1, torch.float32, None, None, CPU,
                                lams=3)
    assert asked == [(2, 8, 3)]


def test_one_lambda_grid_takes_the_r1_key(cache_dir, timed, monkeypatch):
    """A grid of one lambda is the (m, p, 1) solve: its plan is asked of
    `autotune_block` at r = 1, and no grid key is made."""
    asked = []
    monkeypatch.setattr(engine, "_on_kernel", lambda use_kernel, dev: True)
    monkeypatch.setattr(autotune, "autotune_block",
                        lambda *a, **kw: asked.append(("r", a)) or None)
    monkeypatch.setattr(autotune, "autotune_grid_block",
                        lambda *a, **kw: asked.append(("k", a)) or None)
    engine.resolve_block_policy(2, 8, 1, torch.float32, None, None, CPU,
                                lams=1)
    engine.resolve_block_policy(2, 8, 1, torch.float32, None, None, CPU,
                                lams=2)
    assert asked == [("r", (2, 8, 1)), ("k", (2, 8, 2))]


def test_several_ranks_take_the_rule(cache_dir, timed, monkeypatch):
    """With torch.distributed initialized over two ranks every entry point
    returns the rule's plan (None), times nothing and caches nothing."""
    monkeypatch.setattr(torch.distributed, "is_available", lambda: True)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size",
                        lambda group=None: 2)
    for fn, dims, _ in KERNELS.values():
        assert fn(*dims, device=CPU) is None
    assert not timed and not autotune.cache_path().exists()
    assert _events("default_multiprocess") == len(KERNELS)


@pytest.mark.parametrize("how", ["cuda_graph_capture", "torch_compile"])
def test_capture_and_compile_take_the_rule(how, cache_dir, timed,
                                          monkeypatch):
    """During CUDA graph capture or torch.compile tracing every entry
    point returns the rule's plan, times and caches nothing; a later
    lookup outside it still sweeps."""
    with monkeypatch.context() as mp:
        if how == "cuda_graph_capture":
            mp.setattr(torch.cuda, "is_available", lambda: True)
            mp.setattr(torch.cuda, "is_current_stream_capturing",
                       lambda: True)
        else:
            mp.setattr(torch.compiler, "is_compiling", lambda: True)
        for fn, dims, _ in KERNELS.values():
            assert fn(*dims, device=CPU) is None
        assert not timed and not autotune.cache_path().exists()
        assert _events("deferred_capture") == len(KERNELS)
    fn, dims, candidates = KERNELS["fista_step_r1"]
    assert fn(*dims, device=CPU) == candidates(*dims)[-1]
    assert len(timed) == len(candidates(*dims))


def test_candidates_are_the_plan_tables():
    """The candidates are the launchers' tables, the fused logistic
    gradient's cluster sizes cut at `cluster_max`; the fit cell's sweep
    at (1024, 200, 200) times the rule's short-row tile too."""
    assert autotune.block_candidates(16, 1024, 1) == list(
        ista_ops.GEMV_PLANS)
    assert autotune.block_candidates(16, 1024, 1024) == list(
        ista_ops.GEMM_TILES)
    rule = ista_ops.gemm_plan(1024, 200, 200, 132)
    assert (rule.bm, rule.bn) in [
        t[:2] for t in autotune.block_candidates(1024, 200, 200)]
    assert autotune.rank_candidates(16, 512, 1024) == list(
        rank_ops.RANK_TILES)
    assert autotune.logistic_candidates(16, 512, 1024) == [1]
    assert autotune.logistic_candidates(4, 256, 2048) == [1, 2]
    assert autotune.logistic_candidates(4, 256, 8192) == [1, 2, 4, 8]
    assert autotune.logistic_candidates(1, 8, 4095) == [1, 2, 4, 8]


@pytest.mark.parametrize("m, n, p", [(16, 512, 1024), (4, 256, 8192),
                                     (8, 1024, 2048), (1, 8, 100003)])
def test_a_forced_cluster_keeps_the_rules_chunks_and_mode(m, n, p):
    """`plan(..., cluster=c)` is the rule's plan where c is the rule's
    cluster, and at every allowed size takes that cluster, with chunks
    that cover n and a mode by the slice it leaves."""
    sms, optin = 132, 232448
    rule = logistic_ops.plan(m, n, p, sms, optin)
    assert logistic_ops.plan(m, n, p, sms, optin,
                             cluster=rule.cluster) == rule
    for c in autotune.logistic_candidates(m, n, p):
        pl = logistic_ops.plan(m, n, p, sms, optin, cluster=c)
        assert pl.cluster == c
        assert pl.chunks * pl.rows_per_chunk >= n
        assert (pl.chunks - 1) * pl.rows_per_chunk < n
        width = 4 if p % 4 == 0 else 1
        vecs = -(-(-(-p // width) // c) // logistic_ops.THREADS)
        assert (pl.mode == "registers") == (vecs <= logistic_ops.V_MAX)


# ---- block= on the wrappers and the engine ------------------------------

def _inputs(m=2, n=12, p=16, r=1, seed=0):
    rng = np.random.default_rng(seed)
    X = torch.from_numpy(rng.standard_normal((m, n, p)).astype(np.float32))
    y = torch.from_numpy(np.sign(rng.standard_normal((m, n))).astype(
        np.float32))
    Sig = torch.einsum("tni,tnj->tij", X, X) / n
    z = torch.from_numpy(rng.standard_normal((m, p, r)).astype(np.float32))
    B = torch.from_numpy(rng.standard_normal((m, p)).astype(np.float32))
    etas = torch.full((m,), 0.05)
    return X, y, Sig, z, B, etas


def _calls():
    """name -> (call taking a block, the table its error names)."""
    X, y, Sig, z, B, etas = _inputs()
    Z = torch.cat([z] * 3, dim=-1)
    return {
        "fista_step_batched r=1": (lambda b: ista_ops.fista_step_batched(
            Sig, z, z, z, etas, 0.1, 0.5, block=b), "GEMV_PLANS"),
        "fista_step_batched r=3": (lambda b: ista_ops.fista_step_batched(
            Sig, Z, Z, Z, etas, 0.1, 0.5, block=b), "GEMM_TILES"),
        "ista_step_batched": (lambda b: ista_ops.ista_step_batched(
            Sig, z, z, etas, 0.1, block=b), "GEMV_PLANS"),
        "ista_step": (lambda b: ista_ops.ista_step(
            Sig[0], Z[0], Z[0], 0.05, 0.1, block=b), "GEMM_TILES"),
        "ista_solve": (lambda b: ista_ops.ista_solve(
            Sig[0], z[0, :, 0], 0.1, iters=2, block=b), "GEMV_PLANS"),
        "rank_update": (lambda b: rank_ops.rank_update(X, y, block=b),
                        "RANK_TILES"),
        "rank_update_unfused": (lambda b: rank_ops.rank_update_unfused(
            X, y, block=b), "RANK_TILES"),
        "logistic_grad": (lambda b: logistic_ops.logistic_grad(
            X, y, B, block=b), "cluster size"),
        "logistic_grad_unfused": (lambda b: logistic_ops.logistic_grad_unfused(
            X, y, B, block=b), "UNFUSED_Z_PLANS"),
        "sufficient_stats": (lambda b: engine.sufficient_stats(
            X, y, block=b), "RANK_TILES"),
        "solve_lasso_batched": (lambda b: engine.solve_lasso_batched(
            Sig, z[..., 0], 0.1, iters=2, block=b), "GEMV_PLANS"),
        "solve_lasso_grid": (lambda b: engine.solve_lasso_grid(
            Sig, z[..., 0], [0.1, 0.2], iters=2, block=b), "GEMV_PLANS"),
        "solve_logistic_lasso_batched": (
            lambda b: engine.solve_logistic_lasso_batched(
                X, y, 0.1, iters=2, block=b), "cluster size"),
    }


CALL_NAMES = list(_calls())


@pytest.mark.parametrize("bad", [128, (128, 128, 128), (64, 32), (2.0, 8.0),
                                 "auto"])
@pytest.mark.parametrize("name", CALL_NAMES)
def test_a_block_outside_its_table_raises_on_the_cpu(name, bad):
    """The JAX package's TPU tilings, a wrong tile, floats and strings
    raise ValueError naming the table, on the CPU path as on CUDA."""
    call, table = _calls()[name]
    with pytest.raises(ValueError, match=table):
        call(bad)


def _candidates_of(name: str) -> list:
    if name in ("fista_step_batched r=1", "ista_step_batched", "ista_solve",
                "solve_lasso_batched", "solve_lasso_grid"):
        return list(ista_ops.GEMV_PLANS)
    if name in ("fista_step_batched r=3", "ista_step"):
        return [*ista_ops.GEMM_TILES, *(t[:2] for t in ista_ops.GEMM_TILES)]
    if name in ("rank_update", "rank_update_unfused", "sufficient_stats"):
        return list(rank_ops.RANK_TILES)
    if name in ("logistic_grad", "solve_logistic_lasso_batched"):
        return [1]
    return [(*z, c) for z in logistic_ops.UNFUSED_Z_PLANS
            for c in logistic_ops.UNFUSED_COLS]


def _same(a, b) -> bool:
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("name", CALL_NAMES)
def test_every_plan_is_accepted_and_ignored_on_the_cpu(name, cache_dir,
                                                       timed):
    """Every entry of a call's table (a list, as a cache file gives it,
    too) runs the plain version with None's bits, and nothing consults
    the cache."""
    call, _ = _calls()[name]
    want = call(None)
    for block in _candidates_of(name):
        assert _same(call(block), want), block
        if isinstance(block, tuple):
            assert _same(call(list(block)), want), block
    assert not timed and not autotune.cache_path().exists()


def test_an_explicit_block_wins_and_none_takes_the_winner(cache_dir, timed,
                                                          monkeypatch):
    """Where kernels launch, an explicit block is returned untouched and
    writes no cache; None takes the timed winner, which the file keeps.
    On the CPU path None stays None and nothing is timed."""
    f32 = torch.float32
    assert engine.resolve_block_policy(4, 8, 1, f32, None, None, CPU) is None
    assert engine.resolve_rank_block_policy(4, 8, 8, f32, None, True,
                                            CPU) is None
    assert not timed
    monkeypatch.setattr(engine, "_on_kernel", lambda use_kernel, dev: True)
    assert engine.resolve_block_policy(4, 8, 1, f32, (2, 8), None,
                                       CPU) == (2, 8)
    assert engine.resolve_block_policy(4, 8, 8, f32, [64, 64], None,
                                       CPU) == [64, 64]
    assert engine.resolve_logistic_block_policy(4, 8, 2048, f32, 2, None,
                                                CPU) == 2
    assert engine.resolve_rank_block_policy(4, 8, 8, f32, (32, 4), None,
                                            CPU) == (32, 4)
    assert not timed and not autotune.cache_path().exists()
    with pytest.raises(ValueError, match="cluster size"):
        engine.resolve_logistic_block_policy(4, 8, 1024, f32, 2, None, CPU)
    assert engine.resolve_block_policy(4, 8, 1, f32, None, None,
                                       CPU) == ista_ops.GEMV_PLANS[-1]
    assert engine.resolve_logistic_block_policy(4, 8, 2048, f32, None, None,
                                                CPU) == 2
    assert len(json.loads(autotune.cache_path().read_text())) == 2


# ---- engine parity on the reference's data ------------------------------

@pytest.fixture(scope="module")
def reg():
    d = jsynth.gen_regression(jax.random.PRNGKey(11), m=3, n=40, p=24, s=3)
    Xs, ys = np.array(d.Xs), np.array(d.ys)
    S, c = jengine.sufficient_stats(d.Xs, d.ys)
    return Xs, ys, np.array(S), np.array(c)


@pytest.fixture(scope="module")
def cls():
    d = jsynth.gen_classification(jax.random.PRNGKey(12), m=2, n=24, p=2048,
                                  s=3)
    return np.array(d.Xs), np.array(d.ys)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.array(want), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("block", [None, *rank_ops.RANK_TILES])
def test_sufficient_stats_every_block(reg, block):
    Xs, ys, S, c = reg
    Sig, cs = engine.sufficient_stats(_t(Xs), _t(ys), block=block)
    base = engine.sufficient_stats(_t(Xs), _t(ys))
    assert torch.equal(Sig, base[0]) and torch.equal(cs, base[1])
    _close(Sig, S)
    _close(cs, c)


@pytest.mark.parametrize("block", [None, *ista_ops.GEMV_PLANS])
def test_solve_lasso_batched_r1_every_block(reg, block):
    _, _, S, c = reg
    got = engine.solve_lasso_batched(_t(S), _t(c), 0.05, iters=60,
                                     block=block)
    assert torch.equal(got, engine.solve_lasso_batched(_t(S), _t(c), 0.05,
                                                       iters=60))
    _close(got, jengine.solve_lasso_batched(S, c, 0.05, iters=60))


@pytest.mark.parametrize("block", [None, *ista_ops.GEMM_TILES])
def test_solve_lasso_batched_multi_rhs_every_block(reg, block):
    _, _, S, _ = reg
    eye = np.broadcast_to(np.eye(S.shape[-1], dtype=np.float32),
                          S.shape).copy()
    got = engine.solve_lasso_batched(_t(S), _t(eye), 0.02, iters=40,
                                     block=block)
    assert torch.equal(got, engine.solve_lasso_batched(_t(S), _t(eye), 0.02,
                                                       iters=40))
    _close(got, jengine.solve_lasso_batched(S, eye, 0.02, iters=40))


@pytest.mark.parametrize("block", [None, *ista_ops.GEMV_PLANS])
def test_solve_lasso_grid_every_block(reg, block):
    _, _, S, c = reg
    lams = np.array([0.2, 0.05, 0.0], np.float32)
    got = engine.solve_lasso_grid(_t(S), _t(c), _t(lams), iters=50,
                                  block=block)
    assert torch.equal(got, engine.solve_lasso_grid(_t(S), _t(c), _t(lams),
                                                    iters=50))
    _close(got, jengine.solve_lasso_grid(S, c, lams, iters=50))


@pytest.mark.parametrize("block", [None, 1, 2])
def test_solve_logistic_lasso_batched_every_block(cls, block):
    Xs, ys = cls
    got = engine.solve_logistic_lasso_batched(_t(Xs), _t(ys), 0.05,
                                              iters=30, block=block)
    assert torch.equal(got, engine.solve_logistic_lasso_batched(
        _t(Xs), _t(ys), 0.05, iters=30))
    _close(got, jengine.solve_logistic_lasso_batched(Xs, ys, 0.05,
                                                     iters=30))


# ---- the service's warm-up ------------------------------------------------

def test_service_warms_its_shapes_and_the_cpu_writes_no_cache(
        cache_dir, timed, monkeypatch):
    """The service asks `warmup_cache` for its (m, p) and chunk rows when
    it starts; on the CPU that times nothing, and a whole ingest and
    refit write no cache."""
    seen = []
    real = service_mod.warmup_cache
    monkeypatch.setattr(service_mod, "warmup_cache",
                        lambda *a, **kw: seen.append((a, kw)) or real(*a,
                                                                      **kw))
    svc = StreamingDsmlService(3, 16, lam=0.3, mu=0.2, Lam=0.5,
                               device="cpu", refit_every=32, guard=False,
                               lasso_iters=20, debias_iters=20, chunk_n=32)
    assert [a for a, _ in seen] == [(3, 16, 32)]
    assert seen[0][1]["device"] == CPU
    rng = np.random.default_rng(4)
    X = rng.standard_normal((3, 32, 16)).astype(np.float32)
    y = rng.standard_normal((3, 32)).astype(np.float32)
    assert svc.ingest(X, y) is not None          # a refit ran
    autotune.warmup_cache(3, 16, 32, device="cpu")
    assert not timed and not autotune.cache_path().exists()
    assert not any(_events(e) for e in ("miss_sweep", "hit_memory",
                                        "hit_disk"))
