"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`; every test skips (at run time, through the `cuda` fixture)
where no CUDA device is present. Run them on a machine with a card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerance: max abs error <= 1e-5 * max|plain| per output (both sides
accumulate in f32, in another order). The flash-attention kernel is held
against the plain version on the f32 upcast of its inputs, query row by
query row: each row's output within a relative l2 error of 1e-4 in f32
and 1e-2 in bf16 of the plain row (a row's scale falls as
1 / sqrt(row + 1), so a bar on max|plain|, set by row 0, would not follow
it), and in f32 also within 2e-5 * max|plain|. Among the flash shapes,
(1, 300, 4, 2, 64) has T = 300, not a multiple of the 128-key tile of the
bf16 kernel at H = 64, and a window of 40 that cuts its tiles; at
H = 256 (64-key tiles) recurrentgemma-9b's prefill (4, 2048, 16, 1) with
its window of 2048, a ragged non-causal S = 300 against T = 333, and a
window of 96 that cuts the tiles at a ragged S = 700; and the f32 copies'
instances (2, 2048, 32, 8, 64), (2, 2048, 16, 16, 128) and (1, 2048, 8, 1,
256) with window 2048, which in f32 run the 3xTF32 body.

The training forward's row log-sum-exp (`flash_attention_fwd_lse`) is
held elementwise to the plain version's on the f32 upcast: within
1e-5 · max(1, |lse|) in f32 and 1e-4 · max(1, |lse|) in bf16 (both sides
sum the same f32 scores and exponentials, in another order, the bf16
kernel through exp2), the rows that see no key at -1e30 on both; its
output has the bits of serving's call. The training attention's
gradients (kernel forward, plain backward) are held to the plain
forward's: 1e-4 · max|plain| in f32, 5e-2 · max|plain| in bf16, where the
plain forward rounds q·k to bf16 and the kernel keeps it in f32 (each
backward recomputes the scores as its forward did); a wrong lse or
scale moves them by O(1). In bf16 the kernel path's gradients are also
held to the f32 ones on the upcast inputs: closer than the backward that
rounds q·k to bf16 after the kernel's forward.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from repro_torch.core.dsml import dsml_fit
from repro_torch.core.engine import (
    power_iteration_batched, solve_lasso_eq2_grid, sufficient_stats,
)
from repro_torch.core.logistic import dsml_logistic_fit
from repro_torch.core.synth import gen_classification, gen_regression
from repro_torch.configs import get_config
from repro_torch.kernels.common import LAUNCHES
from repro_torch.kernels.flash_attention.ops import (
    flash_attention, flash_attention_fwd_lse,
)
from repro_torch.kernels.group_threshold.ops import (
    group_threshold, kernel_row_lanes, row_lanes,
)
from repro_torch.kernels.ista_step import ops as ista_ops
from repro_torch.kernels.ista_step.ops import (
    GEMV_PLANS, fista_step_batched, fista_step_grid, gemm_plan, gemv_plan,
    ista_solve, ista_step, ista_step_batched, kernel_gemm_plan,
    kernel_gemv_plan,
)
from repro_torch.kernels.logistic_grad.ops import (
    kernel_plan, kernel_unfused_plan, launch, launch_unfused, logistic_grad,
    logistic_grad_unfused, plan, ticket_counters, unfused_plan, vectorized,
)
from repro_torch.kernels.logistic_grad.ref import logistic_residual_ref
from repro_torch.kernels.rank_update.ops import (
    kernel_rank_plan, rank_plan, rank_update, rank_update_unfused,
)
from repro_torch.models import Batch, forward_decode, forward_prefill
from repro_torch.models import init_params
from repro_torch.models.attention_core import flash_attention_bwd
from repro_torch.models.layers import flash_attention_train

pytestmark = pytest.mark.gpu
TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _assert_close(got, want, tol=TOL):
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.shape == b.shape
        err = torch.max(torch.abs(a - b)).item()
        assert err <= tol * torch.max(torch.abs(b)).item(), err


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("m, n, p", [(4, 256, 256), (3, 100, 200),
                                     (2, 7, 129)])
def test_rank_update_kernel_matches_plain(cuda, m, n, p, weighted):
    g = torch.Generator(device=cuda).manual_seed(0)
    X = torch.randn((m, n, p), generator=g, device=cuda)
    y = torch.randn((m, n), generator=g, device=cuda)
    w = 0.5 + torch.rand((m, n), generator=g, device=cuda) if weighted \
        else None
    before = LAUNCHES["rank_update"]
    got = rank_update(X, y, w)
    assert LAUNCHES["rank_update"] == before + 1
    _assert_close(got, rank_update(X, y, w, use_kernel=False))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("m, n, p", [(16, 512, 1024), (8, 1024, 256),
                                     (3, 500, 1000), (2, 7, 129),
                                     (1, 7, 7), (3, 100, 130)])
def test_rank_update_kernel_on_every_tile(cuda, m, n, p, weighted):
    """The Sigma kernel at shapes that between them take every tile of
    `rank_plan` (the launcher's own choice is held to the Python rule),
    the 16-byte and the 4-byte copies, n not a multiple of the ring's 16
    samples: within the bar of the plain version, Sigma exactly
    symmetric, the same bits on a second launch, and the unfused pair's
    Sigma bitwise the fused kernel's."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = rank_plan(m, p, sms)
    assert kernel_rank_plan(m, p, cuda) == (plan.tile, plan.blocks, sms)
    g = torch.Generator(device=cuda).manual_seed(9)
    X = torch.randn((m, n, p), generator=g, device=cuda)
    y = torch.randn((m, n), generator=g, device=cuda)
    w = 0.5 + torch.rand((m, n), generator=g, device=cuda) if weighted \
        else None
    got, again = rank_update(X, y, w), rank_update(X, y, w)
    _assert_close(got, rank_update(X, y, w, use_kernel=False))
    assert torch.equal(got[0], got[0].mT)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(rank_update_unfused(X, y, w)[0], got[0])


@pytest.mark.parametrize("m, p, r", [(4, 256, 1), (4, 256, 256),
                                     (3, 200, 1), (3, 200, 200),
                                     (2, 130, 1), (2, 130, 5)])
def test_fista_step_kernel_matches_plain(cuda, m, p, r):
    g = torch.Generator(device=cuda).manual_seed(1)
    X = torch.randn((m, 2 * p, p), generator=g, device=cuda)
    Sig = torch.einsum("tni,tnj->tij", X, X) / (2 * p)
    etas = 1.0 / power_iteration_batched(Sig)
    z = 0.3 * torch.randn((m, p, r), generator=g, device=cuda)
    x = z + 0.1 * torch.randn((m, p, r), generator=g, device=cuda)
    c = 0.5 * torch.randn((m, p, r), generator=g, device=cuda)
    lams = torch.full((m,), 0.05, device=cuda)
    args = (Sig, z, x, c, etas, lams, np.float32(0.6))
    key = "fista_step_gemv" if r == 1 else "fista_step_gemm"
    before = LAUNCHES[key]
    got = fista_step_batched(*args)
    assert LAUNCHES[key] == before + 1
    assert got[0].data_ptr() not in (z.data_ptr(), x.data_ptr())
    _assert_close(got, fista_step_batched(*args, use_kernel=False))


@pytest.mark.parametrize("momentum", [True, False])
@pytest.mark.parametrize("m, p, r", [(1, 1024, 1024), (16, 1024, 1024),
                                     (3, 129, 7), (2, 1001, 1001),
                                     (32, 200, 200), (64, 197, 197),
                                     (3, 1000, 1000)])
def test_fista_gemm_kernel_matches_plain_on_every_tile(cuda, m, p, r,
                                                       momentum):
    """The r > 1 kernel at shapes that between them take every tile of
    `gemm_plan` (the launcher's own choice is held to the Python rule;
    the short-row tile at p = 200 and 197, not at p = 1000), the 16-byte
    and the 4-byte copies, with and without momentum; two launches give
    the same bits."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = gemm_plan(m, p, r, sms)
    assert kernel_gemm_plan(m, p, r, cuda) == (plan.bm, plan.bn, sms)
    g = torch.Generator(device=cuda).manual_seed(8)
    X = torch.randn((m, 2 * p, p), generator=g, device=cuda)
    Sig = torch.einsum("tni,tnj->tij", X, X) / (2 * p)
    etas = 1.0 / power_iteration_batched(Sig)
    z = 0.3 * torch.randn((m, p, r), generator=g, device=cuda)
    x = z + 0.1 * torch.randn((m, p, r), generator=g, device=cuda)
    c = 0.5 * torch.randn((m, p, r), generator=g, device=cuda)
    lams = torch.full((m,), 0.05, device=cuda)
    if momentum:
        args = (Sig, z, x, c, etas, lams, np.float32(0.6))
        key, fn = "fista_step_gemm", fista_step_batched
    else:
        args = (Sig, z, c, etas, lams)
        key, fn = "ista_step_batched_gemm", ista_step_batched
    before = LAUNCHES[key]
    got, again = fn(*args), fn(*args)
    assert LAUNCHES[key] == before + 2
    want = fn(*args, use_kernel=False)
    got, again, want = ((t,) if not momentum else t
                        for t in (got, again, want))
    _assert_close(got, want)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("momentum", [True, False])
@pytest.mark.parametrize("m, p", [(1024, 200), (64, 197)])
def test_short_row_tile_gives_the_bits_of_128x64(cuda, m, p, momentum):
    """At the fit cell's (1024, 200, 200), and at an odd p (the 4-byte
    copies), the rule takes the short-row tile, the launcher's plan is
    `gemm_plan`'s, and the debias step (c = I) has the bits of the forced
    128 x 64 tile, with and without momentum: every output is one FMA
    chain over k in order, whatever the tile."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = gemm_plan(m, p, p, sms)
    assert (plan.bm, plan.bn) not in ((128, 64), (64, 64))
    assert kernel_gemm_plan(m, p, p, cuda) == (plan.bm, plan.bn, sms)
    g = torch.Generator(device=cuda).manual_seed(35)
    X = torch.randn((m, 120, p), generator=g, device=cuda)
    Sig = torch.bmm(X.mT, X) / 120
    etas = 1.0 / power_iteration_batched(Sig)
    z = 0.05 * torch.randn((m, p, p), generator=g, device=cuda)
    x = z + 0.01 * torch.randn((m, p, p), generator=g, device=cuda)
    c = torch.eye(p, device=cuda).expand(m, p, p).contiguous()
    lams = torch.full((m,), 0.38, device=cuda)
    if momentum:
        args, fn = (Sig, z, x, c, etas, lams, np.float32(0.7)), \
            fista_step_batched
    else:
        args, fn = (Sig, z, c, etas, lams), ista_step_batched
    got, wide, want = (fn(*args), fn(*args, block=(128, 64)),
                       fn(*args, use_kernel=False))
    got, wide, want = ((t,) if not momentum else t
                       for t in (got, wide, want))
    assert all(torch.equal(a, b) for a, b in zip(got, wide))
    _assert_close(got, want)


def test_the_librarys_tile_table_is_gemm_tiles(cuda):
    """The SGEMM's tiles as the library holds them (PLAN_TILES: bm, bn,
    k per stage, stages) are GEMM_TILES, row for row: the rule in
    `gemm_plan`, the autotune's candidates and `block=` read that
    table."""
    assert ista_ops.kernel_gemm_tiles() == ista_ops.GEMM_TILES


def _gemv_inputs(device, m, p, seed=9):
    g = torch.Generator(device=device).manual_seed(seed)
    X = torch.randn((m, 2 * p, p), generator=g, device=device)
    Sig = torch.einsum("tni,tnj->tij", X, X) / (2 * p)
    etas = 1.0 / power_iteration_batched(Sig)
    z = 0.3 * torch.randn((m, p, 1), generator=g, device=device)
    x = z + 0.1 * torch.randn((m, p, 1), generator=g, device=device)
    c = 0.5 * torch.randn((m, p, 1), generator=g, device=device)
    lams = torch.full((m,), 0.05, device=device)
    return Sig, z, x, c, etas, lams


@pytest.mark.parametrize("momentum", [True, False])
@pytest.mark.parametrize("m, p", [(1, 1024), (1, 1023), (128, 1024)])
def test_fista_gemv_kernel_matches_plain_on_every_plan(cuda, m, p,
                                                       momentum):
    """The r == 1 kernel at one task (1 row a warp, 2 warps a block; the
    4-byte loads at p = 1023) and at 128 (4 rows a warp, 8 warps), with
    and without momentum; the launcher's plan is held to `gemv_plan`, and
    two launches give the same bits."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = gemv_plan(m, p, sms)
    assert kernel_gemv_plan(m, p, cuda) == (plan.rows_per_warp, plan.warps,
                                            sms)
    Sig, z, x, c, etas, lams = _gemv_inputs(cuda, m, p)
    if momentum:
        args = (Sig, z, x, c, etas, lams, np.float32(0.6))
        key, fn = "fista_step_gemv", fista_step_batched
    else:
        args = (Sig, z, c, etas, lams)
        key, fn = "ista_step_batched_gemv", ista_step_batched
    before = LAUNCHES[key]
    got, again = fn(*args), fn(*args)
    assert LAUNCHES[key] == before + 2
    want = fn(*args, use_kernel=False)
    got, again, want = ((t,) if not momentum else t
                        for t in (got, again, want))
    _assert_close(got, want)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("p", [1024, 1023])
def test_fista_gemv_gives_the_same_bits_under_every_plan(cuda, p):
    """A row is one warp's FMA chains in the same order whatever the plan:
    task 0 alone (m = 1, one row a warp) gives the bits of task 0 within
    16 tasks (four rows a warp)."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert gemv_plan(1, p, sms)[:2] != gemv_plan(16, p, sms)[:2]
    Sig, z, x, c, etas, lams = _gemv_inputs(cuda, 16, p, seed=10)
    theta = np.float32(0.6)
    many = fista_step_batched(Sig, z, x, c, etas, lams, theta)
    one = fista_step_batched(*(t[:1].contiguous()
                               for t in (Sig, z, x, c, etas, lams)), theta)
    assert all(torch.equal(a[:1], b) for a, b in zip(many, one))
    assert torch.equal(ista_step_batched(Sig, z, c, etas, lams)[:1],
                       ista_step(Sig[0], z[0], c[0], etas[0], lams[0])[None])


def test_dsml_fit_kernels_match_plain_path(cuda):
    d = gen_regression(0, m=4, n=100, p=120, s=6, signal_low=0.3,
                       device=cuda)
    lam, mu = 2 * np.sqrt(np.log(120) / 100), np.sqrt(np.log(120) / 100)
    before = dict(LAUNCHES)
    got = dsml_fit(d.Xs, d.ys, lam, mu, 0.5)
    assert LAUNCHES["rank_update"] == before["rank_update"] + 1
    assert LAUNCHES["fista_step_gemv"] == before["fista_step_gemv"] + 400
    assert LAUNCHES["fista_step_gemm"] == before["fista_step_gemm"] + 600
    want = dsml_fit(d.Xs, d.ys, lam, mu, 0.5, use_kernel=False)
    assert torch.equal(got.support, want.support)
    _assert_close((got.beta_u,), (want.beta_u,), tol=1e-4)


_LOGISTIC_SHAPES = [(4, 256, 256), (3, 100, 200), (2, 7, 129),
                    (16, 512, 1024), (4, 256, 8192)]


def _logistic_inputs(device, m, n, p):
    g = torch.Generator(device=device).manual_seed(2)
    X = torch.randn((m, n, p), generator=g, device=device)
    y = torch.where(torch.rand((m, n), generator=g, device=device) < 0.5,
                    1.0, -1.0)
    B = torch.randn((m, p), generator=g, device=device) / np.sqrt(p)
    return X, y, B


# the fused kernel also at m = 1, at a p that its cluster does not divide
# (8196: slices of 257 vectors, the last 250), and in each mode above
# p = 19,328: the ring (scalar at 19,329, float4 at 40,000) and X read
# twice (100,003 and 100,000)
_FUSED_SHAPES = _LOGISTIC_SHAPES + [(1, 256, 8192), (4, 64, 8196),
                                    (4, 256, 19329), (2, 16, 40000),
                                    (1, 8, 100003), (1, 8, 100000)]


@pytest.mark.parametrize("m, n, p", _FUSED_SHAPES)
def test_logistic_grad_kernel_matches_plain(cuda, m, n, p):
    X, y, B = _logistic_inputs(cuda, m, n, p)
    before = LAUNCHES["logistic_grad"]
    got = logistic_grad(X, y, B)
    assert LAUNCHES["logistic_grad"] == before + 1
    _assert_close((got,), (logistic_grad(X, y, B, use_kernel=False),))
    # the sample reduction runs in a fixed order: the same bits every run
    assert torch.equal(got, logistic_grad(X, y, B))


@pytest.mark.parametrize("m, n, p", _FUSED_SHAPES)
def test_logistic_grad_plan_is_the_launchers(cuda, m, n, p):
    """`plan` is what the launcher chooses and launches (a cluster launch
    wherever the plan's cluster is above 1)."""
    X, y, B = _logistic_inputs(cuda, m, n, p)
    vec = vectorized(X, B)
    props = torch.cuda.get_device_properties(cuda)
    want = plan(m, n, p, props.multi_processor_count,
                props.shared_memory_per_block_optin, vec=vec)
    assert kernel_plan(m, n, p, vec, cuda) == (
        want, props.multi_processor_count)
    G = torch.empty((m, p), device=cuda)
    work = torch.empty((m, want.chunks, p), device=cuda)
    ran = launch(X, y, B, G, work, ticket_counters(cuda, m * want.cluster))
    assert ran == want
    _assert_close((G,), (logistic_grad(X, y, B, use_kernel=False),))


def test_logistic_grad_refuses_short_scratch(cuda):
    """A workspace or counter buffer smaller than the plan needs is
    refused at launch, not written past."""
    X, y, B = _logistic_inputs(cuda, 4, 256, 8192)
    pl = plan(4, 256, 8192,
              torch.cuda.get_device_properties(cuda).multi_processor_count,
              torch.cuda.get_device_properties(
                  cuda).shared_memory_per_block_optin)
    G = torch.empty((4, 8192), device=cuda)
    short = torch.empty((4, pl.chunks - 1, 8192), device=cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        launch(X, y, B, G, short, ticket_counters(cuda, 4 * pl.cluster))
    work = torch.empty((4, pl.chunks, 8192), device=cuda)
    few = torch.zeros(4 * pl.cluster - 1, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        launch(X, y, B, G, work, few)


def test_logistic_grad_leaves_its_counters_at_zero(cuda):
    """Calls in a row, at shapes with and without clusters, share the
    device's counters and leave them at zero."""
    for m, n, p in ((4, 256, 8192), (16, 512, 1024), (2, 7, 129)):
        X, y, B = _logistic_inputs(cuda, m, n, p)
        first = logistic_grad(X, y, B)
        for _ in range(3):
            assert torch.equal(logistic_grad(X, y, B), first)
    torch.cuda.synchronize()
    held = ticket_counters(cuda, 1)
    assert held.numel() >= 4 * 8 and int(held.abs().sum()) == 0


def test_logistic_grad_call_is_one_kernel(cuda):
    """A gradient call issues the fused kernel and nothing else: no fill
    of its counters, no scale after it (the solver skips `* 1.0`)."""
    from torch.profiler import ProfilerActivity, profile
    X, y, B = _logistic_inputs(cuda, 16, 512, 1024)
    logistic_grad(X, y, B)
    torch.cuda.synchronize()
    before = LAUNCHES["logistic_grad"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        logistic_grad(X, y, B)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert LAUNCHES["logistic_grad"] == before + 1
    assert len(kernels) == 1 and "logistic_grad_kernel" in kernels[0], \
        kernels


@pytest.mark.parametrize("m, n, p", _LOGISTIC_SHAPES)
def test_logistic_unfused_kernels_match_plain(cuda, m, n, p):
    X, y, B = _logistic_inputs(cuda, m, n, p)
    before = dict(LAUNCHES)
    got = logistic_grad_unfused(X, y, B)
    assert LAUNCHES["logistic_z"] == before["logistic_z"] + 1
    assert LAUNCHES["logistic_backproject"] == \
        before["logistic_backproject"] + 1
    _assert_close((got,), (logistic_grad_unfused(X, y, B, use_kernel=False),))
    # both reductions run in a fixed order: the same bits every run
    assert torch.equal(got, logistic_grad_unfused(X, y, B))


@pytest.mark.parametrize("m, n, p", _LOGISTIC_SHAPES)
def test_logistic_unfused_plan_and_residual_match(cuda, m, n, p):
    """The launchers' plan is `unfused_plan`'s, and the vector the first
    kernel leaves between the two is the plain residual."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = unfused_plan(m, n, p, sms)
    assert kernel_unfused_plan(m, n, p, cuda) == (
        plan.rows_per_warp, plan.warps_per_row, plan.cols, sms)
    X, y, B = _logistic_inputs(cuda, m, n, p)
    r = torch.empty((m, n), device=cuda)
    G = torch.empty((m, p), device=cuda)
    launch_unfused(X, y, B, r, G)
    _assert_close((r,), (logistic_residual_ref(X, y, B),))


def test_dsml_logistic_fit_kernels_match_plain_path(cuda):
    d = gen_classification(0, m=4, n=150, p=120, s=6, device=cuda)
    lam = float(np.sqrt(np.log(120) / 150))
    before = dict(LAUNCHES)
    got = dsml_logistic_fit(d.Xs, d.ys, lam, 2 * lam, 0.5)
    assert LAUNCHES["rank_update"] == before["rank_update"] + 2
    assert LAUNCHES["logistic_grad"] == before["logistic_grad"] + 600
    assert LAUNCHES["fista_step_gemm"] == before["fista_step_gemm"] + 600
    want = dsml_logistic_fit(d.Xs, d.ys, lam, 2 * lam, 0.5,
                             use_kernel=False)
    assert torch.equal(got.support, want.support)
    _assert_close((got.beta_u, got.beta_local),
                  (want.beta_u, want.beta_local), tol=1e-4)


def _ista_inputs(device, m, p, r):
    g = torch.Generator(device=device).manual_seed(3)
    X = torch.randn((m, 2 * p, p), generator=g, device=device)
    Sig = torch.einsum("tni,tnj->tij", X, X) / (2 * p)
    etas = 1.0 / power_iteration_batched(Sig)
    b = 0.3 * torch.randn((m, p, r), generator=g, device=device)
    c = 0.5 * torch.randn((m, p, r), generator=g, device=device)
    lams = 0.02 + 0.05 * torch.rand((m,), generator=g, device=device)
    return Sig, b, c, etas, lams


_ISTA_SHAPES = [(4, 256, 1), (4, 256, 256), (3, 129, 1), (3, 129, 7),
                (2, 130, 5)]


@pytest.mark.parametrize("m, p, r", _ISTA_SHAPES)
def test_ista_step_batched_kernel_matches_plain(cuda, m, p, r):
    args = _ista_inputs(cuda, m, p, r)
    key = "ista_step_batched_" + ("gemv" if r == 1 else "gemm")
    before = LAUNCHES[key]
    got = ista_step_batched(*args)
    assert LAUNCHES[key] == before + 1
    assert got.data_ptr() != args[1].data_ptr()
    _assert_close((got,), (ista_step_batched(*args, use_kernel=False),))
    assert torch.equal(got, ista_step_batched(*args))
    # the squeezed single-RHS form and a scalar lam
    if r == 1:
        sq = ista_step_batched(args[0], args[1][..., 0], args[2][..., 0],
                               args[3], 0.05)
        _assert_close((sq,), (ista_step_batched(
            args[0], args[1][..., 0], args[2][..., 0], args[3], 0.05,
            use_kernel=False),))


@pytest.mark.parametrize("m, p, r", _ISTA_SHAPES)
def test_ista_step_kernel_matches_plain(cuda, m, p, r):
    Sig, b, c, etas, lams = _ista_inputs(cuda, m, p, r)
    args = (Sig[0], b[0], c[0], etas[0], lams[0])
    key = "ista_step_" + ("gemv" if r == 1 else "gemm")
    before = LAUNCHES[key]
    got = ista_step(*args)
    assert LAUNCHES[key] == before + 1
    _assert_close((got,), (ista_step(*args, use_kernel=False),))
    assert torch.equal(got, ista_step(*args))


@pytest.mark.parametrize("p, r", [(256, 1), (129, 7)])
def test_ista_solve_kernel_matches_plain(cuda, p, r):
    Sig, _, c, _, _ = _ista_inputs(cuda, 1, p, r)
    key = "ista_step_" + ("gemv" if r == 1 else "gemm")
    before = LAUNCHES[key]
    got = ista_solve(Sig[0], c[0], 0.05, iters=200)
    assert LAUNCHES[key] == before + 200
    want = ista_solve(Sig[0], c[0], 0.05, iters=200, use_kernel=False)
    _assert_close((got,), (want,), tol=1e-4)
    assert torch.equal(got != 0, want != 0)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("m, n, p", [(4, 256, 256), (2, 7, 129),
                                     (3, 100, 201)])
def test_rank_update_unfused_kernels_match_plain(cuda, m, n, p, weighted):
    g = torch.Generator(device=cuda).manual_seed(4)
    X = torch.randn((m, n, p), generator=g, device=cuda)
    y = torch.randn((m, n), generator=g, device=cuda)
    w = 0.5 + torch.rand((m, n), generator=g, device=cuda) if weighted \
        else None
    before = dict(LAUNCHES)
    got = rank_update_unfused(X, y, w)
    assert LAUNCHES["rank_update_sigma"] == before["rank_update_sigma"] + 1
    assert LAUNCHES["rank_update_c"] == before["rank_update_c"] + 1
    _assert_close(got, rank_update(X, y, w, use_kernel=False))
    again = rank_update_unfused(X, y, w)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p, m", [(1024, 16), (1001, 5), (64, 40)])
def test_group_threshold_kernel_matches_plain(cuda, p, m, dtype):
    g = torch.Generator(device=cuda).manual_seed(5)
    B = (torch.randn((p, m), generator=g, device=cuda)
         * (0.1 + 2 * torch.rand((p, 1), generator=g, device=cuda))
         / np.sqrt(m)).to(dtype)
    before = LAUNCHES["group_threshold"]
    out, keep = group_threshold(B, 0.8)
    assert LAUNCHES["group_threshold"] == before + 1
    out_p, keep_p = group_threshold(B, 0.8, use_kernel=False)
    torch.cuda.synchronize()
    assert keep.dtype == torch.bool and out.dtype == dtype
    assert torch.equal(keep, keep_p) and torch.equal(out, out_p)
    assert 0 < int(keep.sum()) < p
    # a strided B is taken too (the master step passes beta_u.T)
    out_t, keep_t = group_threshold(B.T.contiguous().T, 0.8)
    assert torch.equal(keep_t, keep) and torch.equal(out_t, out)
    # an unaligned B takes single-element lanes: the same result
    Bu = torch.empty(p * m + 1, dtype=dtype, device=cuda)[1:].view(p, m)
    Bu.copy_(B)
    out_u, keep_u = group_threshold(Bu, 0.8)
    assert torch.equal(keep_u, keep) and torch.equal(out_u, out)


def test_group_threshold_lanes_are_the_launchers(cuda):
    assert all(kernel_row_lanes(v) == row_lanes(v) for v in range(1, 70))


def test_grid_solve_kernels_match_plain_path(cuda):
    d = gen_regression(0, m=4, n=100, p=120, s=6, signal_low=0.3,
                       device=cuda)
    S, c = sufficient_stats(d.Xs, d.ys)
    lam_max = 2.0 * torch.max(torch.abs(c)).item()
    lams = torch.tensor(lam_max * np.geomspace(1.0, 0.01, 5),
                        dtype=torch.float32, device=cuda)
    before = LAUNCHES["fista_step_gemv"]
    got = solve_lasso_eq2_grid(S, c, lams, iters=200)
    assert LAUNCHES["fista_step_gemv"] == before + 200
    want = solve_lasso_eq2_grid(S, c, lams, iters=200, use_kernel=False)
    assert got.shape == (5, 4, 120)
    _assert_close((got,), (want,), tol=1e-4)


def _grid_step_inputs(device, m, p, k):
    g = torch.Generator(device=device).manual_seed(13)
    X = torch.randn((m, 2 * p, p), generator=g, device=device)
    Sig = torch.einsum("tni,tnj->tij", X, X) / (2 * p)
    etas = 1.0 / power_iteration_batched(Sig)
    z = 0.3 * torch.randn((k, m, p), generator=g, device=device)
    x = z + 0.1 * torch.randn((k, m, p), generator=g, device=device)
    c = 0.5 * torch.randn((m, p), generator=g, device=device)
    lams = 0.01 + 0.1 * torch.rand((k,), generator=g, device=device)
    return Sig, z, x, c, etas, lams


@pytest.mark.parametrize("theta", [0.6, 0.0])
@pytest.mark.parametrize("m, p, k", [(4, 120, 5), (1024, 200, 8),
                                     (16, 1024, 8), (3, 201, 11),
                                     (2, 200, 1)])
def test_fista_step_grid_is_the_tiled_launch(cuda, m, p, k, theta):
    """The lambda grid's step (Sigma read once for up to 8 lambdas; the
    4-byte body at p = 201; two passes at k = 11; at k = 1 the r == 1
    launch itself, which the grid's launcher refuses), with momentum and
    without (theta 0, the residual's step), gives under every plan the
    bits of the r == 1 kernel launched on Sigma, c and eta tiled k times
    and each lambda repeated over the tasks; one launch a step."""
    Sig, z, x, c, etas, lams = _grid_step_inputs(cuda, m, p, k)
    tiled = (Sig.repeat(k, 1, 1), z.reshape(k * m, p, 1),
             x.reshape(k * m, p, 1), c.repeat(k, 1)[..., None],
             etas.repeat(k), lams.repeat_interleave(m))
    want = (torch.empty_like(tiled[1]), torch.empty_like(tiled[1]))
    ista_ops.launch(*tiled, np.float32(theta), *want)
    want = tuple(w.reshape(k, m, p) for w in want)
    for block in (None, *GEMV_PLANS):
        before = LAUNCHES["fista_step_gemv"]
        got = fista_step_grid(Sig, z, x, c, etas, lams, np.float32(theta),
                              block=block)
        assert LAUNCHES["fista_step_gemv"] == before + 1
        assert all(torch.equal(a, w) for a, w in zip(got, want)), block
    _assert_close(got, fista_step_grid(Sig, z, x, c, etas, lams,
                                       np.float32(theta), use_kernel=False))
    if k == 1:
        with pytest.raises(RuntimeError, match="CUDA error"):
            ista_ops.launch_grid(Sig, z, x, c, etas, lams, np.float32(theta),
                                 torch.empty_like(z), torch.empty_like(z))


@pytest.mark.parametrize("k", [8, 11])
def test_grid_solve_is_the_tiled_solve(cuda, k):
    """A whole `solve_lasso_eq2_grid` gives the bits of the k m problems
    solved as r == 1 problems on Sigma, c and the step sizes tiled k
    times, with one launch of #1a a step; `engine.grid.shared` records
    the solve on the kernel with the passes a step makes over Sigma."""
    from repro_torch import obs
    from repro_torch.core.engine import solve_lasso_batched
    from repro_torch.core.solvers import lasso_stats_step_scale
    d = gen_regression(1, m=16, n=200, p=256, s=8, signal_low=0.3,
                       device=cuda)
    S, c = sufficient_stats(d.Xs, d.ys)
    lam_max = 2.0 * torch.max(torch.abs(c)).item()
    lams = torch.tensor(lam_max * np.geomspace(1.0, 0.01, k),
                        dtype=torch.float32, device=cuda)
    etas = lasso_stats_step_scale(S)
    assert torch.equal(etas, lasso_stats_step_scale(S))
    obs.reset()
    before = LAUNCHES["fista_step_gemv"]
    got = solve_lasso_eq2_grid(S, c, lams, iters=200)
    assert LAUNCHES["fista_step_gemv"] == before + 200
    shared = [(x["labels"], x["value"])
              for x in obs.get_registry().snapshot()["counters"]
              if x["name"] == "engine.grid.shared"]
    assert shared == [({"lams": k, "passes": -(-k // 8),
                        "outcome": "kernel"}, 1)]
    m, p = c.shape
    want = solve_lasso_batched(S.repeat(k, 1, 1), c.repeat(k, 1),
                               (0.5 * lams).repeat_interleave(m), iters=200,
                               etas=etas.repeat(k))
    assert torch.equal(got, want.reshape(k, m, p))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b, s, t, n, k, h, causal, window", [
    (2, 256, 256, 8, 2, 64, True, 0), (1, 200, 200, 4, 1, 128, True, 0),
    (1, 512, 512, 4, 1, 256, True, 64), (2, 256, 256, 8, 2, 64, False, 0),
    (1, 64, 200, 4, 2, 64, True, 0), (1, 200, 333, 4, 1, 128, False, 16),
    (4, 2048, 2048, 32, 8, 64, True, 0), (1, 300, 300, 4, 2, 64, True, 40),
    (4, 2048, 2048, 16, 1, 256, True, 2048), (1, 300, 333, 4, 1, 256, False, 0),
    (1, 700, 700, 4, 2, 256, True, 96),
    # the f32 copies' instances (chip_smoke.py f32_flash_shapes): phase 6's
    # granite-3-2b, 9a's deepseek-moe-16b, a 13c-rg rank's recurrentgemma-9b
    (2, 2048, 2048, 32, 8, 64, True, 0), (2, 2048, 2048, 16, 16, 128, True, 0),
    (1, 2048, 2048, 8, 1, 256, True, 2048)])
def test_flash_attention_kernel_matches_plain(cuda, dtype, b, s, t, n, k, h,
                                              causal, window):
    g = torch.Generator(device=cuda).manual_seed(6)
    q = torch.randn((b, s, n, h), generator=g, device=cuda).to(dtype)
    kk = torch.randn((b, t, k, h), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, t, k, h), generator=g, device=cuda).to(dtype)
    before = LAUNCHES["flash_attention"]
    got = flash_attention(q, kk, v, causal=causal, window=window)
    again = flash_attention(q, kk, v, causal=causal, window=window)
    assert LAUNCHES["flash_attention"] == before + 2
    want = flash_attention(q.float(), kk.float(), v.float(), causal=causal,
                           window=window, use_kernel=False)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, again)
    row_err = (torch.linalg.vector_norm(got.float() - want, dim=-1)
               / torch.clamp_min(torch.linalg.vector_norm(want, dim=-1),
                                 1e-30)).max().item()
    assert row_err <= (1e-4 if dtype == torch.float32 else 1e-2), row_err
    if dtype == torch.float32:
        _assert_close((got.float(),), (want,), tol=2e-5)


def test_flash_attention_kernel_reads_strided_operands(cuda):
    """q and k as views with head-major storage: read through their
    strides, the same bits as contiguous copies."""
    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn((2, 8, 300, 64), generator=g, device=cuda).transpose(1, 2)
    kk = torch.randn((2, 2, 300, 64), generator=g, device=cuda).transpose(1, 2)
    v = torch.randn((2, 300, 2, 64), generator=g, device=cuda)
    got = flash_attention(q, kk, v)
    assert torch.equal(got, flash_attention(q.contiguous(), kk.contiguous(),
                                            v))


def test_flash_attention_launches_once_per_layer_of_prefill(cuda):
    """A 4-layer granite at full width: one prefill of S = 2048 launches
    the kernel once per layer; decode launches none."""
    cfg = get_config("granite-3-2b").replace(n_layers=4)
    params = init_params(torch.Generator(device=cuda).manual_seed(0), cfg)
    gen = torch.Generator(device=cuda).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (1, 2049), device=cuda,
                           generator=gen)
    before = LAUNCHES["flash_attention"]
    logits, caches = forward_prefill(params, cfg,
                                     Batch(tokens=tokens[:, :2048]),
                                     cache_len=2049)
    assert LAUNCHES["flash_attention"] == before + cfg.n_layers
    plain, _ = forward_prefill(params, cfg, Batch(tokens=tokens[:, :2048]),
                               use_kernel=False)
    assert LAUNCHES["flash_attention"] == before + cfg.n_layers
    d_logits, _ = forward_decode(params, cfg, tokens[:, 2048:], 2048, caches)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == before + cfg.n_layers
    assert bool(torch.isfinite(d_logits[..., :cfg.vocab]).all())
    err = (logits.float() - plain.float()).abs().max().item()
    assert err <= 0.1 * plain.float().abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b, s, t, n, k, h, causal, window", [
    (2, 256, 256, 8, 2, 64, True, 0), (1, 200, 200, 4, 1, 128, True, 0),
    (1, 512, 512, 4, 1, 256, True, 64), (1, 200, 333, 4, 1, 128, False, 16),
    (4, 2048, 2048, 32, 8, 64, True, 0), (1, 300, 300, 4, 2, 64, True, 40),
    (1, 300, 333, 4, 1, 256, False, 0), (1, 300, 100, 4, 2, 64, False, 50),
    # recurrentgemma-9b's local attention on a rank of a model axis of 2
    # (chip_smoke phase 12c): 8 q heads, its one kv head, window 2048
    (2, 2048, 2048, 8, 1, 256, True, 2048),
    # the f32 copies' other instances (chip_smoke.py f32_flash_shapes)
    (2, 2048, 2048, 32, 8, 64, True, 0), (2, 2048, 2048, 16, 16, 128, True, 0),
    (1, 2048, 2048, 8, 1, 256, True, 2048)])
def test_flash_attention_lse_matches_plain(cuda, dtype, b, s, t, n, k, h,
                                           causal, window):
    """The kernel's lse (B, N, S) against the plain version's, twice for
    the same bits, its output the serving call's bits; (1, 300, 100)
    non-causal with window 50 leaves rows s >= 149 without a key."""
    g = torch.Generator(device=cuda).manual_seed(8)
    q = torch.randn((b, s, n, h), generator=g, device=cuda).to(dtype)
    kk = torch.randn((b, t, k, h), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, t, k, h), generator=g, device=cuda).to(dtype)
    before = LAUNCHES["flash_attention"]
    out, lse = flash_attention_fwd_lse(q, kk, v, causal=causal,
                                       window=window)
    out2, lse2 = flash_attention_fwd_lse(q, kk, v, causal=causal,
                                         window=window)
    serve = flash_attention(q, kk, v, causal=causal, window=window)
    assert LAUNCHES["flash_attention"] == before + 3
    want_out, want = flash_attention_fwd_lse(
        q.float(), kk.float(), v.float(), causal=causal, window=window,
        use_kernel=False)
    torch.cuda.synchronize()
    assert lse.shape == (b, n, s) and lse.dtype == torch.float32
    assert torch.equal(lse, lse2) and torch.equal(out, out2)
    assert torch.equal(out, serve)
    tol = 1e-5 if dtype == torch.float32 else 1e-4
    err = (torch.abs(lse - want) / torch.clamp_min(torch.abs(want), 1.0))
    assert err.max().item() <= tol, err.max().item()
    empty = want <= -1e29
    if causal or not window or s <= t + window - 1:
        assert not bool(empty.any())
    else:
        assert bool(empty.any()) and bool((lse[empty] == -1e30).all())
    row_err = (torch.linalg.vector_norm(out.float() - want_out, dim=-1)
               / torch.clamp_min(torch.linalg.vector_norm(want_out, dim=-1),
                                 1e-30)).max().item()
    assert row_err <= (1e-4 if dtype == torch.float32 else 1e-2), row_err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal, window", [(True, 0), (True, 300),
                                            (False, 0)])
def test_flash_attention_train_grads_kernel_matches_plain(cuda, dtype,
                                                          causal, window):
    """`flash_attention_train` (the model's long branch): the kernel's
    forward with its lse, one launch, against the plain forward, both with
    the plain blockwise backward (scores in f32 after the kernel, rounded
    as the plain forward rounds them after it), at (2, 2048, 8, 2, 64)."""
    g = torch.Generator(device=cuda).manual_seed(9)
    shapes = ((2, 2048, 8, 64), (2, 2048, 2, 64), (2, 2048, 2, 64))
    qkv = [torch.randn(sh, generator=g, device=cuda).to(dtype)
           for sh in shapes]
    dout = torch.randn(shapes[0], generator=g, device=cuda).to(dtype)
    grads = []
    for use_kernel in (None, False):
        ts = [t.clone().requires_grad_() for t in qkv]
        before = LAUNCHES["flash_attention"]
        out = flash_attention_train(*ts, causal=causal, window=window,
                                    use_kernel=use_kernel)
        out.backward(dout)
        torch.cuda.synchronize()
        assert LAUNCHES["flash_attention"] == before + (use_kernel is None)
        grads.append([out.detach()] + [t.grad for t in ts])
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    for name, got, want in zip(("out", "dq", "dk", "dv"), *grads):
        assert got.dtype == dtype and bool(torch.isfinite(got).all())
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        assert err <= tol * scale, (name, err, scale)


@pytest.mark.parametrize("causal, window", [(True, 0), (True, 300)])
def test_flash_attention_train_backward_follows_the_kernels_scores(
        cuda, causal, window):
    """bf16 at (2, 2048, 8, 2, 64): `flash_attention_train`'s gradients
    through the kernel, whose backward recomputes q·k in f32 as the kernel
    kept it, against the f32 gradients on the upcast inputs: each of dq,
    dk, dv within 0.85 of the relative l2 error of the same backward with
    q·k rounded to bf16 after the kernel's forward (the CPU twin in
    tests/test_torch_train.py reads 0.58-0.73 of it)."""
    g = torch.Generator(device=cuda).manual_seed(10)
    shapes = ((2, 2048, 8, 64), (2, 2048, 2, 64), (2, 2048, 2, 64))
    qkv = [torch.randn(sh, generator=g, device=cuda).bfloat16()
           for sh in shapes]
    dout = torch.randn(shapes[0], generator=g, device=cuda).bfloat16()
    kw = dict(causal=causal, window=window)
    ts = [t.clone().requires_grad_() for t in qkv]
    flash_attention_train(*ts, **kw).backward(dout)
    up = [t.float() for t in qkv]
    want = flash_attention_bwd(
        *up, *flash_attention_fwd_lse(*up, **kw, use_kernel=False),
        dout.float(), **kw, scores_f32=False)
    rounded = flash_attention_bwd(*qkv, *flash_attention_fwd_lse(*qkv, **kw),
                                  dout, **kw, scores_f32=False)

    def rel(a, w):
        return (torch.linalg.vector_norm(a.float() - w)
                / torch.linalg.vector_norm(w)).item()

    for name, t, r, w in zip(("dq", "dk", "dv"), ts, rounded, want):
        assert rel(t.grad, w) < 0.85 * rel(r, w), \
            (name, rel(t.grad, w), rel(r, w))


# ---- the streaming service (repro_torch.stream) on the card ----------------

def _stream_chunks(cuda, m, n, p, k, seed=3):
    from repro_torch.testing import make_clean_batch
    rng = np.random.default_rng(seed)
    return [make_clean_batch(rng, m, n, p, device=cuda) for _ in range(k)]


def test_stream_service_kernel_path_matches_plain(cuda):
    """A guarded service on the card, default (kernels) against
    `use_kernel=False` (the plain versions, on the card): one
    `rank_update` launch a chunk and none on the plain path; the same
    generations, cadence and supports; beta_tilde within 1e-4 · max|.|;
    refits launch the GEMV, the SGEMM and the health check's ISTA
    step."""
    from repro_torch.stream import StreamingDsmlService
    kw = dict(lam=0.3, mu=0.15, Lam=0.5, refit_every=256, device=cuda)
    svc = StreamingDsmlService(4, 256, **kw)
    ref = StreamingDsmlService(4, 256, use_kernel=False, **kw)
    for X, y in _stream_chunks(cuda, 4, 128, 256, 8):
        before = dict(LAUNCHES)
        got = svc.ingest(X, y)
        assert LAUNCHES["rank_update"] == before["rank_update"] + 1
        if got is not None:
            for key in ("fista_step_gemv", "fista_step_gemm",
                        "ista_step_batched_gemv"):
                assert LAUNCHES[key] > before[key], key
        before = dict(LAUNCHES)
        want = ref.ingest(X, y)
        assert dict(LAUNCHES) == before         # the plain path launches none
        assert (got is None) == (want is None)
        assert (svc.generation, svc._interval) == (ref.generation,
                                                   ref._interval)
        assert torch.equal(svc.state.support, ref.state.support)
        _assert_close((svc.state.beta_tilde,), (ref.state.beta_tilde,),
                      tol=1e-4)
    assert svc.generation >= 2
    assert svc.state.generation.device.type == "cpu"


def test_stream_guard_rejects_a_poisoned_chunk_bitwise_on_card(cuda):
    from repro_torch.stream import IngestGuard, StreamingDsmlService
    from repro_torch.testing import apply_batch_fault
    svc = StreamingDsmlService(2, 64, lam=0.3, mu=0.15, Lam=0.5,
                               refit_every=10**9, device=cuda,
                               guard=IngestGuard(warmup_chunks=1))
    chunks = _stream_chunks(cuda, 2, 64, 64, 4, seed=5)
    for X, y in chunks[:3]:
        svc.ingest(X, y)
    before = [t.clone() for t in (svc.state.Sigmas, svc.state.cs,
                                  svc.state.counts)]
    for kind in ("nan", "inf", "outlier"):
        X, y = apply_batch_fault(*chunks[3], kind,
                                 np.random.default_rng(0))
        assert svc.ingest(X, y) is None
        assert all(torch.equal(b, a) for b, a in zip(
            before, (svc.state.Sigmas, svc.state.cs, svc.state.counts)))
    assert [r.reason for r in svc.guard.ledger] == \
        ["nonfinite", "nonfinite", "outlier"]


def test_stream_refit_logistic_kernel_path_matches_plain(cuda):
    from repro_torch.stream import init_stream_state, refit_logistic
    data = gen_classification(torch.Generator(device=cuda).manual_seed(2),
                              m=4, n=256, p=128, s=4, device=cuda)
    lam = float(np.sqrt(np.log(128) / 256))
    st = ref = init_stream_state(4, 128, device=cuda)
    for _ in range(2):                          # cold, then warm
        before = dict(LAUNCHES)
        st, _ = refit_logistic(st, data.Xs, data.ys, lam, 2 * lam, 0.5)
        assert LAUNCHES["logistic_grad"] > before["logistic_grad"]
        assert LAUNCHES["rank_update"] == before["rank_update"] + 2
        ref, _ = refit_logistic(ref, data.Xs, data.ys, lam, 2 * lam, 0.5,
                                use_kernel=False)
        _assert_close((st.beta_u,), (ref.beta_u,), tol=1e-4)
        assert torch.equal(st.support, ref.support)


def test_stream_checkpoint_restores_on_card(cuda, tmp_path):
    from repro_torch.stream import StreamingDsmlService
    kw = dict(lam=0.3, mu=0.15, Lam=0.5, refit_every=128, device=cuda,
              ckpt_dir=str(tmp_path))
    svc = StreamingDsmlService(2, 64, **kw)
    for X, y in _stream_chunks(cuda, 2, 128, 64, 2, seed=6):
        svc.ingest(X, y)
    fresh = StreamingDsmlService(2, 64, **kw)
    assert fresh.restore() == svc.generation == 2
    for a, b in zip(fresh.state, svc.state):
        assert a.device == b.device and torch.equal(a, b)


def test_stream_serving_front_on_card(cuda):
    """The front pads into pinned host memory and scores on the card:
    every result equals the service's own predict on the same row."""
    from repro_torch.stream import ServingFront, StreamingDsmlService
    svc = StreamingDsmlService(4, 64, lam=0.3, mu=0.15, Lam=0.5,
                               refit_every=128, device=cuda)
    for X, y in _stream_chunks(cuda, 4, 128, 64, 2, seed=7):
        svc.ingest(X, y)
    rows = np.random.default_rng(8).standard_normal((20, 64)).astype(
        np.float32)
    with ServingFront(svc, max_batch=8, max_delay_ms=1.0) as front:
        res = [f.result(timeout=30) for f in [front.submit(r) for r in rows]]
    want = svc.predict(rows).cpu().numpy()
    for i, r in enumerate(res):
        assert r.generation == svc.generation
        np.testing.assert_allclose(r.scores[:, 0], want[:, i], rtol=0,
                                   atol=1e-5 * np.abs(want).max())


# ---- the distributed path (repro_torch.substrate) on the card --------------

_SHARDED_ON_CARD = r"""
import json
import torch
from repro_torch.core import dsml_fit_sharded, gen_regression
from repro_torch.substrate import init_from_env, task_mesh
from repro_torch.testing import count_collectives

dev = torch.device("cuda")
rank, world = init_from_env(device=dev)
data = gen_regression(torch.Generator(device=dev).manual_seed(0), m=8,
                      n=128, p=256, s=8, device=dev)
ml = 8 // world
rows = slice(rank * ml, (rank + 1) * ml)
with count_collectives() as calls:
    res = dsml_fit_sharded(data.Xs[rows].contiguous(),
                           data.ys[rows].contiguous(), 0.3, 0.15, 0.5,
                           task_mesh(), lasso_iters=100, debias_iters=100)
torch.save({k: v.cpu() for k, v in res._asdict().items()},
           "@OUT@" + f"/rank{rank}.pt")
print("RESULT " + json.dumps(dict(calls)))
"""


def _sharded_on_card(cuda, tmp_path, world, backend):
    """(each rank's result, its collective counts, dsml_fit's result on
    the same data in this process)."""
    from repro_torch.substrate import run_probe
    run = run_probe(_SHARDED_ON_CARD.replace("@OUT@", str(tmp_path)),
                    world=world, backend=backend, timeout=300,
                    pg_timeout=120)
    assert run.ok, run.report()
    calls = [json.loads([s for s in r.stdout.splitlines()
                         if s.startswith("RESULT ")][0][7:])
             for r in run.ranks]
    got = [torch.load(tmp_path / f"rank{i}.pt") for i in range(world)]
    data = gen_regression(torch.Generator(device=cuda).manual_seed(0), m=8,
                          n=128, p=256, s=8, device=cuda)
    ref = dsml_fit(data.Xs, data.ys, 0.3, 0.15, 0.5, lasso_iters=100,
                   debias_iters=100)
    return got, calls, ref


def test_dsml_fit_sharded_gloo_on_card_matches_dsml_fit(cuda, tmp_path):
    """Two gloo ranks on the card (gloo taking the CUDA operand):
    every rank's rows within 1e-5 · max|.| of `dsml_fit`, the same
    support, one collective a rank."""
    got, calls, ref = _sharded_on_card(cuda, tmp_path, 2, "gloo")
    for rank, (res, c) in enumerate(zip(got, calls)):
        assert sum(c.values()) == 1, c
        rows = slice(rank * 4, (rank + 1) * 4)
        assert torch.equal(res["support"], ref.support.cpu())
        _assert_close([res["beta_tilde"], res["beta_u_all"]],
                      [ref.beta_tilde[rows].cpu(), ref.beta_u.cpu()])


def test_dsml_fit_sharded_nccl_world_one_gives_the_same_bits(cuda,
                                                             tmp_path):
    """One NCCL rank: the same kernels on the same tensors, and the
    gather of one rank a copy, so `dsml_fit`'s bits."""
    got, calls, ref = _sharded_on_card(cuda, tmp_path, 1, "nccl")
    assert sum(calls[0].values()) == 1
    for name in ("beta_tilde", "beta_u", "support", "beta_local"):
        assert torch.equal(got[0][name], getattr(ref, name).cpu()), name


def test_sparse_probe_kernels_match_plain(cuda):
    """The probe through the kernels against `use_kernel=False` on the
    card, on a reduced granite's features: the same support, Λ and
    beta_tilde within 1e-4 · max|.| (Λ is read off the debiased rows,
    which the two paths sum in another order)."""
    from repro_torch.configs import smoke
    from repro_torch.multitask import (
        default_threshold, sparse_probe_fit, synthetic_probe_tasks,
    )
    cfg = smoke(get_config("granite-3-2b")).replace(
        compute_dtype="float32", param_dtype="float32")
    params = init_params(torch.Generator(device=cuda).manual_seed(0), cfg)
    data, _ = synthetic_probe_tasks(
        torch.Generator(device=cuda).manual_seed(1), params, cfg, m=4, n=96,
        s_active=6)
    before = dict(LAUNCHES)
    got = sparse_probe_fit(data)
    assert LAUNCHES["rank_update"] == before["rank_update"] + 1
    assert LAUNCHES["fista_step_gemm"] == before["fista_step_gemm"] + 400
    want = sparse_probe_fit(data, use_kernel=False)
    lam_k, lam_p = default_threshold(got.beta_u), \
        default_threshold(want.beta_u)
    assert abs(lam_k - lam_p) <= 1e-4 * lam_p
    assert torch.equal(got.support, want.support)
    _assert_close([got.beta_tilde], [want.beta_tilde], tol=1e-4)


_LOCAL_HEADS = r"""
import functools, json
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.kernels.common import LAUNCHES, reset_launches
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.layers import _attention_core, _on_local_heads
from repro_torch.sharding.place import place
from repro_torch.substrate import init_from_env
dev = torch.device("cuda")
init_from_env(device=dev)
mesh = make_host_mesh(1, device_type="cuda")
g = torch.Generator(device=dev).manual_seed(0)
# the sharded train step's per-rank shape (granite at a model axis of 2)
q = torch.randn((4, 2048, 16, 64), generator=g, device=dev).bfloat16()
k, v = (torch.randn((4, 2048, 4, 64), generator=g, device=dev).bfloat16()
        for _ in range(2))
pl = [Replicate(), Shard(2)]
out = {}
for use_kernel in (None, False):
    qd, kd, vd = (place(t, mesh, pl).requires_grad_() for t in (q, k, v))
    core = functools.partial(_attention_core, flash=True, causal=True,
                             window=0, use_kernel=use_kernel, cross=False)
    reset_launches()
    o = _on_local_heads(core, qd, kd, vd)
    torch.cuda.synchronize()
    launches = LAUNCHES["flash_attention"]
    dq = torch.autograd.grad(o.to_local().float().sum(), qd)[0]
    out[str(use_kernel)] = (o.to_local().float(), dq.to_local().float(),
                            launches, list(o.to_local().shape),
                            isinstance(o, DTensor))
(ok, gk, nk, shape, is_dt), (op, gp, n_plain, _, _) = out["None"], out["False"]
# the output against the plain version on the f32 upcast, row by row
from repro_torch.kernels.flash_attention.ops import flash_attention
ref = flash_attention(q.float(), k.float(), v.float(), use_kernel=False)
rows = ((ok - ref).norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)).max()
print(json.dumps(dict(launches=nk, plain=n_plain, shape=shape, dtensor=is_dt,
                      row_err=rows.item(),
                      grad_err=((gk - gp).abs().max() / gp.abs().max()).item())))
"""


def test_flash_attention_train_on_local_heads_launches_the_kernel(cuda):
    """`flash_attention_train` under `local_map` (`layers._on_local_heads`)
    on a one-rank (1, 1) CUDA mesh at the sharded step's per-rank shape:
    the kernel launches once, its output DTensor holds the local heads,
    each query row within 1e-2 (relative l2) of the plain version's on
    the f32 upcast (the file's bf16 bar), and the gradient of q within
    5e-2 · max|plain| of the plain bf16 path's (the kernel keeps q·k in
    f32, the plain bf16 forward rounds it)."""
    from repro_torch.substrate import run_probe
    run = run_probe(_LOCAL_HEADS, world=1, timeout=120, pg_timeout=60)
    assert run.ok, run.report()
    got = json.loads(run.ranks[0].stdout.strip().splitlines()[-1])
    assert got["launches"] == 1 and got["plain"] == 0
    assert got["shape"] == [4, 2048, 16, 64] and got["dtensor"]
    assert got["row_err"] <= 1e-2, got
    assert got["grad_err"] <= 5e-2, got


# ---- launch plans forced by block=, and the autotune sweep ----------------
#
# Every plan of every table launches exactly as given. The regression
# kernels' plans give the rule's bits (no split-K, the same FMA chains in
# the same order); the logistic plans sum in other orders, so they are
# held to the plain version's bar.

@pytest.mark.parametrize("m, p, r", [(16, 1024, 1), (3, 129, 1), (1, 1023, 1),
                                     (3, 200, 200), (2, 130, 5),
                                     (1, 1024, 1024)])
def test_every_fista_plan_gives_the_rules_bits(cuda, m, p, r):
    from repro_torch.kernels.autotune import block_candidates
    Sig, b, c, etas, lams = _ista_inputs(cuda, m, p, r)
    x = b + 0.1
    theta = np.float32(0.6)
    want = fista_step_batched(Sig, b, x, c, etas, lams, theta)
    want_ista = ista_step_batched(Sig, b, c, etas, lams)
    plain = fista_step_batched(Sig, b, x, c, etas, lams, theta,
                               use_kernel=False)
    _assert_close(want, plain)
    key = "fista_step_gemv" if r == 1 else "fista_step_gemm"
    for block in block_candidates(m, p, r):
        before = LAUNCHES[key]
        got = fista_step_batched(Sig, b, x, c, etas, lams, theta,
                                 block=block)
        assert LAUNCHES[key] == before + 1
        assert all(torch.equal(a, w) for a, w in zip(got, want)), block
        assert torch.equal(ista_step_batched(Sig, b, c, etas, lams,
                                             block=block), want_ista), block
        if m == 1:
            assert torch.equal(ista_step(Sig[0], b[0], c[0], etas[0],
                                         lams[0], block=block),
                               want_ista[0]), block


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("m, n, p", [(16, 512, 1024), (8, 1024, 256),
                                     (2, 7, 129)])
def test_every_rank_tile_gives_the_rules_bits(cuda, m, n, p, weighted):
    from repro_torch.kernels.rank_update.ops import RANK_TILES
    g = torch.Generator(device=cuda).manual_seed(11)
    X = torch.randn((m, n, p), generator=g, device=cuda)
    y = torch.randn((m, n), generator=g, device=cuda)
    w = 0.5 + torch.rand((m, n), generator=g, device=cuda) if weighted \
        else None
    want = rank_update(X, y, w)
    _assert_close(want, rank_update(X, y, w, use_kernel=False))
    for block in RANK_TILES:
        got = rank_update(X, y, w, block=block)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), block
        assert torch.equal(rank_update_unfused(X, y, w, block=block)[0],
                           want[0]), block


@pytest.mark.parametrize("m, n, p", [(16, 512, 1024), (4, 256, 8192),
                                     (4, 64, 8196), (2, 7, 129)])
def test_every_logistic_plan_matches_plain(cuda, m, n, p):
    from repro_torch.kernels.autotune import logistic_candidates
    from repro_torch.kernels.logistic_grad.ops import (
        UNFUSED_COLS, UNFUSED_Z_PLANS,
    )
    X, y, B = _logistic_inputs(cuda, m, n, p)
    want = logistic_grad(X, y, B, use_kernel=False)
    props = torch.cuda.get_device_properties(cuda)
    for cluster in logistic_candidates(m, n, p):
        pl = plan(m, n, p, props.multi_processor_count,
                  props.shared_memory_per_block_optin,
                  vec=vectorized(X, B), cluster=cluster)
        G = torch.empty((m, p), device=cuda)
        work = torch.empty((m, pl.chunks, p), device=cuda)
        ran = launch(X, y, B, G, work, ticket_counters(cuda, m * cluster),
                     cluster)
        assert ran == pl, (cluster, ran, pl)
        got = logistic_grad(X, y, B, block=cluster)
        _assert_close((got, G), (want, want))
        assert torch.equal(got, G)
        assert torch.equal(got, logistic_grad(X, y, B, block=cluster))
    for rpw, wpr in UNFUSED_Z_PLANS:
        for cols in UNFUSED_COLS:
            got = logistic_grad_unfused(X, y, B, block=(rpw, wpr, cols))
            _assert_close((got,), (want,))


def test_a_plan_out_of_range_is_refused_at_launch(cuda):
    """The launchers refuse a plan index out of their tables, and a
    cluster the row does not allow, with an error and no launch."""
    from repro_torch.kernels.ista_step import ops as ista_ops
    from repro_torch.kernels.rank_update import ops as rank_ops
    Sig, b, c, etas, lams = _ista_inputs(cuda, 2, 256, 1)
    out = torch.empty_like(b)
    for bad in (5, 99, -2):
        with pytest.raises(RuntimeError, match="CUDA error"):
            ista_ops.launch(Sig, b, b, c, etas, lams, 0.5, out,
                            torch.empty_like(b), bad)
    Z = torch.cat([b] * 4, -1)
    with pytest.raises(RuntimeError, match="CUDA error"):
        ista_ops.launch_ista(Sig, Z, Z, etas, lams, torch.empty_like(Z),
                             "ista_step_batched", len(ista_ops.GEMM_TILES))
    X = torch.randn((2, 16, 256), device=cuda)
    y = torch.randn((2, 16), device=cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        rank_ops.launch(X, y, None, torch.empty((2, 256, 256), device=cuda),
                        torch.empty((2, 256), device=cuda), 2)
    Xl, yl, Bl = _logistic_inputs(cuda, 4, 64, 1024)
    G = torch.empty((4, 1024), device=cuda)
    work = torch.empty((4, 64, 1024), device=cuda)
    for bad in (2, 3, 16, 0):           # cluster_max(1024) is 1
        with pytest.raises(RuntimeError, match="CUDA error"):
            launch(Xl, yl, Bl, G, work, ticket_counters(cuda, 64), bad)
    with pytest.raises(RuntimeError, match="CUDA error"):
        launch_unfused(Xl, yl, Bl, torch.empty((4, 64), device=cuda), G, 15)
    with pytest.raises(ValueError, match="cluster size"):
        logistic_grad(Xl, yl, Bl, block=2)
    with pytest.raises(ValueError, match="GEMV_PLANS"):
        fista_step_batched(Sig, b, b, c, etas, lams, 0.5, block=128)


def test_a_sweep_caches_its_winner(cuda, tmp_path, monkeypatch):
    """A sweep on the card times every plan, keeps the fastest in the
    port's cache file and in memory, counts none of its launches, and
    the engine's default (block=None) then launches that plan with the
    rule's bits."""
    from repro_torch import obs
    from repro_torch.core.engine import solve_lasso_batched
    from repro_torch.kernels import autotune
    monkeypatch.setenv("REPRO_TORCH_CACHE_DIR", str(tmp_path))
    autotune.clear_memory_cache()
    obs.reset()
    before = dict(LAUNCHES)
    won = autotune.autotune_block(16, 1024, 1, device=cuda)
    rank = autotune.autotune_rank_block(8, 1024, 256, device=cuda)
    cluster = autotune.autotune_logistic_block(4, 256, 8192, device=cuda)
    assert dict(LAUNCHES) == before
    assert won in autotune.block_candidates(16, 1024, 1)
    assert rank in autotune.rank_candidates(8, 1024, 256)
    assert cluster in (1, 2, 4, 8)
    entries = json.loads((tmp_path / autotune.CACHE_FILE).read_text())
    assert len(entries) == 3
    assert obs.hist_stats("autotune.candidate_us")["count"] == 5 + 2 + 4
    assert autotune.autotune_block(16, 1024, 1, device=cuda) == won
    assert obs.counter_total("autotune.cache", event="hit_memory") == 1
    Sig, b, c, etas, lams = _ista_inputs(cuda, 16, 1024, 1)
    got = solve_lasso_batched(Sig, c[..., 0], 0.05, iters=20, etas=etas)
    assert obs.counter_total("autotune.cache", event="hit_memory") == 2
    for block in autotune.block_candidates(16, 1024, 1):
        assert torch.equal(solve_lasso_batched(Sig, c[..., 0], 0.05,
                                               iters=20, etas=etas,
                                               block=block), got)
    autotune.clear_memory_cache()


# ---- granite-4.0-h-small: the held experts' grouped products, the
# attention's softmax scale ----------------------------------------------

GROUPS = [[3000, 0, 2500, 1, 4000, 2275, 2300, 2000, 4404],
          [0, 0, 129, 0], [1, 1, 1]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("counts, K, N", [(GROUPS[0], 4096, 768),
                                          (GROUPS[0], 768, 4096),
                                          (GROUPS[1], 200, 136),
                                          (GROUPS[2], 64, 64)])
def test_grouped_products_match_f32(cuda, dtype, counts, K, N):
    """`moe.grouped_mm` (one `torch.mm` a group: y, and through autograd
    the input gradient and dw, zeros for an empty group) on the card
    against the float64 products, group by group: within 1e-5 ·
    max|want| in f32 (TF32 off, another order), 1e-2 in bf16 (the output
    rounded to bf16), ragged groups and edges included (the cell's
    20,480 rows over 9 experts, one empty; 129 rows in one group of four;
    rows of one)."""
    from repro_torch.models.moe import grouped_mm
    g = torch.Generator(device=cuda).manual_seed(10)
    R = sum(counts)
    x = torch.randn((R, K), generator=g, device=cuda).to(dtype)
    w = (torch.randn((len(counts), K, N), generator=g, device=cuda)
         * K ** -0.5).to(dtype)
    dy = torch.randn((R, N), generator=g, device=cuda).to(dtype)
    xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        y = grouped_mm(xs, ws, counts)
        dx, dw = torch.autograd.grad(y, (xs, ws), dy)
        xf, wf, dyf = x.double(), w.double(), dy.double()
        want = (torch.empty_like(y, dtype=torch.float64),
                torch.empty_like(dx, dtype=torch.float64),
                torch.zeros_like(wf))
        a = 0
        for e, n in enumerate(counts):
            want[0][a:a + n] = xf[a:a + n] @ wf[e]
            want[1][a:a + n] = dyf[a:a + n] @ wf[e].T
            want[2][e] = xf[a:a + n].T @ dyf[a:a + n]
            a += n
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    tol = TOL if dtype == torch.float32 else 1e-2
    for got, ref_ in zip((y, dx, dw), want):
        assert got.dtype == dtype
        _assert_close([got.float()], [ref_.float()], tol)
    for e, n in enumerate(counts):
        if n == 0:
            assert bool((dw[e] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_scale_is_the_kernels_argument(cuda, dtype):
    """#9 with its lse at granite-4.0-h-small's softmax scale 1/128 (H =
    128, no rotary) against the plain forward at that scale, and the
    training gradients against the plain path's, at (1, 1024, 32, 8, 128)
    causal: the bars of the tests above."""
    g = torch.Generator(device=cuda).manual_seed(11)
    shapes = ((1, 1024, 32, 128), (1, 1024, 8, 128), (1, 1024, 8, 128))
    qkv = [torch.randn(sh, generator=g, device=cuda).to(dtype)
           for sh in shapes]
    out, lse = flash_attention_fwd_lse(*qkv, scale=1 / 128)
    want_out, want = flash_attention_fwd_lse(*(t.float() for t in qkv),
                                             scale=1 / 128, use_kernel=False)
    default = flash_attention_fwd_lse(*qkv)[1]
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 1e-4
    err = (torch.abs(lse - want) / torch.clamp_min(torch.abs(want), 1.0))
    assert err.max().item() <= tol
    assert (default - lse).abs().max().item() > 0.1
    row = (torch.linalg.vector_norm(out.float() - want_out, dim=-1)
           / torch.linalg.vector_norm(want_out, dim=-1)).max().item()
    assert row <= (1e-4 if dtype == torch.float32 else 1e-2), row
    dout = torch.randn(shapes[0], generator=g, device=cuda).to(dtype)
    grads = []
    for use_kernel in (None, False):
        ts = [t.clone().requires_grad_() for t in qkv]
        flash_attention_train(*ts, use_kernel=use_kernel,
                              scale=1 / 128).backward(dout)
        grads.append([t.grad for t in ts])
    tol = 1e-4 if dtype == torch.float32 else 5e-2
    for got, want_g in zip(*grads):
        err = (got.float() - want_g.float()).abs().max().item()
        assert err <= tol * want_g.float().abs().max().item()


def test_granite_hybrid_train_step_on_the_card(cuda):
    """granite-4.0-h-small at the smoke size in f32 on the card, through
    #9 at S = 2048 and the grouped products: the loss and every
    gradient leaf within 1e-4 of the plain reference's (TF32 off), none
    of the held routes dropped."""
    from repro_torch import obs
    from repro_torch.configs import smoke
    from repro_torch.models import layers as tlayers
    from repro_torch.testing import granite_hybrid_ref as ref
    from repro_torch.training.step import make_grad_fn
    from repro_torch.tree import named_leaves
    cfg = smoke(get_config("granite-4.0-h-small")).replace(
        param_dtype="float32", compute_dtype="float32", head_dim=128,
        n_heads=2, n_kv_heads=1)
    g = torch.Generator(device=cuda).manual_seed(12)
    params = init_params(g, cfg)
    tokens = torch.randint(0, cfg.vocab, (1, 2048), generator=g,
                           device=cuda)
    labels = torch.randint(0, cfg.vocab, (1, 2048), generator=g,
                           device=cuda)
    obs.reset()
    before = LAUNCHES["flash_attention"]
    with ref.no_tf32():
        loss, _, grads = make_grad_fn(cfg)(params, Batch(tokens, labels))
    assert 2048 * 2048 >= tlayers.FLASH_THRESHOLD
    assert LAUNCHES["flash_attention"] > before
    assert obs.counter_total("moe.routes_dropped") == 0
    want_loss, want = ref.loss_and_grads(params, ref.spec_of(cfg), tokens,
                                         labels)
    assert abs(float(loss) - float(want_loss)) <= 1e-4 * float(want_loss)
    mine = named_leaves(grads)
    for k, w in want.items():
        err = torch.linalg.vector_norm(mine[k].float() - w)
        assert err <= 1e-4 * torch.linalg.vector_norm(w), k
