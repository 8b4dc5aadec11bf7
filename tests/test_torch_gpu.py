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
it), and in f32 also within 2e-5 * max|plain|. The last flash shape has
T = 300, not a multiple of the 128-key tile of the bf16 kernel, and a
window of 40 that cuts its tiles.
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
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.group_threshold.ops import (
    group_threshold, kernel_row_lanes, row_lanes,
)
from repro_torch.kernels.ista_step.ops import (
    fista_step_batched, gemm_plan, gemv_plan, ista_solve, ista_step,
    ista_step_batched, kernel_gemm_plan, kernel_gemv_plan,
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
                                     (3, 129, 7), (2, 1001, 1001)])
def test_fista_gemm_kernel_matches_plain_on_every_tile(cuda, m, p, r,
                                                       momentum):
    """The r > 1 kernel at shapes that between them take every tile of
    `gemm_plan` (the launcher's own choice is held to the Python rule),
    the 16-byte and the 4-byte copies, with and without momentum; two
    launches give the same bits."""
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b, s, t, n, k, h, causal, window", [
    (2, 256, 256, 8, 2, 64, True, 0), (1, 200, 200, 4, 1, 128, True, 0),
    (1, 512, 512, 4, 1, 256, True, 64), (2, 256, 256, 8, 2, 64, False, 0),
    (1, 64, 200, 4, 2, 64, True, 0), (1, 200, 333, 4, 1, 128, False, 16),
    (4, 2048, 2048, 32, 8, 64, True, 0), (1, 300, 300, 4, 2, 64, True, 40)])
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
