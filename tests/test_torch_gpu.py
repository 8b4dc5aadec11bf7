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
from repro_torch.kernels.group_threshold.ops import group_threshold
from repro_torch.kernels.ista_step.ops import (
    fista_step_batched, gemm_plan, gemv_plan, ista_solve, ista_step,
    ista_step_batched, kernel_gemm_plan, kernel_gemv_plan,
)
from repro_torch.kernels.logistic_grad.ops import (
    kernel_unfused_plan, launch_unfused, logistic_grad, logistic_grad_unfused,
    unfused_plan,
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


@pytest.mark.parametrize("m, n, p", _LOGISTIC_SHAPES)
def test_logistic_grad_kernel_matches_plain(cuda, m, n, p):
    X, y, B = _logistic_inputs(cuda, m, n, p)
    before = LAUNCHES["logistic_grad"]
    got = logistic_grad(X, y, B)
    assert LAUNCHES["logistic_grad"] == before + 1
    _assert_close((got,), (logistic_grad(X, y, B, use_kernel=False),))
    # the sample reduction runs in a fixed order: the same bits every run
    assert torch.equal(got, logistic_grad(X, y, B))


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
