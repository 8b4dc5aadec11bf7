"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`; every test skips (at run time, through the `cuda` fixture)
where no CUDA device is present. Run them on a machine with a card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Tolerance: max abs error <= 1e-5 * max|plain| per output (both sides
accumulate in f32, in another order).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.dsml import dsml_fit
from repro_torch.core.engine import power_iteration_batched
from repro_torch.core.synth import gen_regression
from repro_torch.kernels.common import LAUNCHES
from repro_torch.kernels.ista_step.ops import fista_step_batched
from repro_torch.kernels.rank_update.ops import rank_update

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
