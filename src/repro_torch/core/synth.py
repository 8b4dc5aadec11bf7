"""Synthetic data generation matching the paper's Section 6 setup.

Rows of X_t ~ N(0, Sigma) with Sigma_ab = 2^{-|a-b|}; nonzero
coefficients uniform in [low, high]; sigma^2 = 1; shared support.

Drawn from an explicit `torch.Generator` on the given device, so the
data is made where it is used. The numbers differ from the reference's
(`repro/core/synth.py`, a JAX PRNG) for the same seed; parity tests
hand both packages the same arrays instead.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class MultiTaskData(NamedTuple):
    Xs: torch.Tensor        # (m, n, p)
    ys: torch.Tensor        # (m, n)
    B: torch.Tensor         # (p, m) true coefficients (rows = variables)
    support: torch.Tensor   # (p,) bool
    Sigma: torch.Tensor     # (p, p) population covariance


def ar_covariance(p: int, rho: float = 0.5, dtype=torch.float32,
                  device="cuda") -> torch.Tensor:
    """Sigma_ab = rho^{|a-b|}; the paper uses 2^{-|a-b|} i.e. rho = 0.5."""
    idx = torch.arange(p, device=device)
    lag = torch.abs(idx[:, None] - idx[None, :]).to(torch.float64)
    return (rho ** lag).to(dtype)


def _generator(gen: torch.Generator | int, device) -> torch.Generator:
    if isinstance(gen, torch.Generator):
        return gen
    return torch.Generator(device=device).manual_seed(int(gen))


def sample_coefficients(gen: torch.Generator | int, p: int, m: int, s: int,
                        low=0.0, high=1.0, signed: bool = False, *,
                        device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """Shared-support coefficient matrix B (p, m) and its support (p,).
    `gen` is a generator on `device`, or a seed for one."""
    g = _generator(gen, device)
    perm = torch.randperm(p, generator=g, device=device)
    support = torch.zeros(p, dtype=torch.bool, device=device)
    support[perm[:s]] = True
    vals = low + (high - low) * torch.rand((p, m), generator=g,
                                           device=device)
    if signed:
        signs = torch.randint(0, 2, (p, m), generator=g, device=device)
        vals = vals * (2.0 * signs - 1.0)
    return vals * support[:, None], support


def gen_regression(gen: torch.Generator | int, *, m: int = 10, n: int = 50,
                   p: int = 200, s: int = 10, sigma: float = 1.0,
                   rho: float = 0.5, signal_low: float = 0.0,
                   signal_high: float = 1.0,
                   device="cuda") -> MultiTaskData:
    """Multi-task linear regression data, paper model (1)/(16), float32
    on `device`. `gen` is a generator on `device`, or a seed for one."""
    g = _generator(gen, device)
    Sigma = ar_covariance(p, rho, device=device)
    eye = torch.eye(p, dtype=Sigma.dtype, device=device)
    chol = torch.linalg.cholesky(Sigma + 1e-9 * eye)
    B, support = sample_coefficients(g, p, m, s, signal_low, signal_high,
                                     device=device)
    Z = torch.randn((m, n, p), generator=g, device=device)
    Xs = Z @ chol.T
    eps = sigma * torch.randn((m, n), generator=g, device=device)
    ys = torch.einsum("tnp,pt->tn", Xs, B) + eps
    return MultiTaskData(Xs, ys, B, support, Sigma)


def gen_classification(gen: torch.Generator | int, *, m: int = 10,
                       n: int = 150, p: int = 200, s: int = 10,
                       rho: float = 0.5, signal_scale: float = 2.0,
                       device="cuda") -> MultiTaskData:
    """Multi-task logistic data, paper model (7): y in {-1, +1},
    P(y|x) = sigmoid(y * x @ beta); AR(rho) rows and shared-support
    coefficients uniform in [0, signal_scale]. float32 on `device`; `gen`
    is a generator on `device`, or a seed for one."""
    g = _generator(gen, device)
    Sigma = ar_covariance(p, rho, device=device)
    eye = torch.eye(p, dtype=Sigma.dtype, device=device)
    chol = torch.linalg.cholesky(Sigma + 1e-9 * eye)
    B, support = sample_coefficients(g, p, m, s, 0.0, signal_scale,
                                     device=device)
    Z = torch.randn((m, n, p), generator=g, device=device)
    Xs = Z @ chol.T
    logits = torch.einsum("tnp,pt->tn", Xs, B)
    u = torch.rand((m, n), generator=g, device=device)
    ys = torch.where(u < torch.sigmoid(logits), 1.0, -1.0)
    return MultiTaskData(Xs, ys, B, support, Sigma)
