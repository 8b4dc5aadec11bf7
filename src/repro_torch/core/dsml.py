"""DSML — Distributed debiased Sparse Multi-task Lasso (paper Algorithm 1),
single-host (`dsml_fit`).

Steps 1-2 run through the batched sufficient-statistics engine
(core/engine.py): the m local lassos are ONE batched solve, and the m
debias M-matrix estimations are ONE batched multi-RHS solve, each
iteration one launch of the fused FISTA kernel on CUDA tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.engine import (
    debias_batched,
    inverse_hessian_batched,
    power_iteration_batched,
    solve_lasso_eq2,
    sufficient_stats,
)
from repro_torch.core.prox import support_from_rows
from repro_torch.core.solvers import refit_ols_masked_stats


class DsmlResult(NamedTuple):
    beta_tilde: torch.Tensor   # (m, p) final filtered estimates
    beta_u: torch.Tensor       # (m, p) debiased estimates (communicated)
    support: torch.Tensor      # (p,) bool, \hat S(Lambda)
    beta_local: torch.Tensor   # (m, p) local lasso estimates (step 1)


def _local_work_stats(Sigmas, cs, lam, mu, lasso_iters, debias_iters, *,
                      use_kernel=None):
    """Steps 1-2 of Algorithm 1 on sufficient statistics, batched over
    the m local tasks. No communication. One shared power iteration
    feeds both solves' step sizes."""
    lam_max = power_iteration_batched(Sigmas)
    beta_hat = solve_lasso_eq2(Sigmas, cs, lam, iters=lasso_iters,
                               lam_max=lam_max, use_kernel=use_kernel)
    Ms = inverse_hessian_batched(Sigmas, mu, iters=debias_iters,
                                 lam_max=lam_max, use_kernel=use_kernel)
    beta_u = debias_batched(Sigmas, cs, beta_hat, Ms)
    return beta_hat, beta_u


def dsml_fit(
    Xs: torch.Tensor,
    ys: torch.Tensor,
    lam,
    mu,
    Lam,
    lasso_iters: int = 400,
    debias_iters: int = 600,
    refit: bool = False,
    *,
    use_kernel: bool | None = None,
) -> DsmlResult:
    """Single-host Algorithm 1. Xs: (m, n, p), ys: (m, n), float32, on
    the device the fit runs on. `use_kernel` as in `kernels/common.py`:
    the CUDA kernels for CUDA tensors by default, `False` for the plain
    PyTorch path on any device."""
    Sigmas, cs = sufficient_stats(Xs, ys, use_kernel=use_kernel)
    beta_hat, beta_u = _local_work_stats(Sigmas, cs, lam, mu, lasso_iters,
                                         debias_iters, use_kernel=use_kernel)
    support = support_from_rows(beta_u.T, Lam)            # master: eq. (5)
    if refit:
        # one LU solve per task, as the reference maps it: a batched LU
        # solve hangs in MKL-backed CPU builds of PyTorch (threaded getrf)
        beta_tilde = torch.stack([refit_ols_masked_stats(S, c, support)
                                  for S, c in zip(Sigmas, cs)])
    else:
        beta_tilde = beta_u * support[None, :]            # workers: eq. (6)
    return DsmlResult(beta_tilde, beta_u, support, beta_hat)
