"""Batched sufficient-statistics solver engine (the main-path subset of
`repro/core/engine.py`).

Every l1-regularized quadratic of DSML Algorithm 1 — the per-task lasso
of step 1 and the debias M-matrix estimation of step 2 — is an instance
of

    min_b  (1/2) b' Sigma b - c' b + lam ||b||_1

on precomputed sufficient statistics (Sigma, c). The engine solves a
whole BATCH of such problems (independent Sigmas, multi-RHS c) in one
accelerated FISTA loop whose every iteration is ONE launch of the fused
`fista_step_batched` kernel on CUDA tensors (its plain version on CPU
tensors, or anywhere with `use_kernel=False`). The step sizes and the
momentum schedule are the reference's, so the iterates agree with it.

The Section-4 logistic lasso is not a quadratic on (Sigma, c): its loop
(`solve_logistic_lasso_batched`) re-reads the raw samples through one
launch of the fused `logistic_grad` kernel per iteration.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.prox import soft_threshold
from repro_torch.core.solvers import (
    fista_momentum, lasso_stats_step_scale, power_iteration,
)
from repro_torch.kernels.ista_step.ops import fista_step_batched
from repro_torch.kernels.logistic_grad.ops import logistic_grad
from repro_torch.kernels.rank_update.ops import rank_update


def power_iteration_batched(Sigmas: torch.Tensor,
                            iters: int = 64) -> torch.Tensor:
    """Largest eigenvalue per task of a (m, p, p) PSD stack."""
    return power_iteration(Sigmas, iters=iters)


def sufficient_stats(Xs: torch.Tensor, ys: torch.Tensor,
                     weights: torch.Tensor | None = None, *,
                     use_kernel: bool | None = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-task empirical covariance and correlation.

    Xs: (m, n, p), ys: (m, n) -> Sigmas (m, p, p), cs (m, p); optional
    per-sample `weights` (m, n), still normalized by n. One launch of
    the fused rank-n kernel (`kernels/rank_update`) on CUDA tensors.
    """
    return rank_update(Xs, ys, weights, use_kernel=use_kernel)


def _fista_loop(body, init, iters: int, tol, check_every: int, residual):
    """The shared FISTA loop. `body` maps a (x, z, t) carry one
    iteration forward; with `tol=None` it runs the fixed `iters` budget,
    otherwise `check_every`-iteration chunks that stop once
    `residual(x) <= tol`. The final chunk is truncated so `iters` is an
    EXACT ceiling. Returns (x, n_iters_run).

    With `tol=` the residual is read back to the host once per chunk
    (one synchronisation per `check_every` iterations); without it the
    loop never synchronises."""
    carry = init
    if tol is None:
        for _ in range(iters):
            carry = body(carry)
        return carry[0], iters
    K = min(check_every, iters)
    tol = np.float32(tol)
    it, res = 0, np.float32(np.inf)
    while it < iters and res > tol:
        end = min(it + K, iters)
        for _ in range(it, end):
            carry = body(carry)
        it = end
        res = np.float32(residual(carry[0]))
    return carry[0], it


def solve_lasso_batched(Sigmas: torch.Tensor, cs: torch.Tensor, lam, *,
                        iters: int = 400, etas: torch.Tensor | None = None,
                        beta0: torch.Tensor | None = None,
                        use_kernel: bool | None = None,
                        tol=None, check_every: int = 25,
                        return_iters: bool = False):
    """FISTA on a batch of sufficient-statistics lasso problems.

    Sigmas: (m, p, p); cs: (m, p) for one RHS per task or (m, p, r) for
    multi-RHS (the debias solve uses r = p with c = I). Returns a tensor
    shaped like `cs`.

    `etas` (m,) are per-task gradient step sizes; default 1/lambda_max
    per task. `lam` is a scalar or per-task (m,) weight; the proximal
    threshold is `etas * lam`. `beta0` warm-starts the iterates.
    With `tol=` the fixed iteration budget becomes an exact ceiling:
    the loop runs in `check_every`-iteration chunks and stops once the
    prox-gradient KKT residual max|x - soft(x - eta(Sigma x - c),
    eta lam)| drops to `tol`; the residual is one more launch of the
    fused step with zero momentum, whose x_next is the ISTA step.
    `return_iters` additionally returns the iterations run.
    """
    squeeze = cs.ndim == 2
    C = cs[..., None] if squeeze else cs
    m = C.shape[0]
    if etas is None:
        etas = 1.0 / torch.clamp_min(power_iteration_batched(Sigmas), 1e-12)
    etas = torch.as_tensor(etas, dtype=C.dtype, device=C.device)
    etas = etas.reshape(-1).expand(m).contiguous()
    lams = torch.as_tensor(lam, dtype=C.dtype, device=C.device)
    lams = lams.reshape(-1).expand(m).contiguous()

    def step(Z, X, theta):
        return fista_step_batched(Sigmas, Z, X, C, etas, lams, theta,
                                  use_kernel=use_kernel)

    if beta0 is None:
        X0 = torch.zeros_like(C)
    else:
        b0 = beta0[..., None] if beta0.ndim == C.ndim - 1 else beta0
        X0 = b0.expand(C.shape).to(C.dtype).contiguous()

    def body(carry):
        x, z, t = carry
        t_next, theta = fista_momentum(t)
        x_next, z_next = step(z, x, theta)
        return x_next, z_next, t_next

    def residual(x):
        x_fp, _ = step(x, x, 0.0)
        return torch.max(torch.abs(x_fp - x)).item()

    x, n_iters = _fista_loop(body, (X0, X0, np.float32(1.0)), iters, tol,
                             check_every, residual)
    out = x[..., 0] if squeeze else x
    return (out, n_iters) if return_iters else out


def solve_lasso_eq2(Sigmas: torch.Tensor, cs: torch.Tensor, lam, *,
                    iters: int = 400,
                    beta0: torch.Tensor | None = None,
                    lam_max: torch.Tensor | None = None,
                    tol=None, check_every: int = 25,
                    return_iters: bool = False,
                    use_kernel: bool | None = None):
    """Batched lasso in the PAPER'S eq.-2 convention:

        (1/n)||y_t - X_t b||^2 + lam ||b||_1

    on sufficient statistics. Owns the translation into the engine's
    normalized-gradient convention — step 2/max(2*lambda_max, eps),
    threshold weight lam/2 — so callers can never mismatch the pair
    (passing an unhalved lam with the eq.-2 step runs at double the
    intended regularization with no error). `beta0` (m, p) warm-starts
    the iterates; `lam_max` (m,) are precomputed per-task largest
    eigenvalues, shared with the debias solve. `tol=` makes `iters` an
    exact ceiling; `return_iters` also returns the iterations run."""
    if lam_max is None:
        etas = lasso_stats_step_scale(Sigmas)
    else:
        etas = 2.0 / torch.clamp_min(2.0 * lam_max, 1e-12)
    lam_half = 0.5 * torch.as_tensor(lam, dtype=cs.dtype, device=cs.device)
    return solve_lasso_batched(Sigmas, cs, lam_half, iters=iters, etas=etas,
                               beta0=beta0, use_kernel=use_kernel, tol=tol,
                               check_every=check_every,
                               return_iters=return_iters)


def solve_logistic_lasso_batched(Xs: torch.Tensor, ys: torch.Tensor, lam, *,
                                 iters: int = 600,
                                 etas: torch.Tensor | None = None,
                                 beta0: torch.Tensor | None = None,
                                 grad_scale=1.0, prox=None,
                                 momentum: bool = True, tol=None,
                                 check_every: int = 25,
                                 use_kernel: bool | None = None,
                                 return_iters: bool = False):
    """One FISTA loop for a whole batch of l1-logistic regressions.

    Xs (m, n, p), ys (m, n) in {-1, +1}; lam scalar or per-task (m,).
    Returns B (m, p). The logistic loss is not a function of (Sigma, c)
    alone, so every iteration re-reads the raw samples through ONE
    all-tasks gradient -X'(y sigmoid(-y Xb))/n: one launch of the fused
    `logistic_grad` kernel on CUDA tensors. The default per-task step
    sizes are 1 / max(lambda_max(Sigma)/4, eps), from one unweighted
    `sufficient_stats` and one batched power iteration (the logistic
    Hessian is bounded by Sigma/4).

    `beta0` (m, p) warm-starts the iterates. `prox(B (m, p), steps (m, 1))
    -> (m, p)` overrides the elementwise soft threshold (the group-lasso,
    iCAP and masked-refit variants). `grad_scale` rescales the gradient
    after the kernel; `momentum=False` makes the loop plain proximal
    gradient. `tol=` stops early on the prox-gradient fixed-point residual
    every `check_every` iterations, and `return_iters` also returns the
    iterations run, as in `solve_lasso_batched`.
    """
    m, n, p = Xs.shape
    lam_t = torch.as_tensor(lam, dtype=Xs.dtype, device=Xs.device)
    lam_t = lam_t.reshape(-1).expand(m)
    if etas is None:
        Sigmas, _ = sufficient_stats(Xs, ys, use_kernel=use_kernel)
        L = 0.25 * power_iteration_batched(Sigmas)
        etas = 1.0 / torch.clamp_min(L, 1e-12)
    S = torch.as_tensor(etas, dtype=Xs.dtype, device=Xs.device)
    S = S.reshape(-1).expand(m)[:, None]

    def grad(B):
        # a transposing prox (group lasso, iCAP) leaves strided iterates;
        # the kernel takes contiguous ones
        return logistic_grad(Xs, ys, B.contiguous(),
                             use_kernel=use_kernel) * grad_scale

    if prox is None:
        def prox(V, steps):
            return soft_threshold(V, steps * lam_t[:, None])

    X0 = torch.zeros((m, p), dtype=Xs.dtype, device=Xs.device) \
        if beta0 is None else beta0.to(Xs.dtype).contiguous()

    def body(carry):
        x, z, t = carry
        t_next, theta = fista_momentum(t)
        x_next = prox(z - S * grad(z), S)
        z_next = x_next + float(theta) * (x_next - x) if momentum \
            else x_next
        return x_next, z_next, t_next

    def residual(x):
        return torch.max(torch.abs(prox(x - S * grad(x), S) - x)).item()

    x, n_iters = _fista_loop(body, (X0, X0, np.float32(1.0)), iters, tol,
                             check_every, residual)
    return (x, n_iters) if return_iters else x


def debias_batched(Sigmas: torch.Tensor, cs: torch.Tensor,
                   beta_hat: torch.Tensor, Ms: torch.Tensor) -> torch.Tensor:
    """Debiased estimates (paper eq. 4) from sufficient statistics:

        b_u = b + M (c - Sigma b)        [ = b + n^-1 M X'(y - X b) ]

    Sigmas (m, p, p), cs/beta_hat (m, p), Ms (m, p, p) -> (m, p).
    """
    resid_corr = cs - torch.einsum("tij,tj->ti", Sigmas, beta_hat)
    return beta_hat + torch.einsum("tij,tj->ti", Ms, resid_corr)


def scaled_identity_m0(Sigmas: torch.Tensor) -> torch.Tensor:
    """Default M warm start: identity scaled by 1/diag(Sigma) per task
    (diagonal, so it is its own transpose in either M/C convention)."""
    m, p, _ = Sigmas.shape
    eye = torch.eye(p, dtype=Sigmas.dtype, device=Sigmas.device)
    diag = torch.diagonal(Sigmas, dim1=-2, dim2=-1)
    return eye / torch.clamp_min(diag, 1e-12)[:, None, :]


def inverse_hessian_batched(Sigmas: torch.Tensor, mu, iters: int = 600,
                            M0: torch.Tensor | None = None,
                            lam_max: torch.Tensor | None = None,
                            tol=None, check_every: int = 25,
                            return_iters: bool = False, *,
                            use_kernel: bool | None = None):
    """Approximate inverse Ms (m, p, p) of a stack of PSD covariances —
    the Javanmard-Montanari program for all tasks and all p rows as ONE
    multi-RHS batched solve (r = p, c = I). `M0` warm-starts the solve;
    default is the scaled identity. `lam_max` (m,) lets callers share
    one power iteration with the lasso solve. `tol=` makes `iters` a
    ceiling; `return_iters` also returns the iterations run.

    The engine solves for C = M' (one column per RHS); the result is
    transposed back."""
    m, p, _ = Sigmas.shape
    if lam_max is None:
        lam_max = power_iteration_batched(Sigmas)
    etas = 1.0 / torch.clamp_min(lam_max, 1e-12)
    eye = torch.eye(p, dtype=Sigmas.dtype, device=Sigmas.device)
    eye = eye.expand(m, p, p).contiguous()
    C0 = scaled_identity_m0(Sigmas) if M0 is None else M0.transpose(-1, -2)
    Cs, n_iters = solve_lasso_batched(Sigmas, eye, mu, iters=iters,
                                      etas=etas, beta0=C0,
                                      use_kernel=use_kernel, tol=tol,
                                      check_every=check_every,
                                      return_iters=True)
    out = Cs.transpose(-1, -2)
    return (out, n_iters) if return_iters else out
