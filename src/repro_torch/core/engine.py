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

Launch plans (`block=`): `sufficient_stats`, `solve_lasso_batched`,
`solve_lasso_grid` and `solve_logistic_lasso_batched` take an explicit
plan of their kernel's table (see the wrappers in `kernels/*/ops.py`),
which always wins and never touches the autotune cache; with
`block=None` on CUDA tensors they take the plan timed fastest on the
card for the shape (`kernels/autotune.py`), resolved once per solve;
the plain path never consults the cache. `solve_lasso_eq2`,
`solve_lasso_eq2_grid` and `inverse_hessian_batched` resolve None the
same way.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.prox import soft_threshold
from repro_torch.core.solvers import (
    fista_momentum, lasso_stats_step_scale, power_iteration,
)
from repro_torch.kernels import autotune
from repro_torch.kernels.ista_step.ops import check_block, fista_step_batched
from repro_torch.kernels.logistic_grad.ops import check_cluster, logistic_grad
from repro_torch.kernels.rank_update import ops as rank_ops
from repro_torch.kernels.rank_update.ops import rank_update


def power_iteration_batched(Sigmas: torch.Tensor,
                            iters: int = 64) -> torch.Tensor:
    """Largest eigenvalue per task of a (m, p, p) PSD stack."""
    return power_iteration(Sigmas, iters=iters)


def _on_kernel(use_kernel: bool | None, device: torch.device) -> bool:
    """Whether a call launches kernels, for the block policies: the CPU
    never does (a CPU tensor with `use_kernel=True` raises in the
    wrapper)."""
    return use_kernel is not False and device.type == "cuda"


def resolve_block_policy(m: int, p: int, r: int, dtype, block,
                         use_kernel: bool | None, device: torch.device):
    """The FISTA step's plan for a (m, p, r) solve: an explicit `block`
    (validated on every path) wins; else, where kernels launch, the
    autotuned winner for the card and shape (timed once on a miss), and
    None (the rule's plan) on the plain path."""
    if block is not None:
        check_block("resolve_block_policy", r, block)
        return block
    if not _on_kernel(use_kernel, device):
        return None
    return autotune.autotune_block(m, p, r, dtype=dtype, device=device)


def resolve_logistic_block_policy(m: int, n: int, p: int, dtype, block,
                                  use_kernel: bool | None,
                                  device: torch.device):
    """The fused logistic gradient's cluster size for a (m, n, p) batch,
    as `resolve_block_policy` resolves the FISTA step's."""
    if block is not None:
        check_cluster("resolve_logistic_block_policy", p, block)
        return block
    if not _on_kernel(use_kernel, device):
        return None
    return autotune.autotune_logistic_block(m, n, p, dtype=dtype,
                                            device=device)


def resolve_rank_block_policy(m: int, n: int, p: int, dtype, block,
                              use_kernel: bool | None, device: torch.device):
    """The rank-n update's tile for a (m, n, p) chunk, as
    `resolve_block_policy` resolves the FISTA step's."""
    if block is not None:
        rank_ops.check_block("resolve_rank_block_policy", block)
        return block
    if not _on_kernel(use_kernel, device):
        return None
    return autotune.autotune_rank_block(m, n, p, dtype=dtype, device=device)


def sufficient_stats(Xs: torch.Tensor, ys: torch.Tensor,
                     weights: torch.Tensor | None = None, *,
                     use_kernel: bool | None = None, block=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-task empirical covariance and correlation.

    Xs: (m, n, p), ys: (m, n) -> Sigmas (m, p, p), cs (m, p); optional
    per-sample `weights` (m, n), still normalized by n. One launch of
    the fused rank-n kernel (`kernels/rank_update`) on CUDA tensors, with
    `block` (an entry of RANK_TILES) or the autotuned tile.
    """
    if Xs.ndim == 3:         # else rank_update raises on the shape
        block = resolve_rank_block_policy(*Xs.shape, Xs.dtype, block,
                                          use_kernel, Xs.device)
    return rank_update(Xs, ys, weights, use_kernel=use_kernel, block=block)


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
                        use_kernel: bool | None = None, block=None,
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
    `return_iters` additionally returns the iterations run. `block` is a
    plan of the step's table (GEMV_PLANS for r = 1, GEMM_TILES for
    r > 1) or None for the autotuned one.
    """
    squeeze = cs.ndim == 2
    C = cs[..., None] if squeeze else cs
    m, p, r = C.shape
    block = resolve_block_policy(m, p, r, C.dtype, block, use_kernel,
                                 C.device)
    if etas is None:
        etas = 1.0 / torch.clamp_min(power_iteration_batched(Sigmas), 1e-12)
    etas = torch.as_tensor(etas, dtype=C.dtype, device=C.device)
    etas = etas.reshape(-1).expand(m).contiguous()
    lams = torch.as_tensor(lam, dtype=C.dtype, device=C.device)
    lams = lams.reshape(-1).expand(m).contiguous()

    def step(Z, X, theta):
        return fista_step_batched(Sigmas, Z, X, C, etas, lams, theta,
                                  use_kernel=use_kernel, block=block)

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


def solve_lasso_grid(Sigmas: torch.Tensor, cs: torch.Tensor, lams, *,
                     iters: int = 400, etas: torch.Tensor | None = None,
                     use_kernel: bool | None = None,
                     block=None) -> torch.Tensor:
    """Solve every (task, lambda) pair of a tuning grid in ONE batch.

    Sigmas (m, p, p), cs (m, p), lams (k,) -> (k, m, p). The engine takes
    per-task regularization weights, so a lambda grid is k*m tasks
    sharing tiled statistics: Sigma, c and the step sizes are tiled k
    times and each lambda repeated per task, and the whole sweep is one
    `solve_lasso_batched` of `iters` steps (on CUDA tensors, one launch of
    the fused FISTA kernel over the k*m tasks per step). Step sizes
    depend only on Sigma and are shared across the grid; default
    1/lambda_max per task. `block` (a GEMV_PLANS entry, or None for the
    autotuned plan of the k*m-task solve) is resolved once."""
    m, p = cs.shape
    lams = torch.as_tensor(lams, dtype=cs.dtype, device=cs.device)
    lams = lams.reshape(-1)
    k = lams.shape[0]
    block = resolve_block_policy(k * m, p, 1, cs.dtype, block, use_kernel,
                                 cs.device)
    if etas is None:
        etas = 1.0 / torch.clamp_min(power_iteration_batched(Sigmas), 1e-12)
    etas = torch.as_tensor(etas, dtype=cs.dtype, device=cs.device)
    B = solve_lasso_batched(Sigmas.repeat(k, 1, 1), cs.repeat(k, 1),
                            lams.repeat_interleave(m), iters=iters,
                            etas=etas.reshape(-1).repeat(k),
                            use_kernel=use_kernel, block=block,
                            check_every=25)
    return B.reshape(k, m, p)


def solve_lasso_eq2_grid(Sigmas: torch.Tensor, cs: torch.Tensor, lams, *,
                         iters: int = 400,
                         use_kernel: bool | None = None) -> torch.Tensor:
    """`solve_lasso_grid` in the paper's eq.-2 convention (see
    `solve_lasso_eq2`: step 2/max(2*lambda_max, eps), threshold weight
    lam/2). Sigmas (m, p, p), cs (m, p), lams (k,) -> (k, m, p)."""
    lams = torch.as_tensor(lams, dtype=cs.dtype, device=cs.device)
    return solve_lasso_grid(Sigmas, cs, 0.5 * lams, iters=iters,
                            etas=lasso_stats_step_scale(Sigmas),
                            use_kernel=use_kernel)


def solve_logistic_lasso_batched(Xs: torch.Tensor, ys: torch.Tensor, lam, *,
                                 iters: int = 600,
                                 etas: torch.Tensor | None = None,
                                 beta0: torch.Tensor | None = None,
                                 grad_scale=1.0, prox=None,
                                 momentum: bool = True, tol=None,
                                 check_every: int = 25,
                                 use_kernel: bool | None = None,
                                 block=None,
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
    iterations run, as in `solve_lasso_batched`. `block` is the fused
    gradient's cluster size (`logistic_grad.ops.check_cluster`) or None
    for the autotuned one.
    """
    m, n, p = Xs.shape
    block = resolve_logistic_block_policy(m, n, p, Xs.dtype, block,
                                          use_kernel, Xs.device)
    lam_t = torch.as_tensor(lam, dtype=Xs.dtype, device=Xs.device)
    lam_t = lam_t.reshape(-1).expand(m)
    if etas is None:
        Sigmas, _ = sufficient_stats(Xs, ys, use_kernel=use_kernel)
        L = 0.25 * power_iteration_batched(Sigmas)
        etas = 1.0 / torch.clamp_min(L, 1e-12)
    S = torch.as_tensor(etas, dtype=Xs.dtype, device=Xs.device)
    S = S.reshape(-1).expand(m)[:, None]

    # x * 1.0 is x bit for bit: at the default scale the gradient is the
    # kernel's output, with no elementwise launch after it
    unit_scale = not isinstance(grad_scale, torch.Tensor) \
        and float(grad_scale) == 1.0

    def grad(B):
        # a transposing prox (group lasso, iCAP) leaves strided iterates;
        # the kernel takes contiguous ones
        g = logistic_grad(Xs, ys, B.contiguous(), use_kernel=use_kernel,
                          block=block)
        return g if unit_scale else g * grad_scale

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
