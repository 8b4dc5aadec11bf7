"""FISTA solvers for the local lasso, group lasso and iCAP estimators,
and their building blocks.

The paper's objectives:

  lasso (eq. 2):        (1/n)||y_t - X_t b||^2 + lambda_t ||b||_1
  multi-task (eq. 3):   (1/(mn)) sum_t ||y_t - X_t b_t||^2 + lambda*pen(B)
      pen = sum_j ||B_j||_2      (group lasso)
      pen = sum_j max_t |B_tj|   (iCAP)

Every solver runs a fixed iteration budget with the Lipschitz constant
from power iteration on the empirical covariance, as the reference does
(`repro/core/solvers.py`). The FISTA scalar t stays a float32 host
number, as the reference's loop carries it: with a Python double the
momentum coefficients drift from the reference's, and a device scalar
read back every iteration would synchronise the loop.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.prox import group_soft_threshold, prox_linf

_HALF, _ONE, _FOUR = np.float32(0.5), np.float32(1.0), np.float32(4.0)


def fista_momentum(t: np.float32) -> tuple[np.float32, np.float32]:
    """One step of FISTA's scalar schedule in float32: returns (t_next,
    theta) with t_next = (1 + sqrt(1 + 4 t^2)) / 2 and theta =
    (t - 1) / t_next."""
    t_next = _HALF * (_ONE + np.sqrt(_ONE + _FOUR * t * t))
    return t_next, (t - _ONE) / t_next


def power_iteration(S: torch.Tensor, iters: int = 64) -> torch.Tensor:
    """Largest eigenvalue of a PSD matrix S (..., p, p) via power
    iteration: 64 fixed iterations from the flat unit vector. Batched
    over any leading dimensions."""
    p = S.shape[-1]
    v = torch.full(S.shape[:-1], float(_ONE / np.sqrt(np.float32(p))),
                   dtype=S.dtype, device=S.device)
    for _ in range(iters):
        w = (S @ v[..., None])[..., 0]
        norm = torch.linalg.vector_norm(w, dim=-1, keepdim=True)
        v = w / torch.clamp_min(norm, 1e-30)
    return torch.sum(v * (S @ v[..., None])[..., 0], dim=-1)


def fista(grad_fn, prox_fn, x0: torch.Tensor, step, iters: int) -> torch.Tensor:
    """Generic FISTA: min f(x) + g(x), grad_fn = grad f, prox_fn(v, step)."""
    x, z, t = x0, x0, np.float32(1.0)
    for _ in range(iters):
        x_next = prox_fn(z - step * grad_fn(z), step)
        t, theta = fista_momentum(t)
        z = x_next + float(theta) * (x_next - x)
        x = x_next
    return x


def lasso_stats_step_scale(Sigma: torch.Tensor) -> torch.Tensor:
    """Step size for the eq.-2 lasso in the engine's normalized gradient
    convention g = Sigma b - c. The objective's gradient is 2(Sigma b - c)
    with Lipschitz constant 2*lambda_max, so the engine step is
    2 * 1/max(2*lambda_max, eps) and the engine threshold weight is
    lam/2 (eta * lam/2 == step * lam of the unnormalized iteration).
    Batched over leading dimensions."""
    L = 2.0 * power_iteration(Sigma)
    return 2.0 / torch.clamp_min(L, 1e-12)


def lasso(X: torch.Tensor, y: torch.Tensor, lam, iters: int = 400, *,
          use_kernel: bool | None = None) -> torch.Tensor:
    """Local lasso (paper eq. 2). X: (n, p), y: (n,). Returns (p,).

    A batch-1 call of the engine's `solve_lasso_eq2`."""
    from repro_torch.core.engine import solve_lasso_eq2
    n = X.shape[0]
    Sigma = (X.T @ X) / n
    c = (X.T @ y) / n
    return solve_lasso_eq2(Sigma[None], c[None], lam,
                           iters=iters, use_kernel=use_kernel)[0]


def multitask_loss_grad(Xs: torch.Tensor, ys: torch.Tensor, *,
                        use_kernel: bool | None = None):
    """The eq.-3 loss (1/(mn)) sum_t ||y_t - X_t b_t||^2 on sufficient
    statistics: returns (grad, step), grad(B (p, m)) -> (p, m) and the
    step 1/max(2/m max_t lambda_max(Sigma_t), 1e-12). `use_kernel`
    reaches `sufficient_stats` (the rank-n update kernel on CUDA
    tensors); the gradient is plain PyTorch, as the reference leaves it
    to XLA."""
    from repro_torch.core.engine import sufficient_stats
    m = Xs.shape[0]
    Sigmas, cs = sufficient_stats(Xs, ys, use_kernel=use_kernel)
    L = 2.0 / m * torch.max(power_iteration(Sigmas))
    step = 1.0 / torch.clamp_min(L, 1e-12)

    def grad(B):
        return (2.0 / m) * (torch.einsum("tij,jt->it", Sigmas, B) - cs.T)

    return grad, step


def _multitask_fista(Xs: torch.Tensor, ys: torch.Tensor, prox, iters: int,
                     use_kernel: bool | None) -> torch.Tensor:
    """FISTA on the eq.-3 loss with the row penalty's `prox(V, step)`,
    from zero. Returns B (p, m)."""
    m, _, p = Xs.shape
    grad, step = multitask_loss_grad(Xs, ys, use_kernel=use_kernel)
    return fista(grad, prox, torch.zeros((p, m), dtype=Xs.dtype,
                                         device=Xs.device), step, iters)


def group_lasso(Xs: torch.Tensor, ys: torch.Tensor, lam, iters: int = 400,
                *, use_kernel: bool | None = None) -> torch.Tensor:
    """Centralized multi-task group lasso (eq. 3 with l1/l2 penalty).

    Xs: (m, n, p), ys: (m, n). Returns B: (p, m) (rows = variables).
    `use_kernel` as in `multitask_loss_grad`."""
    return _multitask_fista(
        Xs, ys, lambda V, s: group_soft_threshold(V, s * lam), iters,
        use_kernel)


def icap(Xs: torch.Tensor, ys: torch.Tensor, lam, iters: int = 400, *,
         use_kernel: bool | None = None) -> torch.Tensor:
    """iCAP estimator: l1/linf composite penalty (Zhao et al., 2009).
    Same arguments and result as `group_lasso`."""
    return _multitask_fista(
        Xs, ys, lambda V, s: prox_linf(V, s * lam), iters, use_kernel)


def refit_ols_masked_stats(S: torch.Tensor, c: torch.Tensor,
                           support: torch.Tensor) -> torch.Tensor:
    """OLS refit on sufficient statistics (S = X'X/n, c = X'y/n),
    restricted to `support` (bool (p,)), by masking. S (p, p), c (p,):
    one task, as in the reference (dsml_fit maps it over the tasks).

    Solves the masked normal equations:
        (D S D + (I - D)) b = D c,   D = diag(support)
    which equals OLS on the support columns and 0 elsewhere.
    """
    p = S.shape[-1]
    d = support.to(S.dtype)
    A = d[:, None] * S * d[None, :] + torch.diag(1.0 - d)
    A = A + 1e-8 * torch.eye(p, dtype=S.dtype, device=S.device)
    return torch.linalg.solve(A, d * c)


def refit_ols_masked(X: torch.Tensor, y: torch.Tensor,
                     support: torch.Tensor) -> torch.Tensor:
    """OLS refit restricted to `support` from raw samples."""
    n = X.shape[0]
    return refit_ols_masked_stats((X.T @ X) / n, (X.T @ y) / n, support)
