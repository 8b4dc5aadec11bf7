"""Multi-task classification extension of DSML (paper Section 4).

Model (paper eq. 7): y in {-1, +1}, P(y|x) = sigmoid(y * x @ beta).

  1. local l1-regularized logistic regression (FISTA),
  2. debiasing with the weighted Hessian  n^-1 X^T W X,
     W_kk = sigmoid(x_k b) * sigmoid(-x_k b),
  3. the same one-round group hard-thresholding at the master.

Every solver here is a thin wrapper over
`core/engine.solve_logistic_lasso_batched`, one batched FISTA loop whose
gradient is one launch of the fused `logistic_grad` kernel on CUDA
tensors. `dsml_logistic_fit` batches step 2 as the reference does: the m
weighted Hessians come from one weighted `sufficient_stats` (the
`rank_update` kernel) and the m M-estimations are one multi-RHS
`inverse_hessian_batched` solve (the fused FISTA step kernel).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.engine import (
    inverse_hessian_batched,
    power_iteration_batched,
    scaled_identity_m0,
    solve_logistic_lasso_batched,
    sufficient_stats,
)
from repro_torch.core.prox import (
    group_soft_threshold, prox_linf, support_from_rows,
)


def logistic_lasso(X: torch.Tensor, y: torch.Tensor, lam, iters: int = 600,
                   *, use_kernel: bool | None = None) -> torch.Tensor:
    """l1-regularized logistic regression. X: (n, p), y: (n,) in {-1, +1}.
    A batch-1 call of the engine's loop."""
    return solve_logistic_lasso_batched(X[None], y[None], lam, iters=iters,
                                        use_kernel=use_kernel)[0]


def debias_logistic_batched(Xs: torch.Tensor, ys: torch.Tensor,
                            beta_hat: torch.Tensor, mu, iters: int = 600,
                            M0: torch.Tensor | None = None,
                            M0_valid=None, *,
                            use_kernel: bool | None = None):
    """Weighted-Hessian debias (paper Section 4) for all m tasks at once.

    One weighted `sufficient_stats` builds the m Hessians n^-1 X'WX
    (W_kk = sigma(x_k b) sigma(-x_k b)), one multi-RHS
    `inverse_hessian_batched` estimates all Ms, and one batched score
    correction b + M X'(1/2(y+1) - sigma(Xb))/n debiases all tasks.
    `M0` (m, p, p) warm-starts the M solve; the bool `M0_valid` (a Python
    bool or a 0-d tensor) gates it, falling back to the scaled-identity
    start where it is false. Returns (beta_u, Ms)."""
    n = Xs.shape[1]
    zs = torch.einsum("tnp,tp->tn", Xs, beta_hat)
    ws = torch.sigmoid(zs) * torch.sigmoid(-zs)              # W_kk
    Sigma_w, _ = sufficient_stats(Xs, ys, ws, use_kernel=use_kernel)
    if M0 is not None and M0_valid is not None:
        valid = torch.as_tensor(M0_valid, device=M0.device)
        M0 = torch.where(valid, M0, scaled_identity_m0(Sigma_w))
    Ms = inverse_hessian_batched(Sigma_w, mu, iters=iters, M0=M0,
                                 use_kernel=use_kernel)
    score = (0.5 * (ys + 1.0)) - torch.sigmoid(zs)          # 1/2(y+1) - sigma(Xb)
    beta_u = beta_hat + torch.einsum(
        "tij,tj->ti", Ms, torch.einsum("tnp,tn->tp", Xs, score)) / n
    return beta_u, Ms


def debias_logistic(X: torch.Tensor, y: torch.Tensor, beta_hat: torch.Tensor,
                    mu, iters: int = 600, *,
                    use_kernel: bool | None = None) -> torch.Tensor:
    """Debiased l1-logistic estimator (paper Section 4, classification).
    A batch-1 call of `debias_logistic_batched`."""
    beta_u, _ = debias_logistic_batched(X[None], y[None], beta_hat[None],
                                        mu, iters=iters,
                                        use_kernel=use_kernel)
    return beta_u[0]


class DsmlLogisticResult(NamedTuple):
    beta_tilde: torch.Tensor   # (m, p) final filtered estimates
    beta_u: torch.Tensor       # (m, p) debiased estimates (communicated)
    support: torch.Tensor      # (p,) bool, \hat S(Lambda)
    beta_local: torch.Tensor   # (m, p) local l1-logistic estimates (step 1)


def dsml_logistic_fit(Xs: torch.Tensor, ys: torch.Tensor, lam, mu, Lam,
                      lasso_iters: int = 600, debias_iters: int = 600, *,
                      use_kernel: bool | None = None) -> DsmlLogisticResult:
    """DSML for multi-task classification. Xs: (m, n, p), ys: (m, n) in
    {-1, +1}, float32, on the device the fit runs on. `use_kernel` as in
    `kernels/common.py`: the CUDA kernels for CUDA tensors by default,
    `False` for the plain PyTorch path on any device.

    Steps 1-2 are each ONE batched engine call: the m local l1-logistic
    solves share one FISTA loop, and the m weighted-Hessian
    M-estimations share one multi-RHS lasso solve."""
    beta_hat = solve_logistic_lasso_batched(Xs, ys, lam, iters=lasso_iters,
                                            use_kernel=use_kernel)
    beta_u, _ = debias_logistic_batched(Xs, ys, beta_hat, mu,
                                        iters=debias_iters,
                                        use_kernel=use_kernel)
    support = support_from_rows(beta_u.T, Lam)
    beta_tilde = beta_u * support[None, :]
    return DsmlLogisticResult(beta_tilde, beta_u, support, beta_hat)


def _shared_step(Xs: torch.Tensor, ys: torch.Tensor, use_kernel):
    """One step size for all m tasks: the inverse Lipschitz bound of the
    1/(mn) multi-task logistic objective."""
    m = Xs.shape[0]
    Sigmas, _ = sufficient_stats(Xs, ys, use_kernel=use_kernel)
    L = 0.25 / m * torch.max(power_iteration_batched(Sigmas))
    step = 1.0 / torch.clamp_min(L, 1e-12)
    return step.expand(m).contiguous()


def group_logistic_lasso(Xs: torch.Tensor, ys: torch.Tensor, lam,
                         iters: int = 600, *,
                         use_kernel: bool | None = None) -> torch.Tensor:
    """Centralized multi-task group-lasso logistic baseline. Returns (p, m).

    The engine loop with a shared step size, the gradient scaled by 1/m,
    and the row-coupled group soft threshold as the prox."""
    m = Xs.shape[0]

    def prox(V, steps):
        return group_soft_threshold(V.T, steps[0, 0] * lam).T

    B = solve_logistic_lasso_batched(Xs, ys, lam, iters=iters,
                                     etas=_shared_step(Xs, ys, use_kernel),
                                     grad_scale=1.0 / m, prox=prox,
                                     use_kernel=use_kernel)
    return B.T


def icap_logistic(Xs: torch.Tensor, ys: torch.Tensor, lam,
                  iters: int = 600, *,
                  use_kernel: bool | None = None) -> torch.Tensor:
    """iCAP (l1/linf) multi-task logistic baseline. Returns (p, m)."""
    m = Xs.shape[0]

    def prox(V, steps):
        return prox_linf(V.T, steps[0, 0] * lam).T

    B = solve_logistic_lasso_batched(Xs, ys, lam, iters=iters,
                                     etas=_shared_step(Xs, ys, use_kernel),
                                     grad_scale=1.0 / m, prox=prox,
                                     use_kernel=use_kernel)
    return B.T


def refit_logistic_masked(X: torch.Tensor, y: torch.Tensor,
                          support: torch.Tensor, steps: int = 200, *,
                          use_kernel: bool | None = None) -> torch.Tensor:
    """Masked logistic refit by gradient descent on the support: the
    engine loop with `momentum=False` and the support mask as the prox.
    X (n, p), y (n,), support (p,) bool -> (p,)."""
    d = support.to(X.dtype)

    def prox(V, _):
        return V * d[None, :]

    return solve_logistic_lasso_batched(X[None], y[None], 0.0, iters=steps,
                                        momentum=False, prox=prox,
                                        use_kernel=use_kernel)[0]
