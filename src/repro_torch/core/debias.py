"""Debiased lasso (Javanmard-Montanari style) used by DSML step 2.

The paper (Section 4) constructs M_t row-wise:

    m_tj = argmin m^T Sigma_hat m   s.t.  ||Sigma_hat m - e_j||_inf <= mu

As the reference does (`repro/core/debias.py`), the port solves the
*penalized* equivalent for all p rows at once, as one multi-RHS lasso
with c = I:

    M = argmin_M  (1/2) tr(M Sigma_hat M^T) - tr(M) + mu ||M||_1

Both entry points are batch-1 calls of the batched engine.
"""
from __future__ import annotations

import torch

from repro_torch.core.engine import (
    debias_batched, inverse_hessian_batched, sufficient_stats,
)


def inverse_hessian_m(Sigma: torch.Tensor, mu, iters: int = 600, *,
                      use_kernel: bool | None = None) -> torch.Tensor:
    """Approximate inverse M (p x p, row j ~= m_tj) of a PSD covariance."""
    return inverse_hessian_batched(Sigma[None], mu, iters=iters,
                                   use_kernel=use_kernel)[0]


def debias_lasso(X: torch.Tensor, y: torch.Tensor, beta_hat: torch.Tensor,
                 mu, iters: int = 600, *,
                 use_kernel: bool | None = None) -> torch.Tensor:
    """Debiased estimator (paper eq. 4): b^u = b + n^-1 M X^T (y - X b)."""
    Sigmas, cs = sufficient_stats(X[None], y[None], use_kernel=use_kernel)
    M = inverse_hessian_batched(Sigmas, mu, iters=iters,
                                use_kernel=use_kernel)
    return debias_batched(Sigmas, cs, beta_hat[None], M)[0]


def coherence(Sigma: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """Generalized coherence mu(X, M) = max_j ||Sigma m_j - e_j||_inf."""
    p = Sigma.shape[0]
    R = M @ Sigma - torch.eye(p, dtype=Sigma.dtype, device=Sigma.device)
    return torch.max(torch.abs(R))
