"""The "dirty model" baseline (Jalali et al., 2010), used by the paper's
real-data comparison: B = S + E with S row-sparse (shared support,
l1/linf penalty) and E elementwise-sparse (task-private deviations).

    min (1/(mn)) sum_t ||y_t - X_t (s_t + e_t)||^2
        + lam_s * sum_j max_t |S_tj| + lam_e * ||E||_1

Solved by proximal BLOCK-coordinate descent: alternate proximal gradient
steps on S (row-linf prox) and E (soft threshold).
"""
from __future__ import annotations

import torch

from repro_torch.core.prox import prox_linf, soft_threshold
from repro_torch.core.solvers import multitask_loss_grad


def dirty_model(Xs: torch.Tensor, ys: torch.Tensor, lam_s, lam_e,
                iters: int = 400, *, use_kernel: bool | None = None):
    """Xs: (m, n, p); ys: (m, n). Returns (B, S, E), each (p, m).
    `use_kernel` as in `core.solvers.multitask_loss_grad`; the reference
    computes the same statistics with the einsum pair that is
    `sufficient_stats`' plain version."""
    m, _, p = Xs.shape
    grad, step = multitask_loss_grad(Xs, ys, use_kernel=use_kernel)
    S = torch.zeros((p, m), dtype=Xs.dtype, device=Xs.device)
    E = S
    for _ in range(iters):
        g = grad(S + E)
        S = prox_linf(S - step * g, step * lam_s)
        g = grad(S + E)
        E = soft_threshold(E - step * g, step * lam_e)
    return S + E, S, E
