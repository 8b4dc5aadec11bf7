"""Plain PyTorch versions of the fused ISTA / FISTA step.

One proximal-gradient iteration of the lasso on precomputed sufficient
statistics (the hot loop of DSML's local solve and of the M-matrix
estimation):

    beta' = soft_threshold(beta - eta * (Sigma @ beta - c), eta * lam)

Sigma: (p, p), beta/c: (p, n_rhs); the multi-RHS form covers both the
lasso (n_rhs = 1) and the debias M-matrix (n_rhs = p) solves. The same
three functions as the reference's oracle (`repro/kernels/ista_step/
ref.py`), with its rounding order: the CPU path of the wrappers and what
the CUDA kernel is held against on the card.
"""
from __future__ import annotations

import torch


def _soft(v: torch.Tensor, tau) -> torch.Tensor:
    return torch.sign(v) * torch.clamp_min(torch.abs(v) - tau, 0.0)


def ista_step_ref(Sigma: torch.Tensor, beta: torch.Tensor, c: torch.Tensor,
                  eta: float, lam: float) -> torch.Tensor:
    grad = Sigma @ beta - c
    z = beta - eta * grad
    return _soft(z, eta * lam)


def ista_step_batched_ref(Sigmas: torch.Tensor, betas: torch.Tensor,
                          cs: torch.Tensor, etas: torch.Tensor,
                          lam) -> torch.Tensor:
    """Sigmas (m, p, p), betas/cs (m, p, r), etas (m,), lam scalar or
    per-task (m,)."""
    grad = torch.bmm(Sigmas, betas) - cs
    eta = etas.reshape(-1, 1, 1).to(betas.dtype)
    z = betas - eta * grad
    tau = eta * torch.as_tensor(lam, dtype=betas.dtype,
                                device=betas.device).reshape(-1, 1, 1)
    return _soft(z, tau)


def fista_step_batched_ref(Sigmas: torch.Tensor, zs: torch.Tensor,
                           xs: torch.Tensor, cs: torch.Tensor,
                           etas: torch.Tensor, lam, theta):
    """The ISTA prox step at the momentum point `zs` followed by the
    extrapolation against the previous iterate `xs`,

        x' = soft(z - eta (Sigma z - c), eta lam)
        z' = x' + theta (x' - x)

    Same shapes as `ista_step_batched_ref` plus xs (m, p, r) and the
    float32 scalar momentum coefficient `theta`. Returns (x_next,
    z_next)."""
    x_next = ista_step_batched_ref(Sigmas, zs, cs, etas, lam)
    z_next = x_next + float(theta) * (x_next - xs)
    return x_next, z_next


def fista_step_grid_ref(Sigmas: torch.Tensor, zs: torch.Tensor,
                        xs: torch.Tensor, cs: torch.Tensor,
                        etas: torch.Tensor, lams: torch.Tensor, theta):
    """`fista_step_batched_ref` for a lambda grid, each Sigma shared by
    its task's k problems: Sigmas (m, p, p), zs/xs (k, m, p), cs (m, p),
    etas (m,), lams (k,). The products of all k iterates are one batched
    product, Sigma_t against the (p, k) matrix of its task's iterates.
    Returns (x_next, z_next) (k, m, p)."""
    grad = torch.bmm(Sigmas, zs.permute(1, 2, 0)).permute(2, 0, 1) - cs
    eta = etas.reshape(1, -1, 1).to(zs.dtype)
    z = zs - eta * grad
    x_next = _soft(z, eta * lams.reshape(-1, 1, 1).to(zs.dtype))
    z_next = x_next + float(theta) * (x_next - xs)
    return x_next, z_next
