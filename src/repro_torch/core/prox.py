"""Proximal operators used by the DSML solvers.

Plain functions on tensors, on any leading batch dimensions unless
noted; the counterparts of `repro/core/prox.py`.
"""
from __future__ import annotations

import torch


def soft_threshold(v: torch.Tensor, tau) -> torch.Tensor:
    """Elementwise soft-thresholding: prox of tau*||.||_1."""
    return torch.sign(v) * torch.clamp_min(torch.abs(v) - tau, 0.0)


def group_soft_threshold(B: torch.Tensor, tau) -> torch.Tensor:
    """Row-wise group soft threshold: prox of tau * sum_j ||B_j||_2.

    B: (p, m) matrix whose rows are groups (variable j across tasks).
    """
    norms = torch.linalg.vector_norm(B, dim=-1, keepdim=True)
    scale = torch.clamp_min(1.0 - tau / torch.clamp_min(norms, 1e-30), 0.0)
    return B * scale


def group_hard_threshold(B: torch.Tensor, Lam) -> torch.Tensor:
    """Row-wise hard threshold (paper eq. (5)-(6)). B: (p, m)."""
    keep = torch.linalg.vector_norm(B, dim=-1, keepdim=True) > Lam
    return B * keep


def support_from_rows(B: torch.Tensor, Lam) -> torch.Tensor:
    """\\hat S(Lambda) = { j : ||B_j||_2 > Lambda }. B: (p, m) -> (p,) bool."""
    return torch.linalg.vector_norm(B, dim=-1) > Lam


def project_l1_ball(v: torch.Tensor, radius) -> torch.Tensor:
    """Euclidean projection of v onto the l1 ball of the given radius,
    along the last axis: the sort-based method of Duchi et al. (2008),
    with no data-dependent shapes."""
    radius = torch.as_tensor(radius, dtype=v.dtype, device=v.device)
    abs_v = torch.abs(v)
    inside = torch.sum(abs_v, dim=-1, keepdim=True) <= radius
    u = torch.sort(abs_v, dim=-1, descending=True).values
    cssv = torch.cumsum(u, dim=-1) - radius
    ar = torch.arange(1, v.shape[-1] + 1, dtype=v.dtype, device=v.device)
    cond = u - cssv / ar > 0
    rho = torch.clamp_min(torch.sum(cond, dim=-1, keepdim=True), 1)
    theta = torch.gather(cssv, -1, rho - 1) / rho.to(v.dtype)
    theta = torch.clamp_min(theta, 0.0)
    proj = torch.sign(v) * torch.clamp_min(abs_v - theta, 0.0)
    return torch.where(inside, v, proj)


def prox_linf(v: torch.Tensor, tau) -> torch.Tensor:
    """Prox of tau*||.||_inf along the last axis (used by iCAP rows).

    Moreau decomposition: prox_{tau*||.||_inf}(v) = v - P_{tau*B_1}(v).
    """
    return v - project_l1_ball(v, tau)
