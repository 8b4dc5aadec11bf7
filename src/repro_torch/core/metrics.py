"""Evaluation metrics used in the paper's experiments (Figures 1-3)."""
from __future__ import annotations

import torch


def support_of(B: torch.Tensor, tol: float = 1e-6) -> torch.Tensor:
    """Estimated support from a (p, m) coefficient matrix (row-wise)."""
    return torch.linalg.vector_norm(B, dim=-1) > tol


def hamming(support_hat: torch.Tensor,
            support_true: torch.Tensor) -> torch.Tensor:
    """Hamming distance between supports (# of disagreeing variables)."""
    return torch.sum(support_hat != support_true)


def estimation_error(B_hat: torch.Tensor, B_true: torch.Tensor) -> torch.Tensor:
    """l1/l2 error sum_j ||Bhat_j - B_j||_2 (paper Corollary 2). (p, m) args."""
    return torch.sum(torch.linalg.vector_norm(B_hat - B_true, dim=-1))


def prediction_error(B_hat: torch.Tensor, B_true: torch.Tensor,
                     Sigma: torch.Tensor) -> torch.Tensor:
    """Population prediction risk (1/m) sum_t (b_t - b*_t)' Sigma (b_t - b*_t)."""
    D = B_hat - B_true                       # (p, m)
    return torch.mean(torch.einsum("pt,pq,qt->t", D, Sigma, D))
