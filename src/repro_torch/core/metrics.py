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


def classification_error(B_hat: torch.Tensor, Xs: torch.Tensor,
                         ys: torch.Tensor) -> torch.Tensor:
    """Average 0/1 error on held-out data. B_hat (p, m), Xs (m, n, p),
    ys (m, n) in {-1, 1}."""
    logits = torch.einsum("tnp,pt->tn", Xs, B_hat)
    return torch.mean((torch.sign(logits) != ys).to(Xs.dtype))
