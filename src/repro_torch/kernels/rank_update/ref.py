"""Plain PyTorch version of the rank-n sufficient-statistics update.

    Sigma = n^-1 X' W X,    c = n^-1 X' W y     (W optional, diagonal)

for all m tasks: the einsum pair of the reference's oracle
(`repro/kernels/rank_update/ref.py`), one function per half so that the
two dispatches of the unfused kernel pair each have their own. The CPU
path of `rank_update` and `rank_update_unfused`, and what the CUDA kernels
are held against on the card.
"""
from __future__ import annotations

import torch


def _weighted(Xs: torch.Tensor, weights: torch.Tensor | None) -> torch.Tensor:
    return Xs if weights is None else Xs * weights[..., None]


def rank_sigma_ref(Xs: torch.Tensor,
                   weights: torch.Tensor | None = None) -> torch.Tensor:
    """Xs (m, n, p), weights optional (m, n) -> Sigmas (m, p, p)."""
    return torch.einsum("tni,tnj->tij", _weighted(Xs, weights),
                        Xs) / Xs.shape[1]


def rank_c_ref(Xs: torch.Tensor, ys: torch.Tensor,
               weights: torch.Tensor | None = None) -> torch.Tensor:
    """Xs (m, n, p), ys (m, n), weights optional (m, n) -> cs (m, p)."""
    return torch.einsum("tni,tn->ti", _weighted(Xs, weights),
                        ys) / Xs.shape[1]


def rank_update_ref(Xs: torch.Tensor, ys: torch.Tensor,
                    weights: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Xs (m, n, p), ys (m, n), weights optional (m, n) ->
    Sigmas (m, p, p), cs (m, p), both normalized by n (NOT sum(w) —
    the caller owns the weighted-count convention)."""
    return rank_sigma_ref(Xs, weights), rank_c_ref(Xs, ys, weights)
