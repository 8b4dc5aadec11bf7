"""Plain PyTorch version of the fused rank-n sufficient-statistics update.

    Sigma = n^-1 X' W X,    c = n^-1 X' W y     (W optional, diagonal)

for all m tasks: the einsum pair of the reference's oracle
(`repro/kernels/rank_update/ref.py`). The CPU path of `rank_update`, and
what the CUDA kernel is held against on the card.
"""
from __future__ import annotations

import torch


def rank_update_ref(Xs: torch.Tensor, ys: torch.Tensor,
                    weights: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Xs (m, n, p), ys (m, n), weights optional (m, n) ->
    Sigmas (m, p, p), cs (m, p), both normalized by n (NOT sum(w) —
    the caller owns the weighted-count convention)."""
    n = Xs.shape[1]
    Xl = Xs if weights is None else Xs * weights[..., None]
    Sigmas = torch.einsum("tni,tnj->tij", Xl, Xs) / n
    cs = torch.einsum("tni,tn->ti", Xl, ys) / n
    return Sigmas, cs
