"""Plain PyTorch versions of the all-tasks logistic gradient.

The batched l1-logistic FISTA loop (`core/engine.solve_logistic_lasso_
batched`) spends each iteration on

    z = X b                  (forward product)
    r = y * sigmoid(-y z)    (residual)
    g = -X' r / n            (back-projection)

for all m tasks at once: the einsum pair of the reference's oracle
(`repro/kernels/logistic_grad/ref.py`). `logistic_grad_ref` is the CPU
path of `logistic_grad` and what the fused CUDA kernel is held against on
the card; `logistic_residual_ref` (through `logistic_z_ref`) and
`logistic_backproject_ref` are the two halves the unfused kernels
compute.
"""
from __future__ import annotations

import torch


def logistic_grad_ref(Xs: torch.Tensor, ys: torch.Tensor,
                      B: torch.Tensor) -> torch.Tensor:
    """Xs (m, n, p), ys (m, n) in {-1, +1}, B (m, p) -> g (m, p) with
    g_t = -X_t'(y_t sigmoid(-y_t X_t b_t)) / n."""
    n = Xs.shape[1]
    z = torch.einsum("tnp,tp->tn", Xs, B)
    return -torch.einsum("tnp,tn->tp", Xs,
                         ys * torch.sigmoid(-ys * z)) / n


def logistic_z_ref(Xs: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """The forward half: z_t = X_t b_t. Xs (m, n, p), B (m, p) -> (m, n)."""
    return torch.einsum("tnp,tp->tn", Xs, B)


def logistic_residual_ref(Xs: torch.Tensor, ys: torch.Tensor,
                          B: torch.Tensor) -> torch.Tensor:
    """The first unfused kernel: z_t = X_t b_t, then the residual
    r_t = y_t sigmoid(-y_t z_t). Xs (m, n, p), ys (m, n), B (m, p) ->
    (m, n)."""
    z = logistic_z_ref(Xs, B)
    return ys * torch.sigmoid(-ys * z)


def logistic_backproject_ref(Xs: torch.Tensor,
                             rs: torch.Tensor) -> torch.Tensor:
    """The back-projection half: g_t = -X_t' r_t / n. Xs (m, n, p), rs
    (m, n) -> (m, p)."""
    n = Xs.shape[1]
    return -torch.einsum("tnp,tn->tp", Xs, rs) / n
