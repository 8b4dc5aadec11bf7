"""Plain PyTorch version of the flash-attention forward: the port's
blockwise `models.attention_core.flash_attention` with `arange`
positions, as the reference's `kernels/flash_attention/ref.py` is its
own `attention_core` function.

It follows `attention_core`'s numerics (q·k and p·v rounded to the input
dtype before their f32 use), because that is what the reference's model
runs; the CUDA kernel follows the Pallas body, which keeps both in f32.
In f32 the two agree to about 1e-6; in bf16 they differ at bf16 level.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention_core


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        scale: float | None = None) -> torch.Tensor:
    """q: (B, S, N, H); k/v: (B, T, K, H) -> (B, S, N, H); softmax scale
    `scale` (None: 1/sqrt(H))."""
    if scale is not None:
        return flash_attention_fwd_lse_ref(q, k, v, causal=causal,
                                           window=window, scale=scale)[0]
    S, T = q.shape[1], k.shape[1]
    return attention_core.flash_attention(
        q, k, v, q_pos=torch.arange(S, device=q.device),
        k_pos=torch.arange(T, device=q.device), causal=causal, window=window)


def flash_attention_fwd_lse_ref(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *, causal: bool = True,
                                window: int = 0, scale: float | None = None
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """`flash_attention_ref` and the rows' log-sum-exp (B, N, S) float32,
    `attention_core`'s `_flash_fwd` in the standard layout."""
    S, T = q.shape[1], k.shape[1]
    return attention_core.flash_attention_with_lse(
        q, k, v, q_pos=torch.arange(S, device=q.device),
        k_pos=torch.arange(T, device=q.device), causal=causal, window=window,
        scale=scale)
