"""Blockwise (flash-style) attention forward, in plain PyTorch.

The port of the JAX package's `models/attention_core.py` forward
(`_flash_fwd`): online softmax over key blocks of 1024, O(S) memory in
the sequence instead of the (S, T) score matrix. Forward only: the custom
VJP comes with the training slice, as a `torch.autograd.Function`.

Layouts (GQA-grouped):
  q: (B, K, G, S, H)   k, v: (B, K, T, H)
Masking is positional: q_pos (S,), k_pos (T,), k_valid (T,) handle
causality, sliding windows, ring-buffer caches and padding uniformly.

It follows the reference's op order: q·k is rounded to the input dtype
before its f32 cast, masked scores are NEG_INF = -1e30, p is multiplied
by the mask (a fully masked row has exp(-1e30 - -1e30) == 1), p is cast
to v's dtype before P·V, and the output is zeroed where l == 0. This is
also the plain version of `kernels/flash_attention` (`ref.py`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

NEG_INF = -1e30


def _block_mask(q_pos, k_pos, k_valid, causal: bool, window: int):
    """(S, Tb) boolean mask for one key block."""
    m = k_valid[None, :]
    if causal:
        m = m & (k_pos[None, :] <= q_pos[:, None])
    if window:
        m = m & (k_pos[None, :] > q_pos[:, None] - window)
    return m


def _pad_to(x: torch.Tensor, mult: int, dim: int, value=0) -> torch.Tensor:
    pad = (-x.shape[dim]) % mult
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    fill = torch.full(shape, value, dtype=x.dtype, device=x.device)
    return torch.cat([x, fill], dim=dim)


def flash_attention_grouped(q, k, v, q_pos, k_pos, k_valid,
                            causal: bool = True, window: int = 0,
                            block: int = 1024) -> torch.Tensor:
    """q (B,K,G,S,H), k/v (B,K,T,H) -> (B,K,G,S,H) in q's dtype."""
    B, K, G, S, H = q.shape
    T = k.shape[2]
    blk = min(block, T)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(H)))
    f32 = torch.float32

    kp = _pad_to(k, blk, 2)
    vp = _pad_to(v, blk, 2)
    kpos = _pad_to(k_pos, blk, 0, value=-1)
    kval = _pad_to(k_valid, blk, 0, value=False)
    nb = kp.shape[2] // blk

    m = torch.full((B, K, G, S), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((B, K, G, S), dtype=f32, device=q.device)
    acc = torch.zeros((B, K, G, S, H), dtype=f32, device=q.device)
    for j in range(nb):
        sl = slice(j * blk, (j + 1) * blk)
        k_j, v_j = kp[:, :, sl], vp[:, :, sl]
        s = torch.einsum("bkgsh,bkth->bkgst", q, k_j).to(f32) * scale
        mask = _block_mask(q_pos, kpos[sl], kval[sl], causal, window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None]) * mask
        l = l * alpha + torch.sum(p, dim=-1)
        pv = torch.einsum("bkgst,bkth->bkgsh", p.to(v_j.dtype), v_j)
        acc = acc * alpha[..., None] + pv.to(f32)
        m = m_new

    safe_l = torch.clamp_min(l, 1e-30)
    out = (acc / safe_l[..., None]).to(q.dtype)
    return torch.where((l > 0)[..., None], out, torch.zeros((), dtype=q.dtype,
                                                            device=q.device))


def flash_attention(q, k, v, *, q_pos, k_pos,
                    k_valid: Optional[torch.Tensor] = None,
                    causal: bool = True, window: int = 0,
                    block: int = 1024) -> torch.Tensor:
    """Standard layout wrapper. q: (B,S,N,H), k/v: (B,T,K,H) -> (B,S,N,H)."""
    B, S, N, H = q.shape
    K = k.shape[2]
    G = N // K
    qg = q.reshape(B, S, K, G, H).permute(0, 2, 3, 1, 4)
    kt = k.transpose(1, 2)
    vt = v.transpose(1, 2)
    if k_valid is None:
        k_valid = torch.ones((k.shape[1],), dtype=torch.bool, device=q.device)
    out = flash_attention_grouped(qg, kt, vt,
                                  q_pos.to(torch.int32), k_pos.to(torch.int32),
                                  k_valid, causal, window, block)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, N, H)
