"""Blockwise (flash-style) attention with its backward, in plain PyTorch.

The port of the JAX package's `models/attention_core.py`: online softmax
over key blocks of 1024, O(S) memory in the sequence instead of the
(S, T) score matrix, and the Flash-2-style backward that recomputes the
scores block by block from the saved (out, lse). The reference's
`jax.custom_vjp` becomes `torch.autograd.Function`s:

* `flash_attention_grouped` / `flash_attention` (the reference's
  signatures, `block` included): plain forward (`_flash_fwd`) and plain
  backward (`_flash_bwd`);
* `flash_attention_with_lse` and `flash_attention_bwd`, the forward and
  the backward alone in the standard layout. The model's long-sequence
  branch (`layers.flash_attention_train`) pairs the CUDA kernel's
  forward with this backward.

Layouts (GQA-grouped):
  q: (B, K, G, S, H)   k, v: (B, K, T, H)
Masking is positional: q_pos (S,), k_pos (T,), k_valid (T,) handle
causality, sliding windows, ring-buffer caches and padding uniformly.

It follows the reference's op order: q·k is rounded to the input dtype
before its f32 cast, masked scores are NEG_INF = -1e30, p is multiplied
by the mask (a fully masked row has exp(-1e30 - -1e30) == 1), p is cast
to v's dtype before P·V, the output is zeroed where l == 0, and lse =
m + log(max(l, 1e-30)). The backward: D = Σ dout·out in f32, p =
exp(s − lse)·mask, ds = p (dp − D)·scale, dq summed over the key blocks
in order in f32, dk and dv per block. The reference scans the key
blocks twice (dq, then dk/dv) with the same block terms; here one loop
computes each block's terms once for both, which gives the same values.
After a forward that kept q·k in f32 (the CUDA kernel), the backward
recomputes it in f32 too (`scores_f32`): p = exp(s − lse) is then the
softmax whose lse it was given. This module is plain PyTorch alone; it
is also the plain version of `kernels/flash_attention` (`ref.py`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

NEG_INF = -1e30
BLOCK = 1024


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


def _scale(h: int) -> float:
    return float(np.float32(1.0) / np.sqrt(np.float32(h)))


def _key_blocks(k, v, k_pos, k_valid, block: int):
    """(blk, nb, k, v, k_pos, k_valid) padded to whole blocks of keys."""
    blk = min(block, k.shape[2])
    kp = _pad_to(k, blk, 2)
    return (blk, kp.shape[2] // blk, kp, _pad_to(v, blk, 2),
            _pad_to(k_pos, blk, 0, value=-1),
            _pad_to(k_valid, blk, 0, value=False))


def _flash_fwd(q, k, v, q_pos, k_pos, k_valid, causal: bool, window: int,
               block: int):
    """(out (B,K,G,S,H) in q's dtype, lse (B,K,G,S) f32)."""
    B, K, G, S, H = q.shape
    scale = _scale(H)
    f32 = torch.float32
    blk, nb, kp, vp, kpos, kval = _key_blocks(k, v, k_pos, k_valid, block)

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
    out = torch.where((l > 0)[..., None], out,
                      torch.zeros((), dtype=q.dtype, device=q.device))
    return out, m + torch.log(safe_l)


def _flash_bwd(q, k, v, q_pos, k_pos, k_valid, out, lse, dout,
               causal: bool, window: int, block: int, *,
               scores_f32: bool = False):
    """(dq, dk, dv) in the dtypes of q, k, v, grouped layout. The scores
    are recomputed as `_flash_fwd` computes them (q·k rounded to the input
    dtype), or with `scores_f32` from q and k upcast to f32."""
    with torch.profiler.record_function("attention_core._flash_bwd"):
        B, K, G, S, H = q.shape
        T = k.shape[2]
        scale = _scale(H)
        f32 = torch.float32
        blk, nb, kp, vp, kpos, kval = _key_blocks(k, v, k_pos, k_valid,
                                                  block)
        D = torch.sum(dout.to(f32) * out.to(f32), dim=-1)        # (B,K,G,S)
        # the operands of the score products
        qs, ks = (q.to(f32), kp.to(f32)) if scores_f32 else (q, kp)

        dq = torch.zeros((B, K, G, S, H), dtype=f32, device=q.device)
        dks, dvs = [], []
        for j in range(nb):
            sl = slice(j * blk, (j + 1) * blk)
            k_j, v_j = kp[:, :, sl], vp[:, :, sl]
            s = torch.einsum("bkgsh,bkth->bkgst", qs,
                             ks[:, :, sl]).to(f32) * scale
            mask = _block_mask(q_pos, kpos[sl], kval[sl], causal, window)
            s = torch.where(mask, s, NEG_INF)
            p = torch.exp(s - lse[..., None]) * mask           # (B,K,G,S,Tb)
            dp = torch.einsum("bkgsh,bkth->bkgst", dout, v_j).to(f32)
            ds = p * (dp - D[..., None]) * scale
            dq = dq + torch.einsum("bkgst,bkth->bkgsh", ds.to(k.dtype),
                                   k_j).to(f32)
            dks.append(torch.einsum("bkgst,bkgsh->bkth", ds.to(q.dtype), q))
            dvs.append(torch.einsum("bkgst,bkgsh->bkth", p.to(dout.dtype),
                                    dout))
        dk = torch.cat(dks, dim=2)[:, :, :T]
        dv = torch.cat(dvs, dim=2)[:, :, :T]
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashGrouped(torch.autograd.Function):
    """The reference's `flash_attention_grouped` custom VJP: plain forward
    with its lse, plain blockwise backward."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, k_valid, causal, window, block):
        out, lse = _flash_fwd(q, k, v, q_pos, k_pos, k_valid, causal, window,
                              block)
        ctx.save_for_backward(q, k, v, q_pos, k_pos, k_valid, out, lse)
        ctx.args = (causal, window, block)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_pos, k_pos, k_valid, out, lse = ctx.saved_tensors
        causal, window, block = ctx.args
        dq, dk, dv = _flash_bwd(q, k, v, q_pos, k_pos, k_valid, out, lse,
                                dout, causal, window, block)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_grouped(q, k, v, q_pos, k_pos, k_valid,
                            causal: bool = True, window: int = 0,
                            block: int = BLOCK) -> torch.Tensor:
    """q (B,K,G,S,H), k/v (B,K,T,H) -> (B,K,G,S,H) in q's dtype;
    differentiable in q, k and v."""
    return _FlashGrouped.apply(q, k, v, q_pos, k_pos, k_valid, causal,
                               window, block)


def _grouped(q, k, v):
    """Standard layout -> the grouped one: q (B,S,N,H) -> (B,K,G,S,H),
    k/v (B,T,K,H) -> (B,K,T,H)."""
    B, S, N, H = q.shape
    K = k.shape[2]
    qg = q.reshape(B, S, K, N // K, H).permute(0, 2, 3, 1, 4)
    return qg, k.transpose(1, 2), v.transpose(1, 2)


def _standard(xg):
    """(B,K,G,S,H) -> (B,S,N,H)."""
    B, K, G, S, H = xg.shape
    return xg.permute(0, 3, 1, 2, 4).reshape(B, S, K * G, H)


def _positions(q, k, q_pos, k_pos, k_valid):
    if k_valid is None:
        k_valid = torch.ones((k.shape[1],), dtype=torch.bool, device=q.device)
    return q_pos.to(torch.int32), k_pos.to(torch.int32), k_valid


def flash_attention(q, k, v, *, q_pos, k_pos,
                    k_valid: Optional[torch.Tensor] = None,
                    causal: bool = True, window: int = 0,
                    block: int = BLOCK) -> torch.Tensor:
    """Standard layout wrapper. q: (B,S,N,H), k/v: (B,T,K,H) -> (B,S,N,H)."""
    out = flash_attention_grouped(*_grouped(q, k, v),
                                  *_positions(q, k, q_pos, k_pos, k_valid),
                                  causal, window, block)
    return _standard(out)


def flash_attention_with_lse(q, k, v, *, q_pos, k_pos,
                             k_valid: Optional[torch.Tensor] = None,
                             causal: bool = True, window: int = 0,
                             block: int = BLOCK):
    """The forward alone, standard layout: (out (B,S,N,H), lse (B,N,S)
    f32), no gradient."""
    B, S, N, _ = q.shape
    out, lse = _flash_fwd(*_grouped(q, k, v),
                          *_positions(q, k, q_pos, k_pos, k_valid),
                          causal, window, block)
    return _standard(out), lse.reshape(B, N, S)


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool,
                        window: int, scores_f32: bool):
    """`_flash_bwd` in the standard layout, positions by index: q, out,
    dout (B,S,N,H), k, v (B,T,K,H), lse (B,N,S) f32 -> (dq, dk, dv) in
    the layouts of q, k, v. `scores_f32` recomputes q·k in f32 instead of
    rounding it to the input dtype first: the scores of a forward that
    kept them in f32 (the CUDA kernel's), which its lse normalises."""
    B, S, N, _ = q.shape
    T, K = k.shape[1], k.shape[2]
    qg, kg, vg = _grouped(q, k, v)
    q_pos = torch.arange(S, dtype=torch.int32, device=q.device)
    k_pos = torch.arange(T, dtype=torch.int32, device=q.device)
    k_valid = torch.ones((T,), dtype=torch.bool, device=q.device)
    dq, dk, dv = _flash_bwd(qg, kg, vg, q_pos, k_pos, k_valid,
                            _grouped(out, k, v)[0],
                            lse.reshape(B, K, N // K, S),
                            _grouped(dout, k, v)[0], causal, window, BLOCK,
                            scores_f32=scores_f32)
    return _standard(dq), dk.transpose(1, 2), dv.transpose(1, 2)
