"""Shared transformer layers: RMSNorm, RoPE, GQA attention (full and
sliding-window) with training, prefill and single-token decode paths.

The port of the JAX package's `models/layers.py`. Functions on tensors;
parameters are plain dicts of tensors in the reference's layouts (`wq`
(d, N, H), `wk`/`wv` (d, K, H), `wo` (N, H, d); activations (B, S, N, H)).
Matmuls run in the config compute dtype; softmax and norms accumulate in
float32, in the reference's op order. Cross attention (`kv_override`,
`kv_mask` of the reference's `attention_train`) comes with the enc-dec
stack, ROADMAP queue A item 7.

The long-sequence branch of `attention_train` (S·T >= FLASH_THRESHOLD,
S > 1, no `kv_override`) runs `kernels/flash_attention`, the port of the
TPU flash kernel: the kernel on CUDA tensors, its plain version on the
CPU, as `use_kernel` says (`kernels/common.py`).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

# the module, not its function: ops.py's plain version imports
# models.attention_core, so either package may be imported first
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.config import ModelConfig

NEG_INF = -1e30
# use blockwise attention once the score matrix would exceed ~2k x 2k
FLASH_THRESHOLD = 2048 * 2048


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Statistics in f32, application in the compute dtype: the square in
    x's dtype, its mean in f32, rsqrt in f32 cast back, then
    x * inv * (1 + scale) in x's dtype, in that order."""
    dtype = x.dtype
    var = torch.mean(torch.square(x).to(torch.float32), dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(dtype)
    return x * inv * (1.0 + scale.to(dtype))


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding, halves concatenated (not interleaved), in f32.
    x: (B, S, N, H); positions: (B, S) or (S,)."""
    h = x.shape[-1]
    half = h // 2
    f32 = torch.float32
    freqs = theta ** (-torch.arange(0, half, dtype=f32, device=x.device)
                      / half)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(f32) * freqs                  # (B,S,half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].to(f32), x[..., half:].to(f32)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


class KVCache(NamedTuple):
    """Decode-time attention cache.

    k, v: (B, S_cache, K, H). For sliding-window layers, S_cache == window
    and the buffer is a ring indexed by position % window; `slot_pos`
    records the absolute position stored in each slot (-1 = empty).
    """
    k: torch.Tensor
    v: torch.Tensor
    slot_pos: torch.Tensor     # (S_cache,) int32


def init_kv_cache(batch: int, length: int, n_kv: int, head_dim: int,
                  dtype=torch.bfloat16, device="cuda") -> KVCache:
    return KVCache(
        k=torch.zeros((batch, length, n_kv, head_dim), dtype=dtype,
                      device=device),
        v=torch.zeros((batch, length, n_kv, head_dim), dtype=dtype,
                      device=device),
        slot_pos=torch.full((length,), -1, dtype=torch.int32, device=device),
    )


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B,S,N,H), k: (B,T,K,H) -> scores (B,K,G,S,T) with N = K*G; the
    product in the compute dtype, divided by sqrt(H) cast to it."""
    B, S, N, H = q.shape
    K = k.shape[2]
    G = N // K
    qg = q.reshape(B, S, K, G, H)
    root = float(torch.tensor(math.sqrt(H)).to(q.dtype))   # in q's dtype
    return torch.einsum("bskgh,btkh->bkgst", qg, k) / root


def _gqa_out(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs: (B,K,G,S,T), v: (B,T,K,H) -> (B,S,N,H)."""
    B, K, G, S, T = probs.shape
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(B, S, K * G, -1)


def _masked_softmax(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    scores = torch.where(mask, scores.to(torch.float32), NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    # rows with no valid key (fully masked) -> zeros, not NaN
    return torch.where(torch.any(mask, dim=-1, keepdim=True), probs, 0.0)


def _proj(x: torch.Tensor, w: torch.Tensor, spec: str) -> torch.Tensor:
    return torch.einsum(spec, x, w.to(x.dtype))


def _attend(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
            positions: torch.Tensor, causal: bool, window: int, use_kernel):
    """`attention_train`'s body; also returns its roped k and its v, which
    `attention_prefill` keeps as the cache (the reference computes them a
    second time, with the same result)."""
    q = rope(_proj(x, p["wq"], "bsd,dnh->bsnh"), positions, cfg.rope_theta)
    k = rope(_proj(x, p["wk"], "btd,dkh->btkh"), positions, cfg.rope_theta)
    v = _proj(x, p["wv"], "btd,dkh->btkh")

    # Long sequences: blockwise (flash) attention — O(S) memory instead of
    # materializing the (S, T) score matrix. The kernel masks by position
    # index, which is the reference's positional mask for the arange
    # positions every caller in the stack passes.
    S_q, T_k = q.shape[1], k.shape[1]
    if S_q * T_k >= FLASH_THRESHOLD and S_q > 1:
        out = flash_ops.flash_attention(q, k, v, causal=causal,
                                        window=window, use_kernel=use_kernel)
        return _proj(out, p["wo"], "bsnh,nhd->bsd"), k, v

    scores = _gqa_scores(q, k)                                  # (B,K,G,S,T)
    S, T = scores.shape[-2], scores.shape[-1]
    i = torch.arange(S, device=x.device)[:, None]
    j = torch.arange(T, device=x.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=x.device)
    if causal:
        mask &= j <= i
    if window:
        mask &= j > i - window
    probs = _masked_softmax(scores, mask).to(x.dtype)
    out = _gqa_out(probs, v)
    return _proj(out, p["wo"], "bsnh,nhd->bsd"), k, v


def attention_train(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor, causal: bool = True,
                    window: int = 0,
                    use_kernel: bool | None = None) -> torch.Tensor:
    """Full-sequence attention (training / encoder / prefill compute).

    `use_kernel` is passed to the flash kernel's wrapper on the
    long-sequence branch and changes nothing else.
    """
    return _attend(p, x, cfg, positions=positions, causal=causal,
                   window=window, use_kernel=use_kernel)[0]


def attention_prefill(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                      positions: torch.Tensor, window: int = 0,
                      cache_len: Optional[int] = None,
                      use_kernel: bool | None = None):
    """Causal attention over the prompt; returns (out, KVCache)."""
    B, S, _ = x.shape
    out, k, v = _attend(p, x, cfg, positions=positions, causal=True,
                        window=window, use_kernel=use_kernel)
    L = cache_len or S
    if window:
        L = min(L, window)
    pos1d = positions if positions.ndim == 1 else positions[0]
    if not window:
        assert L >= S, f"cache_len {L} < seq {S} needs a sliding window"
    if L >= S:
        pad = L - S
        cache = KVCache(
            k=F.pad(k, (0, 0, 0, 0, 0, pad)),
            v=F.pad(v, (0, 0, 0, 0, 0, pad)),
            slot_pos=F.pad(pos1d.to(torch.int32), (0, pad), value=-1),
        )
    else:  # ring buffer keeps the last L positions at slot pos % L
        keep = slice(S - L, S)
        kk, vv, pp = k[:, keep], v[:, keep], pos1d[keep].to(torch.int32)
        order = torch.argsort(pp % L)
        cache = KVCache(k=kk[:, order], v=vv[:, order], slot_pos=pp[order])
    return out, cache


def attention_decode(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                     position, cache: KVCache, window: int = 0):
    """Single-token decode. x: (B, 1, d); position: an int (or a one-element
    integer tensor).

    Returns (out (B,1,d), new_cache). The cache is a ring buffer when
    `window > 0` (slot = position % window), else direct-indexed. Unlike
    the reference's `dynamic_update_slice`, the new k, v and slot position
    are written into `cache`'s tensors in place (slice assignment, by a
    host integer: no copy from the host and no wait on the card), so the
    returned cache holds the same tensors and the one passed in is
    updated too. A slot past the cache raises instead of being clamped.
    """
    cdt = x.dtype
    B = x.shape[0]
    L = cache.k.shape[1]
    dev = x.device
    q = _proj(x, p["wq"], "bsd,dnh->bsnh")
    k_new = _proj(x, p["wk"], "bsd,dkh->bskh")
    v_new = _proj(x, p["wv"], "bsd,dkh->bskh")
    pos = int(position)
    pos_b = torch.full((B, 1), float(np.float32(pos)), dtype=torch.float32,
                       device=dev)
    q = rope(q, pos_b, cfg.rope_theta)
    k_new = rope(k_new, pos_b, cfg.rope_theta)

    slot = pos % L if window > 0 else pos
    if not 0 <= slot < L:
        raise IndexError(f"attention_decode: slot {slot} outside the cache "
                         f"of {L}")
    k, v, slot_pos = cache
    k[:, slot:slot + 1] = k_new
    v[:, slot:slot + 1] = v_new
    slot_pos[slot] = pos

    scores = _gqa_scores(q, k)                                   # (B,K,G,1,L)
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if window:
        valid &= slot_pos > pos - window
    probs = _masked_softmax(scores, valid[None, None, None, None, :]).to(cdt)
    out = _gqa_out(probs, v)
    out = _proj(out, p["wo"], "bsnh,nhd->bsd")
    return out, KVCache(k, v, slot_pos)


def normal(gen: torch.Generator, shape, scale: float,
           dtype) -> torch.Tensor:
    """N(0, 1) · scale drawn in f32 from `gen` on its device, cast to
    `dtype`: the reference's initialiser, not its random bits."""
    return (torch.randn(shape, generator=gen, device=gen.device)
            * scale).to(dtype)


def init_attention_params(gen: torch.Generator, cfg: ModelConfig,
                          dtype) -> dict:
    """The reference's distributions and scales: N(0, 1) · d^-1/2 for the
    input projections, N(0, 1) · (N H)^-1/2 for `wo`."""
    d, N, K = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    H = cfg.resolved_head_dim
    s = d ** -0.5
    return {
        "wq": normal(gen, (d, N, H), s, dtype),
        "wk": normal(gen, (d, K, H), s, dtype),
        "wv": normal(gen, (d, K, H), s, dtype),
        "wo": normal(gen, (N, H, d), (N * H) ** -0.5, dtype),
    }
