"""Shared transformer layers: RMSNorm, RoPE, GQA attention (full,
sliding-window, cross) with training, prefill and single-token decode
paths.

The port of the JAX package's `models/layers.py`. Functions on tensors;
parameters are plain dicts of tensors in the reference's layouts (`wq`
(d, N, H), `wk`/`wv` (d, K, H), `wo` (N, H, d); activations (B, S, N, H)).
Matmuls run in the config compute dtype; softmax and norms accumulate in
float32, in the reference's op order.

The long-sequence branch of `attention_train` (S·T >= FLASH_THRESHOLD,
S > 1, no `kv_override`) runs `kernels/flash_attention`, the port of the
TPU flash kernel: the kernel on CUDA tensors, its plain version on the
CPU, as `use_kernel` says (`kernels/common.py`), through
`flash_attention_train`: where a gradient is taken, the forward writes
its row log-sum-exp too and the backward is `attention_core`'s blockwise
one, the reference's. Cross attention
(`kv_override`) always takes the dense branch, as in the reference.
Every function here is differentiable except `attention_decode`, which
writes into its cache.

On DTensors (the sharded train step, parameters placed by
`sharding.rules`), the projections are DTensor's, the heads split over
`model`; RoPE and the attention itself (the kernel's forward with the
blockwise backward, or the dense branch) run under `local_map` on each
rank's local heads (`_on_local_heads`: where `fit_spec` replicated
`wk`/`wv`, each rank takes the kv heads of its q heads), the output
projection's partial sum is all-reduced where it joins the residual
stream, and the block input's gradient is summed over `model` once
(`sharding.place.grad_placed_as_input`).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.kernels.common import resolve_use_kernel
# the module, not its function: ops.py's plain version imports
# models.attention_core, so either package may be imported first
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import attention_core
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.place import (
    balanced, block_placements, grad_placed_as_input, on_local, placed_as,
    replicated_like, reshard, whole,
)
from repro_torch.sharding.rules import cache_placements
from repro_torch.substrate.collectives import pmax, psum_stats

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


class _FlashTrain(torch.autograd.Function):
    """The long-sequence branch with a gradient: `flash_attention_fwd_lse`
    (the kernel with its lse on CUDA tensors), `attention_core`'s plain
    blockwise backward. The backward recomputes the scores as the forward
    that ran computed them: in f32 after the kernel, rounded to the input
    dtype after the plain forward, so that exp(s − lse) is the softmax
    the forward normalised."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, use_kernel):
        kernel = resolve_use_kernel("flash_attention", use_kernel, q, k, v)
        out, lse = flash_ops.flash_attention_fwd_lse(
            q, k, v, causal=causal, window=window, use_kernel=kernel)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = dict(causal=causal, window=window, scores_f32=kernel)
        return out

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv = attention_core.flash_attention_bwd(
            *ctx.saved_tensors, dout, **ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention_train(q, k, v, *, causal: bool = True, window: int = 0,
                          use_kernel: bool | None = None) -> torch.Tensor:
    """Attention by position index over q (B,S,N,H), k/v (B,T,K,H) ->
    (B,S,N,H), differentiable in q, k and v: `kernels/flash_attention`'s
    forward (`use_kernel` as there) and the plain blockwise backward.
    Where no gradient is taken it is `flash_attention`'s call itself."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashTrain.apply(q, k, v, causal, window, use_kernel)
    return flash_ops.flash_attention(q, k, v, causal=causal, window=window,
                                     use_kernel=use_kernel)


def _attention_core(q, k, v, *, flash: bool, causal: bool, window: int,
                    use_kernel, cross: bool,
                    kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention of q (B,S,N,H) over k, v (B,T,K,H) -> (B,S,N,H): the flash
    branch, or the dense one (masked by position, or by `kv_mask` where
    `cross`)."""
    if flash:
        return flash_attention_train(q, k, v, causal=causal, window=window,
                                     use_kernel=use_kernel)
    scores = _gqa_scores(q, k)                                  # (B,K,G,S,T)
    S, T = scores.shape[-2], scores.shape[-1]
    dev = q.device
    if cross:
        mask = torch.ones((S, T), dtype=torch.bool, device=dev) \
            if kv_mask is None else kv_mask[:, None, None, None, :]
    else:
        i = torch.arange(S, device=dev)[:, None]
        j = torch.arange(T, device=dev)[None, :]
        mask = torch.ones((S, T), dtype=torch.bool, device=dev)
        if causal:
            mask &= j <= i
        if window:
            mask &= j > i - window
    probs = _masked_softmax(scores, mask).to(q.dtype)
    return _gqa_out(probs, v)


def _on_local_heads(core, q: DTensor, k: DTensor, v: DTensor) -> DTensor:
    """`core(q, k, v)` on each rank's own heads (`local_map`), for q, k, v
    DTensors on one mesh placed alike, except where q's heads are split
    (`Shard(2)`) over a mesh dim and the kv heads are whole there (a
    `wk`/`wv` that `fit_spec` replicated, K not divisible by the axis).
    Then each rank takes the kv heads of its own q heads: q head n reads
    kv head n // G (G = N / K), so rank r of that dim, holding q heads
    [r L, (r + 1) L) (L = N / M), reads kv heads [r L / G, ...), and its
    share of their gradient is partial (summed over the dim). The output
    is placed as q."""
    mesh = q.device_mesh
    qp, kp = list(q.placements), list(k.placements)
    kv_grad, split = list(kp), None
    G = q.shape[2] // k.shape[2]
    for j, (a, b) in enumerate(zip(qp, kp)):
        if a == b:
            continue
        if a != Shard(2) or not isinstance(b, Replicate):
            raise ValueError(f"attention: q placed {qp}, k placed {kp}")
        kv_grad[j], split = Partial(), j

    def local(ql, kl, vl):
        if split is not None:
            n = ql.shape[2]
            if n % G and G % n:
                raise ValueError(f"attention: {n} local q heads do not cover "
                                 f"whole kv groups of {G}")
            r = mesh.get_local_rank(split)
            lo, hi = r * n // G, ((r + 1) * n - 1) // G + 1
            kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
        return core(ql, kl, vl)

    return local_map(local, out_placements=qp, in_placements=(qp, kp, kp),
                     in_grad_placements=(qp, kv_grad, kv_grad),
                     device_mesh=mesh)(q, k, v)


def _rope(x: torch.Tensor, positions: torch.Tensor,
          theta: float) -> torch.Tensor:
    """`rope`, on each rank's local block of a DTensor: it is position-wise
    and per head, and the sequence is never split."""
    if not isinstance(x, DTensor):
        return rope(x, positions, theta)
    pl = list(x.placements)
    return local_map(rope, out_placements=pl, in_placements=(pl, None, None),
                     device_mesh=x.device_mesh)(x, positions, theta)


def _attend(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
            positions: torch.Tensor, causal: bool, window: int, use_kernel,
            kv_override: Optional[torch.Tensor] = None,
            kv_mask: Optional[torch.Tensor] = None):
    """`attention_train`'s body; also returns its k (roped unless
    `kv_override`) and its v, which `attention_prefill` keeps as the
    cache (the reference computes them a second time, with the same
    result). On DTensors (the sharded train step) the attention itself
    runs on each rank's heads (`_on_local_heads`)."""
    x = grad_placed_as_input(x)
    q = _proj(x, p["wq"], "bsd,dnh->bsnh")
    src = x if kv_override is None else \
        grad_placed_as_input(kv_override.to(x.dtype))
    k = _proj(src, p["wk"], "btd,dkh->btkh")
    v = _proj(src, p["wv"], "btd,dkh->btkh")
    if kv_override is None:
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)

    # Long sequences: blockwise (flash) attention — O(S) memory instead of
    # materializing the (S, T) score matrix. The kernel masks by position
    # index, which is the reference's positional mask for the arange
    # positions every caller in the stack passes.
    S_q, T_k = q.shape[1], k.shape[1]
    core = functools.partial(
        _attention_core,
        flash=kv_override is None and S_q * T_k >= FLASH_THRESHOLD
        and S_q > 1, causal=causal, window=window, use_kernel=use_kernel,
        cross=kv_override is not None, kv_mask=kv_mask)
    o = _on_local_heads(core, q, k, v) if isinstance(q, DTensor) \
        else core(q, k, v)
    # (B, S, N·H) @ (N·H, d): `einsum`'s own flattening of this product
    # gives DTensor a strided split it cannot propagate under fake tensors
    out = torch.matmul(o.flatten(2), p["wo"].to(x.dtype).flatten(0, 1))
    return placed_as(out, x), k, v


def attention_train(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor, causal: bool = True,
                    window: int = 0,
                    kv_override: Optional[torch.Tensor] = None,
                    kv_mask: Optional[torch.Tensor] = None,
                    use_kernel: bool | None = None) -> torch.Tensor:
    """Full-sequence attention (training / encoder / prefill compute).

    kv_override: (B, T, d) encoder output for cross-attention (then
    causal and window are ignored, no RoPE is applied, and kv_mask (B, T)
    masks padding). `use_kernel` is passed to the flash kernel's wrapper
    on the long-sequence branch and changes nothing else.
    """
    return _attend(p, x, cfg, positions=positions, causal=causal,
                   window=window, use_kernel=use_kernel,
                   kv_override=kv_override, kv_mask=kv_mask)[0]


def attention_prefill(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                      positions: torch.Tensor, window: int = 0,
                      cache_len: Optional[int] = None,
                      use_kernel: bool | None = None):
    """Causal attention over the prompt; returns (out, KVCache). On
    DTensors the cache is placed as `rules.cache_pspecs` places it: its
    sequence split over `model` where it divides (the attention's head
    split resharded through the ledger, `place.reshard`), `slot_pos`
    replicated."""
    B, S, _ = x.shape
    out, k, v = _attend(p, x, cfg, positions=positions, causal=True,
                        window=window, use_kernel=use_kernel)
    L = cache_len or S
    if window:
        L = min(L, window)
    pos1d = positions if positions.ndim == 1 else positions[0]
    if not window:
        assert L >= S, f"cache_len {L} < seq {S} needs a sliding window"
    if not isinstance(k, DTensor):
        return out, _fill_cache(k, v, pos1d, L)
    # each rank's cache of its heads over the whole sequence, then the
    # sequence split
    hk, mesh = k.placements, k.device_mesh
    kl, vl, slot_pos = _fill_cache(k.to_local(), v.to_local(), pos1d, L)
    pl = cache_placements(mesh, "k", (B, L, *k.shape[2:]), B)
    kd, vd = (reshard(DTensor.from_local(t, mesh, hk, run_check=False), pl)
              for t in (kl, vl))
    return out, KVCache(kd, vd, replicated_like(slot_pos, kd))


def _fill_cache(k: torch.Tensor, v: torch.Tensor, pos1d: torch.Tensor,
                L: int) -> KVCache:
    """The cache of L slots that the prompt's k, v (B, S, K, H) at
    positions `pos1d` leave: padded where L >= S, else a ring buffer of
    the last L positions at slot pos % L."""
    S = k.shape[1]
    if L >= S:
        pad = L - S
        return KVCache(
            k=F.pad(k, (0, 0, 0, 0, 0, pad)),
            v=F.pad(v, (0, 0, 0, 0, 0, pad)),
            slot_pos=F.pad(pos1d.to(torch.int32), (0, pad), value=-1),
        )
    keep = slice(S - L, S)
    kk, vv, pp = k[:, keep], v[:, keep], pos1d[keep].to(torch.int32)
    order = torch.argsort(pp % L)
    return KVCache(k=kk[:, order], v=vv[:, order], slot_pos=pp[order])


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
    updated too: a caller that decodes twice from one cache gives each
    decode a copy of its own. A slot past the cache raises instead of
    being clamped. On DTensors, `_attention_decode_sharded`.
    """
    pos = int(position)
    L = cache.k.shape[1]
    slot = pos % L if window > 0 else pos
    if not 0 <= slot < L:
        raise IndexError(f"attention_decode: slot {slot} outside the cache "
                         f"of {L}")
    if isinstance(x, DTensor):
        return _attention_decode_sharded(p, x, cfg, pos, slot, cache,
                                         window)
    cdt = x.dtype
    q, k_new, v_new = _decode_qkv(p, x, cfg, pos)
    k, v, slot_pos = cache
    k[:, slot:slot + 1] = k_new
    v[:, slot:slot + 1] = v_new
    slot_pos[slot] = pos

    scores = _gqa_scores(q, k)                                   # (B,K,G,1,L)
    valid = _valid_slots(slot_pos, pos, window)
    probs = _masked_softmax(scores, valid[None, None, None, None, :]).to(cdt)
    out = _gqa_out(probs, v)
    out = _proj(out, p["wo"], "bsnh,nhd->bsd")
    return out, KVCache(k, v, slot_pos)


def _decode_qkv(p: dict, x: torch.Tensor, cfg: ModelConfig, pos: int):
    """The new token's q (B,1,N,H), k and v (B,1,K,H), RoPE at `pos`
    applied to q and k (of the heads of the weights given)."""
    q = _proj(x, p["wq"], "bsd,dnh->bsnh")
    k_new = _proj(x, p["wk"], "bsd,dkh->bskh")
    v_new = _proj(x, p["wv"], "bsd,dkh->bskh")
    pos_b = torch.full((x.shape[0], 1), float(np.float32(pos)),
                       dtype=torch.float32, device=x.device)
    return (rope(q, pos_b, cfg.rope_theta),
            rope(k_new, pos_b, cfg.rope_theta), v_new)


def _valid_slots(slot_pos: torch.Tensor, pos: int,
                 window: int) -> torch.Tensor:
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if window:
        valid &= slot_pos > pos - window
    return valid


def _attention_decode_sharded(p: dict, x: DTensor, cfg: ModelConfig,
                              pos: int, slot: int, cache: KVCache,
                              window: int):
    """`attention_decode` on DTensors: x (B, 1, d) with its rows split
    over the data axes, the projections' heads over `model`, the cache's
    slots over `model` (`rules.cache_pspecs`: each rank holds L / M slots
    of every kv head) or whole where L does not divide. On each rank's
    local tensors (`place.on_local`), a split softmax:

    1. q, k and v of the new token on the rank's heads, gathered over
       `model` (`place.whole`, the ledger's all-gather: B × (N + 2K) × H
       values; a replicated `wk`/`wv` gives them whole already);
    2. the rank that holds slot `slot` writes it, in place, and every
       rank writes `slot_pos` (replicated);
    3. each rank's scores over its own slots for every head, masked as
       the reference masks them (a slot empty, ahead of `pos` or out of
       the window); their max over `model` (`pmax`), exp(s − max) where
       valid and exactly 0 elsewhere, so that a rank without a valid
       slot adds 0 and no NaN; the sum and the unnormalised output
       p · v summed over `model` (`psum_stats`), in f32;
    4. the output divided by the sum, and `wo` applied to the rank's own
       heads: a partial sum over `model`, all-reduced where it joins the
       residual stream.

    DTensor's own ops over the split cache would gather it whole, up to
    32k slots a layer."""
    mesh = x.device_mesh
    jm = mesh.mesh_dim_names.index("model")
    kpl = cache.k.placements
    L = cache.k.shape[1]
    split = kpl[jm].is_shard() and mesh.size(jm) > 1
    if split and kpl[jm] != Shard(1):
        raise ValueError(f"attention_decode: cache placed {kpl}")
    n = L // mesh.size(jm) if split else L
    lo = mesh.get_local_rank(jm) * n if split else 0
    wpl = {k: w.placements for k, w in p.items()}
    N, H = p["wq"].shape[1], p["wq"].shape[2]
    heads = balanced(N, mesh)
    wo_split = wpl["wo"][jm].is_shard()

    def local(xl, w, k, v, slot_pos):
        cdt = xl.dtype
        q, k_new, v_new = (
            whole(t, wpl[name], mesh, 2, weight_dim=1) for t, name in
            zip(_decode_qkv(w, xl, cfg, pos), ("wq", "wk", "wv")))
        if lo <= slot < lo + n:
            k[:, slot - lo:slot - lo + 1] = k_new
            v[:, slot - lo:slot - lo + 1] = v_new
        slot_pos[slot] = pos
        valid = _valid_slots(slot_pos[lo:lo + n], pos, window)
        s = torch.where(valid, _gqa_scores(q, k).to(torch.float32), NEG_INF)
        m = s.amax(dim=-1, keepdim=True)                         # (B,K,G,1,1)
        if split:
            m = pmax(m, mesh, "model")
        e = torch.where(valid, torch.exp(s - m), 0.0)
        den = e.sum(dim=-1, keepdim=True)
        o = torch.einsum("bkgst,btkh->bkgsh", e, v.to(torch.float32))
        if split:
            den = psum_stats(den, mesh, "model")
            o = psum_stats(o, mesh, "model")
        # rows with no valid slot anywhere: zeros, as `_masked_softmax`
        o = torch.where(den > 0, o / torch.clamp_min(den, 1e-30), 0.0)
        B, K, G = o.shape[:3]
        o = o.permute(0, 3, 1, 2, 4).reshape(B, 1, K * G, H).to(cdt)
        wo = w["wo"]
        if wo_split:
            o = o[:, :, heads[0]:heads[1]]
        return _proj(o, wo, "bsnh,nhd->bsd")

    out_pl = block_placements(x) if wo_split else tuple(
        q if q.is_shard() else Replicate() for q in x.placements)
    out = on_local(local, x, out_pl, x, p, cache.k, cache.v, cache.slot_pos)
    return placed_as(out, x), cache


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
