"""Mamba-2 SSD (state-space duality) layer, arXiv:2405.21060.

The port of the JAX package's `models/ssd.py`. Training/prefill uses the
chunked SSD algorithm: the sequence is split into chunks of length Q;
within-chunk terms are computed as masked "attention-like" einsums (the
dual quadratic form), and chunk-boundary states are carried by a loop
over the chunks (the reference's `lax.scan`) — O(L) overall with
matmul-dominated inner work. The casts follow the reference's: the
decays and the carried state in float32, the products in the compute
dtype.

Decode carries the (B, H, P, N) SSM state and a depthwise-conv window,
and returns a new cache.

On DTensors (the sharded train step) the block is head parallel over
`model` (`_ssd_block_sharded`).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import normal
from repro_torch.models.rglru import _causal_depthwise_conv
from repro_torch.sharding.place import (
    balanced, block, block_placements, channel_split, grad_placed_as_input,
    on_local, placed_as, reshard, rows_placements, whole,
)
from repro_torch.sharding.rules import cache_placements


class SsdCache(NamedTuple):
    state: torch.Tensor      # (B, H, P, N) float32
    conv: torch.Tensor       # (B, k-1, conv_dim)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """Stable segment-sum: out[..., i, j] = sum_{j < k <= i} a[..., k].

    a: (..., Q) -> (..., Q, Q), -inf above the diagonal (masked before
    the caller's exp)."""
    Q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    i = torch.arange(Q, device=a.device)
    mask = i[:, None] >= i[None, :]
    return torch.where(mask, diff, -math.inf)


def ssd_chunked(x: torch.Tensor, dtA: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, chunk: int,
                init_state: torch.Tensor | None = None):
    """SSD core. x: (b, l, h, p) [already multiplied by dt], dtA: (b, l, h),
    B, C: (b, l, h, n) (groups pre-broadcast to heads). Returns (y,
    final_state)."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    orig_l = l
    if l % chunk:                       # pad to a chunk multiple; dtA = 0 and
        pad = chunk - l % chunk         # B = 0 on padding leaves state exact
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dtA = F.pad(dtA, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
        l = x.shape[1]
    c = l // chunk
    f32 = torch.float32

    xr = x.reshape(b, c, chunk, h, p)
    Ar = dtA.reshape(b, c, chunk, h).to(f32)
    Br = B.reshape(b, c, chunk, h, n)
    Cr = C.reshape(b, c, chunk, h, n)

    A_cum = torch.cumsum(Ar, dim=2)                              # (b,c,q,h)
    # ---- intra-chunk (dual quadratic form) ----
    L = torch.exp(_segsum(Ar.permute(0, 1, 3, 2)))               # (b,c,h,q,q)
    scores = torch.einsum("bcqhn,bckhn->bchqk", Cr, Br)          # (b,c,h,q,k)
    y_diag = torch.einsum("bchqk,bckhp->bcqhp",
                          (scores * L).to(x.dtype), xr)

    # ---- chunk states ----
    decay_states = torch.exp(A_cum[:, :, -1:, :] - A_cum)        # (b,c,q,h)
    states = torch.einsum("bcqhn,bcqh,bcqhp->bchpn", Br,
                          decay_states.to(x.dtype), xr)          # (b,c,h,p,n)

    # ---- inter-chunk recurrence (sequential over chunks) ----
    chunk_decay = torch.exp(A_cum[:, :, -1, :]).to(f32)          # (b,c,h)
    carry = torch.zeros((b, h, p, n), dtype=f32, device=x.device) \
        if init_state is None else init_state
    prev = []
    for j in range(c):                  # emit the state BEFORE chunk j
        prev.append(carry)
        carry = carry * chunk_decay[:, j, :, None, None] \
            + states[:, j].to(f32)
    prev_states = torch.stack(prev, dim=1)                       # (b,c,h,p,n)

    # ---- inter-chunk output ----
    state_decay = torch.exp(A_cum).to(x.dtype)                   # (b,c,q,h)
    y_off = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", Cr,
                         prev_states.to(x.dtype), state_decay)
    y = (y_diag + y_off).reshape(b, l, h, p)
    return y[:, :orig_l], carry


def _split_proj(p: dict, x: torch.Tensor, cfg: ModelConfig):
    sc = cfg.ssd
    d_in = sc.n_heads * sc.head_dim
    gn = sc.n_groups * sc.state_dim
    zxbcdt = torch.einsum("bsd,de->bse", x, p["w_in"].to(x.dtype))
    return torch.split(zxbcdt, [d_in, d_in, gn, gn, sc.n_heads], dim=-1)


def _prep(p: dict, xin, Bc, Cc, dt, cfg: ModelConfig, heads=None):
    """The scan's inputs for heads [lo, hi) (`heads`; all H where None),
    whose x, dt, `dt_bias` and `A_log` are given, B and C for every
    group."""
    sc = cfg.ssd
    b, l, _ = xin.shape
    H, P, G, N = sc.n_heads, sc.head_dim, sc.n_groups, sc.state_dim
    lo, hi = heads or (0, H)
    f32 = torch.float32
    dt = F.softplus(dt.to(f32) + p["dt_bias"].to(f32))           # (b,l,h)
    A = -torch.exp(p["A_log"].to(f32))                            # (h,)
    dtA = dt * A[None, None, :]
    xh = xin.reshape(b, l, hi - lo, P)
    rep = H // G
    # the groups repeated to every head, as the reference's, then the
    # given heads' (their gradient summed in the reference's order)
    Bh = torch.repeat_interleave(Bc.reshape(b, l, G, N), rep,
                                 dim=2)[:, :, lo:hi]
    Ch = torch.repeat_interleave(Cc.reshape(b, l, G, N), rep,
                                 dim=2)[:, :, lo:hi]
    x_dt = xh * dt[..., None].to(xh.dtype)
    return x_dt, dtA, Bh, Ch, xh


def _conv_split(xbc: torch.Tensor, cfg: ModelConfig):
    sc = cfg.ssd
    d_in = sc.n_heads * sc.head_dim
    gn = sc.n_groups * sc.state_dim
    return torch.split(xbc, [d_in, gn, gn], dim=-1)


def ssd_block_train(p: dict, x: torch.Tensor, cfg: ModelConfig,
                    return_state: bool = False, with_cache: bool = False):
    """Full-sequence Mamba-2 block. x: (B, S, d_model). With
    `return_state`, also the final SSM state (B, H, P, N) in float32;
    with `with_cache` (the prefill), the `SsdCache` it leaves instead:
    that state and the conv window's last k - 1 inputs, the block's own
    projection's x ‖ B ‖ C columns. On DTensors, head parallel
    (`_ssd_block_sharded`), the cache placed as `rules.cache_pspecs`
    places it."""
    if return_state:
        out, cache = ssd_block_train(p, x, cfg, with_cache=True)
        return out, cache.state
    if isinstance(x, DTensor):
        return _ssd_block_sharded(p, x, cfg, with_cache)
    sc = cfg.ssd
    z, xin, Bc, Cc, dt = _split_proj(p, x, cfg)
    xbc_in = torch.cat([xin, Bc, Cc], dim=-1)
    xbc = F.silu(_causal_depthwise_conv(xbc_in, p["conv_w"]))
    xin, Bc, Cc = _conv_split(xbc, cfg)

    x_dt, dtA, Bh, Ch, xh = _prep(p, xin, Bc, Cc, dt, cfg)
    y, final = ssd_chunked(x_dt, dtA, Bh, Ch, sc.chunk)
    y = y + xh * p["D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(x.shape[0], x.shape[1], sc.n_heads * sc.head_dim)
    y = y * F.silu(z)
    out = torch.einsum("bse,ed->bsd", y, p["w_out"].to(y.dtype))
    if not with_cache:
        return out
    return out, SsdCache(state=final,
                         conv=xbc_in[:, -(sc.conv_kernel - 1):])


def _ssd_block_sharded(p: dict, x: DTensor, cfg: ModelConfig,
                       with_cache: bool = False):
    """`ssd_block_train` on DTensors: x (B, S, d) with its rows split over
    the data axes and replicated over `model`; each rank runs its heads
    [lo, hi) of H (`balanced`) on its local tensors (`place.on_local`).

    The rules split `w_in`'s columns (z ‖ x ‖ B ‖ C ‖ dt) and `conv_w`'s
    channels (x ‖ B ‖ C) evenly over `model`, which is not by heads (at
    mamba2-1.3b's widths rank 0 of 2 holds all of z and 160 columns of
    x), so a rank's compute slice is not its storage slice: both are
    gathered whole over `model` (`place.whole`, through the ledger; their
    gradients, partial on each rank, reduce-scattered back to the
    rules' blocks) and the rank takes its heads' columns of z, x and dt
    and all of B and C. `dt_bias`, `A_log`, `D` and `w_out`'s rows are
    the rank's heads where H divides the model axis (taken whole and
    sliced where the rules replicate them). `ssd_chunked` runs on the
    rank's heads; `w_out`'s output is a partial sum over `model`,
    all-reduced where it joins the residual stream. With `with_cache`
    (the prefill), also the `SsdCache`: the rank's heads' final state,
    and the conv window's last inputs, the x ‖ B ‖ C columns of the
    gathered `w_in` on the last k − 1 positions, moved to
    `cache_pspecs`' layout (`place.reshard`)."""
    sc = cfg.ssd
    H, P, gn = sc.n_heads, sc.head_dim, sc.n_groups * sc.state_dim
    d_in = H * P
    mesh = x.device_mesh
    x = grad_placed_as_input(x)
    lo, hi = balanced(H, mesh)
    h = hi - lo
    pl = {k: v.placements for k, v in p.items()}

    def local(xl, q):
        dev = xl.device
        heads = torch.arange(lo * P, hi * P, device=dev)
        bc = torch.arange(2 * gn, device=dev)
        cols = torch.cat([heads, d_in + heads, 2 * d_in + bc,
                          2 * d_in + 2 * gn + torch.arange(lo, hi,
                                                           device=dev)])
        w_in = whole(q["w_in"], pl["w_in"], mesh, 1)
        zxbcdt = torch.einsum("bsd,de->bse", xl,
                              w_in[:, cols].to(xl.dtype))
        z, xin, Bc, Cc, dt = torch.split(zxbcdt, [h * P, h * P, gn, gn, h],
                                         dim=-1)
        conv_w = whole(q["conv_w"], pl["conv_w"], mesh, 1)
        xbc = torch.cat([xin, Bc, Cc], dim=-1)
        xbc = F.silu(_causal_depthwise_conv(
            xbc, conv_w[:, torch.cat([heads, d_in + bc])]))
        xin, Bc, Cc = torch.split(xbc, [h * P, gn, gn], dim=-1)
        own = {k: block(q[k], pl[k], mesh, 0, lo, hi)
               for k in ("dt_bias", "A_log", "D")}
        x_dt, dtA, Bh, Ch, xh = _prep(own, xin, Bc, Cc, dt, cfg,
                                      heads=(lo, hi))
        y, final = ssd_chunked(x_dt, dtA, Bh, Ch, sc.chunk)
        y = y + xh * own["D"].to(y.dtype)[None, None, :, None]
        y = y.reshape(xl.shape[0], xl.shape[1], h * P) * F.silu(z)
        w_out = block(q["w_out"], pl["w_out"], mesh, 0, lo * P, hi * P)
        out = torch.einsum("bse,ed->bsd", y, w_out.to(y.dtype))
        if not with_cache:
            return out
        tail = xl[:, -(sc.conv_kernel - 1):]
        conv = torch.einsum("bsd,de->bse", tail,
                            w_in[:, d_in:2 * d_in + 2 * gn].to(xl.dtype))
        return out, final, conv

    if not with_cache:
        return placed_as(on_local(local, x, block_placements(x), x, p), x)
    out, state, conv = on_local(
        local, x, (block_placements(x), channel_split(x, H, 1),
                   rows_placements(x)), x, p)
    conv = reshard(conv, cache_placements(mesh, "conv", conv.shape,
                                          x.shape[0]))
    return placed_as(out, x), SsdCache(state=state, conv=conv)


def ssd_block_decode(p: dict, x: torch.Tensor, cfg: ModelConfig,
                     cache: SsdCache) -> Tuple[torch.Tensor, SsdCache]:
    """One-token decode. x: (B, 1, d_model); recurrent state update:
    h' = exp(dtA) h + B (dt x), y = C h' + D x. Returns a new cache. On
    DTensors, `_ssd_decode_sharded`."""
    if isinstance(x, DTensor):
        return _ssd_decode_sharded(p, x, cfg, cache)
    sc = cfg.ssd
    f32 = torch.float32
    z, xin, Bc, Cc, dt = _split_proj(p, x, cfg)
    xbc_in = torch.cat([xin, Bc, Cc], dim=-1)
    xbc = F.silu(_causal_depthwise_conv(xbc_in, p["conv_w"],
                                        carry=cache.conv))
    conv_new = torch.cat([cache.conv[:, 1:], xbc_in.to(cache.conv.dtype)],
                         dim=1)
    xin, Bc, Cc = _conv_split(xbc, cfg)

    x_dt, dtA, Bh, Ch, xh = _prep(p, xin, Bc, Cc, dt, cfg)
    dA = torch.exp(dtA[:, 0]).to(f32)                             # (B,H)
    outer = torch.einsum("bhp,bhn->bhpn", x_dt[:, 0].to(f32),
                         Bh[:, 0].to(f32))
    state = cache.state * dA[..., None, None] + outer
    y = torch.einsum("bhn,bhpn->bhp", Ch[:, 0].to(f32), state)
    y = y.to(x.dtype) + xh[:, 0] * p["D"].to(x.dtype)[None, :, None]
    y = y.reshape(x.shape[0], 1, sc.n_heads * sc.head_dim)
    y = y * F.silu(z)
    out = torch.einsum("bse,ed->bsd", y, p["w_out"].to(y.dtype))
    return out, SsdCache(state=state, conv=conv_new)


def _ssd_decode_sharded(p: dict, x: DTensor, cfg: ModelConfig,
                        cache: SsdCache) -> Tuple[DTensor, SsdCache]:
    """`ssd_block_decode` on DTensors, head parallel as the block
    (`_ssd_block_sharded`): the state holds the rank's rows and heads
    (`cache_pspecs`' P(dp, "model", None, None)). The projection's
    columns are split evenly over `model`, not by heads, so its output
    for the one token is gathered whole (`place.whole`: B × (2 H P + 2
    G N + H) values, where gathering `w_in` would move all of it); so is
    `conv_w` (k × conv_dim). The conv window's layout is
    `cache_pspecs`' (its batch split over `model`): it is moved to the
    rank's rows and every column (`place.reshard`, B × (k − 1) ×
    conv_dim), the conv runs on the rank's heads' x columns and all of B
    and C, and the new window goes back to the cache's layout. `w_out`
    is row-parallel: the output is a partial sum over `model`."""
    sc = cfg.ssd
    H, P, gn = sc.n_heads, sc.head_dim, sc.n_groups * sc.state_dim
    d_in = H * P
    mesh = x.device_mesh
    lo, hi = balanced(H, mesh)
    h = hi - lo
    pl = {k: v.placements for k, v in p.items()}
    spl = channel_split(x, H, 1)
    if tuple(cache.state.placements) != spl:
        raise ValueError(f"ssd decode: state placed {cache.state.placements}")
    window = reshard(cache.conv, rows_placements(x))

    def local(xl, q, state, window):
        cdt, dev, f32 = xl.dtype, xl.device, torch.float32
        zx = whole(torch.einsum("bsd,de->bse", xl, q["w_in"].to(cdt)),
                   pl["w_in"], mesh, 2, weight_dim=1)
        xbc_in = zx[..., d_in:2 * d_in + 2 * gn]
        cols = torch.cat([torch.arange(lo * P, hi * P, device=dev),
                          d_in + torch.arange(2 * gn, device=dev)])
        conv_w = whole(q["conv_w"], pl["conv_w"], mesh, 1)
        xbc = F.silu(_causal_depthwise_conv(xbc_in[..., cols],
                                            conv_w[:, cols],
                                            carry=window[..., cols]))
        window = torch.cat([window[:, 1:], xbc_in.to(window.dtype)], dim=1)
        xin, Bc, Cc = torch.split(xbc, [h * P, gn, gn], dim=-1)
        z = zx[..., lo * P:hi * P]
        dt = zx[..., 2 * d_in + 2 * gn + lo:2 * d_in + 2 * gn + hi]
        own = {k: block(q[k], pl[k], mesh, 0, lo, hi)
               for k in ("dt_bias", "A_log", "D")}
        x_dt, dtA, Bh, Ch, xh = _prep(own, xin, Bc, Cc, dt, cfg,
                                      heads=(lo, hi))
        dA = torch.exp(dtA[:, 0]).to(f32)
        outer = torch.einsum("bhp,bhn->bhpn", x_dt[:, 0].to(f32),
                             Bh[:, 0].to(f32))
        state = state * dA[..., None, None] + outer
        y = torch.einsum("bhn,bhpn->bhp", Ch[:, 0].to(f32), state)
        y = y.to(cdt) + xh[:, 0] * own["D"].to(cdt)[None, :, None]
        y = y.reshape(xl.shape[0], 1, h * P) * F.silu(z)
        w_out = block(q["w_out"], pl["w_out"], mesh, 0, lo * P, hi * P)
        return (torch.einsum("bse,ed->bsd", y, w_out.to(y.dtype)), state,
                window)

    out, state, window = on_local(
        local, x, (block_placements(x), spl, rows_placements(x)), x, p,
        cache.state, window)
    window = reshard(window, cache.conv.placements)
    return placed_as(out, x), SsdCache(state=state, conv=window)


def init_ssd_cache(batch: int, cfg: ModelConfig, device="cuda") -> SsdCache:
    sc = cfg.ssd
    conv_dim = sc.n_heads * sc.head_dim + 2 * sc.n_groups * sc.state_dim
    return SsdCache(
        state=torch.zeros((batch, sc.n_heads, sc.head_dim, sc.state_dim),
                          dtype=torch.float32, device=device),
        conv=torch.zeros((batch, sc.conv_kernel - 1, conv_dim),
                         dtype=getattr(torch, cfg.compute_dtype),
                         device=device),
    )


def init_ssd_params(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    """The reference's distributions and scales, drawn from `gen` on its
    device: dt_bias the inverse softplus of dt ~ logU[1e-3, 1e-1],
    A_log = log(linspace(1, 16, H)), D = 1."""
    sc = cfg.ssd
    d = cfg.d_model
    d_in = sc.n_heads * sc.head_dim
    gn = sc.n_groups * sc.state_dim
    proj_out = 2 * d_in + 2 * gn + sc.n_heads
    conv_dim = d_in + 2 * gn
    dev = gen.device
    lo, hi = math.log(1e-3), math.log(1e-1)
    u = torch.rand((sc.n_heads,), generator=gen, device=dev) * (hi - lo) + lo
    return {
        "w_in": normal(gen, (d, proj_out), d ** -0.5, dtype),
        "conv_w": normal(gen, (sc.conv_kernel, conv_dim),
                         sc.conv_kernel ** -0.5, dtype),
        "dt_bias": torch.log(torch.expm1(torch.exp(u))).to(dtype),
        "A_log": torch.log(torch.linspace(1.0, 16.0, sc.n_heads,
                                          device=dev)).to(dtype),
        "D": torch.ones((sc.n_heads,), dtype=dtype, device=dev),
        "w_out": normal(gen, (d_in, d), d_in ** -0.5, dtype),
    }
