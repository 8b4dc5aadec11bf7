"""Griffin-style recurrent block: temporal conv + RG-LRU (RecurrentGemma).

The port of the JAX package's `models/rglru.py`. The RG-LRU recurrence
(Griffin, arXiv:2402.19427):

    r_t = sigmoid(W_a u_t + b_a)            recurrence gate
    i_t = sigmoid(W_i u_t + b_i)            input gate
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

Training/prefill evaluates the linear recurrence with a log-depth scan
(the reference's `jax.lax.associative_scan`; here Hillis–Steele steps
over the sequence axis with the same combine, ceil(log2 S) of them);
decode carries (h, conv window) state and returns a new cache.

On DTensors (the sharded train step) the block is channel parallel over
`model` (`_recurrent_block_sharded`), as the rules place its weights:
`w_x`, `w_gate`, `conv_w`, the gates' output columns, `b_a`, `b_i` and
`lam` are each rank's channels, and `w_o`'s rows.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import normal
from repro_torch.sharding.place import (
    balanced, block, block_placements, channel_split, gather_blocks,
    grad_placed_as_input, on_local, placed_as, reshard, rows_placements,
    whole,
)
from repro_torch.sharding.rules import cache_placements


class RecurrentCache(NamedTuple):
    h: torch.Tensor          # (B, d_rnn) RG-LRU hidden state, float32
    conv: torch.Tensor       # (B, kernel-1, d_rnn) trailing conv inputs


def _causal_depthwise_conv(u: torch.Tensor, w: torch.Tensor,
                           carry: torch.Tensor | None = None) -> torch.Tensor:
    """u: (B, S, D), w: (k, D) depthwise causal conv; carry: (B, k-1, D).

    A cross-correlation, as the reference's: w[0] multiplies the oldest
    input of the window. The k products are summed in the reference's
    order, in u's dtype."""
    k = w.shape[0]
    if carry is None:
        carry = torch.zeros((u.shape[0], k - 1, u.shape[2]), dtype=u.dtype,
                            device=u.device)
    ext = torch.cat([carry.to(u.dtype), u], dim=1)
    S = u.shape[1]
    out = ext[:, 0:S] * w[0].to(u.dtype)
    for i in range(1, k):
        out = out + ext[:, i:i + S] * w[i].to(u.dtype)
    return out


def _rglru_gates(p: dict, u: torch.Tensor, c: float,
                 u_out: torch.Tensor | None = None):
    """The gates a, b of the channels of `p`'s gate columns, from u over
    every channel; `u_out` is u on those channels where they are not all
    of u's (a rank's channels in the sharded block)."""
    f32 = torch.float32
    uf = u.to(f32)
    r = torch.sigmoid(torch.einsum("...d,de->...e", uf, p["w_a"].to(f32))
                      + p["b_a"].to(f32))
    i = torch.sigmoid(torch.einsum("...d,de->...e", uf, p["w_i"].to(f32))
                      + p["b_i"].to(f32))
    log_a = -c * F.softplus(p["lam"].to(f32)) * r
    a = torch.exp(log_a)
    own = uf if u_out is None else u_out.to(f32)
    b = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * own)
    return a, b


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0, along dim 1, in
    ceil(log2 S) Hillis–Steele steps of the reference's combine
    ((a_l, b_l), (a_r, b_r)) -> (a_r a_l, a_r b_l + b_r)."""
    S = a.shape[1]
    step = 1
    while step < S:
        a_prev, b_prev = a[:, :-step], b[:, :-step]
        a_new = torch.cat([a[:, :step], a[:, step:] * a_prev], dim=1)
        b = torch.cat([b[:, :step], a[:, step:] * b_prev + b[:, step:]],
                      dim=1)
        a = a_new
        step *= 2
    return b


def rglru_scan(p: dict, u: torch.Tensor, c: float) -> torch.Tensor:
    """Full-sequence RG-LRU. u: (B, S, D) -> h (B, S, D) in u's dtype."""
    a, b = _rglru_gates(p, u, c)
    return _linear_scan(a, b).to(u.dtype)


def rglru_step(p: dict, u: torch.Tensor, h: torch.Tensor, c: float):
    """One decode step. u: (B, 1, D), h: (B, D) -> (y (B,1,D), h')."""
    a, b = _rglru_gates(p, u, c)
    h_new = a[:, 0] * h.to(torch.float32) + b[:, 0]
    return h_new[:, None].to(u.dtype), h_new


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default


def recurrent_block_train(p: dict, x: torch.Tensor, cfg: ModelConfig,
                          with_cache: bool = False):
    """Griffin recurrent block, full sequence. x: (B, S, d_model). With
    `with_cache` (the prefill), also the `RecurrentCache` it leaves: the
    last RG-LRU state (f32) and the conv window's last k - 1 inputs, from
    the block's own h and u. On DTensors, channel parallel
    (`_recurrent_block_sharded`), the cache placed as `rules.cache_pspecs`
    places it."""
    if isinstance(x, DTensor):
        return _recurrent_block_sharded(p, x, cfg, with_cache)
    cdt = x.dtype
    gate = _gelu(torch.einsum("bsd,de->bse", x, p["w_gate"].to(cdt)))
    u_in = torch.einsum("bsd,de->bse", x, p["w_x"].to(cdt))
    u = _causal_depthwise_conv(u_in, p["conv_w"])
    h = rglru_scan(p, u, cfg.rglru.c)
    out = torch.einsum("bse,ed->bsd", h * gate, p["w_o"].to(cdt))
    if not with_cache:
        return out
    return out, RecurrentCache(h=h[:, -1].to(torch.float32),
                               conv=u_in[:, -(cfg.rglru.conv_kernel - 1):])


def _recurrent_block_sharded(p: dict, x: DTensor, cfg: ModelConfig,
                             with_cache: bool = False):
    """`recurrent_block_train` on DTensors: x (B, S, d) with its rows
    split over the data axes and replicated over `model`; each rank runs
    its channels [lo, hi) of D (`balanced`) on its local tensors
    (`place.on_local`). The gate, u = conv(x W_x) and the scan are
    per channel. The gates r and i of a channel read u over every
    channel, so u is gathered over `model` (`gather_blocks`, through the
    ledger; its gradient, partial on each rank, reduce-scattered back):
    B·S·D a layer, where gathering `w_a` and `w_i` instead would still
    need u whole. `w_o` is row-parallel: the output is a partial sum over
    `model`, all-reduced where it joins the residual stream. Where D
    does not divide the model axis the rules replicate these weights:
    each rank computes u whole and takes its channels from it. With
    `with_cache` (the prefill), also the `RecurrentCache` of the rank's
    channels: the last state, and the conv window's inputs moved to
    `cache_pspecs`' layout (`place.reshard`)."""
    mesh = x.device_mesh
    x = grad_placed_as_input(x)
    D = p["w_x"].shape[1]
    lo, hi = balanced(D, mesh)
    pl = {k: v.placements for k, v in p.items()}
    k = cfg.rglru.conv_kernel

    def local(xl, q):
        cdt = xl.dtype

        def own(name, dim):
            return block(q[name], pl[name], mesh, dim, lo, hi)

        gate = _gelu(torch.einsum("bsd,de->bse", xl, own("w_gate", 1).to(cdt)))
        w_x, conv_w = own("w_x", 1), own("conv_w", 1)
        if q["w_x"].shape[1] == hi - lo and q["conv_w"].shape[1] == hi - lo:
            # the rank's channels of u, then u over every channel
            u_in = torch.einsum("bsd,de->bse", xl, w_x.to(cdt))
            u_own = _causal_depthwise_conv(u_in, conv_w)
            u = gather_blocks(u_own, mesh, ("model",), 2)
        else:
            u_in = torch.einsum("bsd,de->bse", xl, q["w_x"].to(cdt))
            u = _causal_depthwise_conv(u_in, q["conv_w"])
            u_own, u_in = u[..., lo:hi], u_in[..., lo:hi]
        gates = {k: own(k, 1 if k.startswith("w_") else 0)
                 for k in ("w_a", "w_i", "b_a", "b_i", "lam")}
        a, b = _rglru_gates(gates, u, cfg.rglru.c, u_out=u_own)
        h = _linear_scan(a, b).to(cdt)
        out = torch.einsum("bse,ed->bsd", h * gate, own("w_o", 0).to(cdt))
        if not with_cache:
            return out
        return out, h[:, -1].to(torch.float32), u_in[:, -(k - 1):]

    if not with_cache:
        return placed_as(on_local(local, x, block_placements(x), x, p), x)
    hpl, cpl = channel_split(x, D, 1), channel_split(x, D, 2)
    out, h, conv = on_local(local, x, (block_placements(x), hpl, cpl), x, p)
    conv = reshard(conv, cache_placements(mesh, "conv", conv.shape,
                                          x.shape[0]))
    return placed_as(out, x), RecurrentCache(h=h, conv=conv)


def recurrent_block_decode(p: dict, x: torch.Tensor, cfg: ModelConfig,
                           cache: RecurrentCache
                           ) -> Tuple[torch.Tensor, RecurrentCache]:
    """One-token decode. x: (B, 1, d_model). Returns a new cache; the one
    given is not written. On DTensors, `_recurrent_decode_sharded`."""
    if isinstance(x, DTensor):
        return _recurrent_decode_sharded(p, x, cfg, cache)
    cdt = x.dtype
    gate = _gelu(torch.einsum("bsd,de->bse", x, p["w_gate"].to(cdt)))
    u_in = torch.einsum("bsd,de->bse", x, p["w_x"].to(cdt))
    u = _causal_depthwise_conv(u_in, p["conv_w"], carry=cache.conv)
    conv_new = torch.cat([cache.conv[:, 1:], u_in.to(cache.conv.dtype)],
                         dim=1)
    y, h_new = rglru_step(p, u, cache.h, cfg.rglru.c)
    out = torch.einsum("bse,ed->bsd", y * gate, p["w_o"].to(cdt))
    return out, RecurrentCache(h=h_new, conv=conv_new)


def _recurrent_decode_sharded(p: dict, x: DTensor, cfg: ModelConfig,
                              cache: RecurrentCache):
    """`recurrent_block_decode` on DTensors, channel parallel as the
    block (`_recurrent_block_sharded`): the state `h` holds the rank's
    rows and channels (`cache_pspecs`' P(dp, "model")). The conv
    window's layout is `cache_pspecs`' (its batch split over `model`),
    so it is moved to the rank's rows and every channel
    (`place.reshard`: B × (k − 1) × D); the new input u_in is gathered
    over `model` (`place.whole`), the conv runs on every channel, the
    gates take u whole and the rank's channels, and the new window goes
    back to the cache's layout. `w_o` is row-parallel: the output is a
    partial sum over `model`."""
    mesh = x.device_mesh
    D = p["w_x"].shape[1]
    lo, hi = balanced(D, mesh)
    pl = {k: v.placements for k, v in p.items()}
    hpl = channel_split(x, D, 1)
    if tuple(cache.h.placements) != hpl:
        raise ValueError(f"recurrent decode: h placed {cache.h.placements}")
    window = reshard(cache.conv, rows_placements(x))

    def local(xl, q, h, window):
        cdt = xl.dtype

        def own(name, dim):
            return block(q[name], pl[name], mesh, dim, lo, hi)

        gate = _gelu(torch.einsum("bsd,de->bse", xl, own("w_gate", 1).to(cdt)))
        u_in = whole(torch.einsum("bsd,de->bse", xl, q["w_x"].to(cdt)),
                     pl["w_x"], mesh, 2, weight_dim=1)
        u = _causal_depthwise_conv(
            u_in, whole(q["conv_w"], pl["conv_w"], mesh, 1), carry=window)
        window = torch.cat([window[:, 1:], u_in.to(window.dtype)], dim=1)
        gates = {k: own(k, 1 if k.startswith("w_") else 0)
                 for k in ("w_a", "w_i", "b_a", "b_i", "lam")}
        a, b = _rglru_gates(gates, u, cfg.rglru.c, u_out=u[..., lo:hi])
        h_new = a[:, 0] * h.to(torch.float32) + b[:, 0]
        out = torch.einsum("bse,ed->bsd", h_new[:, None].to(cdt) * gate,
                           own("w_o", 0).to(cdt))
        return out, h_new, window

    out, h, window = on_local(
        local, x, (block_placements(x), hpl, rows_placements(x)), x, p,
        cache.h, window)
    window = reshard(window, cache.conv.placements)
    return placed_as(out, x), RecurrentCache(h=h, conv=window)


def init_recurrent_cache(batch: int, cfg: ModelConfig,
                         device="cuda") -> RecurrentCache:
    rc = cfg.rglru
    dr = rc.d_rnn or cfg.d_model
    return RecurrentCache(
        h=torch.zeros((batch, dr), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, rc.conv_kernel - 1, dr),
                         dtype=getattr(torch, cfg.compute_dtype),
                         device=device),
    )


def init_recurrent_params(gen: torch.Generator, cfg: ModelConfig,
                          dtype) -> dict:
    """The reference's distributions and scales, drawn from `gen` on its
    device; Lambda spaced on [0.1, 2.0] so that a ~ U[0.9, 0.999]^c at
    r = 1 (Griffin appendix)."""
    rc = cfg.rglru
    d = cfg.d_model
    dr = rc.d_rnn or d
    dev = gen.device
    return {
        "w_gate": normal(gen, (d, dr), d ** -0.5, dtype),
        "w_x": normal(gen, (d, dr), d ** -0.5, dtype),
        "conv_w": normal(gen, (rc.conv_kernel, dr), rc.conv_kernel ** -0.5,
                         dtype),
        "w_a": normal(gen, (dr, dr), dr ** -0.5, dtype),
        "b_a": torch.zeros((dr,), dtype=dtype, device=dev),
        "w_i": normal(gen, (dr, dr), dr ** -0.5, dtype),
        "b_i": torch.zeros((dr,), dtype=dtype, device=dev),
        "lam": torch.linspace(0.1, 2.0, dr, device=dev).to(dtype),
        "w_o": normal(gen, (dr, d), dr ** -0.5, dtype),
    }
