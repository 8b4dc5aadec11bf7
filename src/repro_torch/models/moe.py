"""Mixture-of-Experts layer: shared + routed experts, top-k router.

The port of the JAX package's `models/moe.py`. Dispatch is
gather/scatter-based (capacity-bounded, token-dropping): tokens are
gathered into dense (E, C, d) expert batches, experts run as one batched
product on stacked weights, and results come back weighted by the router.

Where the reference's ops have no exact torch twin:

* top-k is a stable descending sort cut at k, so tied probabilities keep
  the lower expert first, as `lax.top_k` does;
* slots are the reference's: the flattened (token, k) order of
  `cumsum(one_hot) - 1`, written only where the slot is below the
  capacity C (its `.at[...].set(..., mode="drop")`); an empty slot keeps
  index 0 and a zero input;
* the combine gathers each token's k expert outputs back and adds them
  in k order, where the reference scatter-adds the (E, C) slots onto the
  tokens (an empty slot adds an exact zero there). On the card
  `index_add_` would add with atomics, in no fixed order; this sum is
  the same bits every run.

On DTensors (the sharded train step) `moe_apply` is expert parallel,
with the reference's global routing (`_moe_apply_sharded`): each rank
gathers the batch's rows over the data axes and the router over `model`
(`sharding.place.gather_blocks`, through the ledger), routes every token
as the unsharded layer does (capacity, slots, balance and z losses and
drops over the global batch), runs its own experts' (E/M, C, d) slots,
replicated over the data axes, and combines its own rows; the routed
output is a partial sum over `model`. These are the layouts of the
reference's two `moe_sharding` hints, `expert_batch` over `model` and
`tokens` over the data axes, which `moe_sharding` accepts; it refuses
any other. `moe_shard_map.moe_apply_a2a` stays the reference's
serving-side layer, an all-to-all a way, each device routing its own
tokens as the reference's `shard_map` layer does.

`moe_held_apply` is the port's own layer for `hybrid_moe` (granitemoehybrid
on one card's share of the experts): the router spans every expert and
keeps the top k, as `route` does; only the held experts' routes are
computed, each held expert's group of routed rows at its own length
through one `torch.mm` a group (`grouped_mm`: no capacity, no token
dropped), and the gated outputs are added back in k order. What the experts held elsewhere
would add is left out, as on a card of an expert-parallel deployment
without its exchange.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch import obs
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import normal
from repro_torch.models.mlp import init_mlp_params, mlp_apply, mlp_partial
from repro_torch.sharding.place import (
    balanced, block, block_placements, gather_blocks, grad_placed_as_input,
    on_local, placed_as, split_dims,
)

# the layouts of the reference's hints that the sharded layer implements
# (`_moe_apply_sharded`): expert batches split over `model`, tokens over
# the data axes
EXPERT_BATCH_HINT = ("model", None, None)
TOKENS_HINTS = (("data", None), (("pod", "data"), None))


def _hint(spec):
    """A hint (a `rules.NamedSharding`, a `rules.P` or a tuple) as the
    tuple of its spec's entries, a one-name tuple as the name (JAX's
    `PartitionSpec` normal form)."""
    spec = getattr(spec, "spec", spec)
    if spec is None:
        return None
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


@contextmanager
def moe_sharding(*, expert_batch, tokens):
    """The reference's sharding-constraint scope for (E, C, d) expert
    batches and (T, d) tokens. Torch has no sharding constraint; the
    sharded layer on DTensors always lays its batches out as the
    reference's hints do (`expert_batch` `("model", None, None)`,
    `tokens` over the data axes), so those hints, or None, are taken and
    change nothing; any other spec raises `ValueError`."""
    eb, tok = _hint(expert_batch), _hint(tokens)
    if eb not in (None, EXPERT_BATCH_HINT) or \
            tok not in (None, *TOKENS_HINTS):
        raise ValueError(
            f"moe_sharding: expert_batch {expert_batch}, tokens {tokens}: "
            f"the sharded layer lays expert batches out as "
            f"{EXPERT_BATCH_HINT} and tokens as one of {TOKENS_HINTS}; "
            "torch has no other sharding constraint")
    yield


def _expert_ffn(p: dict, xe: torch.Tensor, act: str) -> torch.Tensor:
    """xe: (E, C, d) -> (E, C, d) with stacked per-expert weights."""
    cdt = xe.dtype
    if act in ("swiglu", "geglu"):
        g = torch.bmm(xe, p["w_gate"].to(cdt))
        u = torch.bmm(xe, p["w_up"].to(cdt))
        g = F.silu(g) if act == "swiglu" else F.gelu(g, approximate="tanh")
        h = g * u
    else:
        h = torch.bmm(xe, p["w_up"].to(cdt))
        h = torch.square(F.relu(h)) if act == "squared_relu" \
            else F.gelu(h, approximate="tanh")
    return torch.bmm(h, p["w_down"].to(cdt))


def route(logits: torch.Tensor, K: int):
    """Router probabilities and the top-k: (probs (T, E), top_w (T, K)
    renormalized, top_e (T, K)). Ties keep the lower expert first."""
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :K], top_e[:, :K]
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    return probs, top_w, top_e


def pack(top_e: torch.Tensor, E: int, C: int):
    """Capacity-bounded slots: (idx (E*C,) token of each slot, 0 where
    empty; valid (E*C,); slot (T, K) of each choice, clamped; kept (T, K)
    whether it got one)."""
    T, K = top_e.shape
    flat_e = top_e.reshape(-1)                                   # (T*K,)
    # the reference's cumsum(one_hot) - 1, laid out (E, T*K) so that the
    # scan runs along the inner dim (along the outer one it took 14 ms a
    # layer at deepseek-moe-16b's prefill on an H100 80GB HBM3, 700 W)
    onehot = (torch.arange(E, device=top_e.device)[:, None]
              == flat_e[None, :]).to(torch.int32)                # (E, T*K)
    pos = torch.gather(torch.cumsum(onehot, dim=1, dtype=torch.int32), 0,
                       flat_e[None, :])[0] - 1                   # (T*K,)
    tok = torch.arange(T * K, device=top_e.device) // K
    kept = pos < C
    slot = flat_e * C + torch.clamp_max(pos, C - 1)
    # a dropped choice writes to one spare slot past the table (no
    # data-dependent shape, so fake tensors trace it); kept slots are
    # distinct
    to = torch.where(kept, slot, E * C)
    idx = torch.zeros(E * C + 1, dtype=torch.long, device=top_e.device)
    valid = torch.zeros(E * C + 1, dtype=torch.bool, device=top_e.device)
    idx.scatter_(0, to, tok)
    valid.scatter_(0, to, torch.ones_like(kept))
    return idx[:E * C], valid[:E * C], slot.reshape(T, K), kept.reshape(T, K)


def combine(ye: torch.Tensor, top_w: torch.Tensor, slot: torch.Tensor,
            kept: torch.Tensor) -> torch.Tensor:
    """Each token's expert outputs, weighted, added in k order: ye (E, C,
    d) -> (T, d) in ye's dtype."""
    d = ye.shape[-1]
    flat = ye.reshape(-1, d)
    wk = (top_w * kept).to(ye.dtype)                             # (T, K)
    out = torch.zeros((slot.shape[0], d), dtype=ye.dtype, device=ye.device)
    for k in range(slot.shape[1]):
        out = out + flat[slot[:, k]] * wk[:, k, None]
    return out


def moe_apply(p: dict, x: torch.Tensor,
              cfg: ModelConfig) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, d). Returns (out, aux) with router load-balance metrics
    (`moe_aux_loss`, `moe_z_loss`, `moe_drop_frac`: 0-d float32
    tensors). On DTensors, expert parallel (`_moe_apply_sharded`)."""
    if isinstance(x, DTensor):
        return _moe_apply_sharded(p, x, cfg)
    mc = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, K = mc.n_experts, mc.top_k
    C = max(1, math.ceil(T * K * mc.capacity_factor / E))
    xf = x.reshape(T, d)

    # ---- router (float32 for numerics) ----
    f32 = torch.float32
    logits = torch.einsum("td,de->te", xf.to(f32), p["router"].to(f32))
    probs, top_w, top_e = route(logits, K)

    # ---- capacity-bounded slot assignment ----
    idx, valid, slot, kept = pack(top_e, E, C)

    # ---- router losses (Switch-style balance + z-loss), before the
    # experts as in the sharded layer, so that remat's recompute, which
    # stops at the last tensor the backward saves, runs the same ops ----
    aux_loss, z_loss, dropped = _router_losses(logits, probs, top_e, valid,
                                               E, T, K)

    # ---- expert compute on dense (E, C, d) batches ----
    xe = xf[idx].reshape(E, C, d)
    xe = xe * valid.reshape(E, C, 1).to(xe.dtype)
    ye = _expert_ffn(p["experts"], xe, cfg.mlp_act)

    # ---- combine with the router weights ----
    out = combine(ye, top_w, slot, kept)

    # ---- shared (always-on) experts ----
    if mc.n_shared:
        out = out + mlp_apply(p["shared"], xf[None], cfg.mlp_act)[0]

    aux = {"moe_aux_loss": aux_loss, "moe_z_loss": z_loss,
           "moe_drop_frac": dropped}
    return out.reshape(B, S, d), aux


class HeldRoutes(NamedTuple):
    """The routes of T tokens' top-k choices that reach the held experts,
    grouped by expert: `tok` (R,) the token of each grouped row, in token
    order within a group; `counts` (E_held host ints) the groups' sizes;
    `pos` (T, K) each choice's grouped row
    (clamped) and `held` (T, K) whether it has one; `chosen` the count of
    choices that fell on a held expert (host int); `order` the flat
    (token, k) choices in grouped order, the held ones first."""
    tok: torch.Tensor
    counts: list
    pos: torch.Tensor
    held: torch.Tensor
    chosen: int
    order: torch.Tensor


def held_routes(top_e: torch.Tensor, lo: int, n: int) -> HeldRoutes:
    """Group the choices `top_e` (T, K) that fall on experts [lo, lo + n)
    by expert, keeping every one: a stable sort of the (token, k) order
    by held expert, the others last. The group sizes are read back to the
    host once (the launches' shapes)."""
    T, K = top_e.shape
    flat = top_e.reshape(-1) - lo
    held = (flat >= 0) & (flat < n)
    key = torch.where(held, flat, n)
    order = torch.sort(key, stable=True).indices
    sizes = torch.bincount(key, minlength=n + 1)
    *counts, others = sizes.tolist()
    R = sum(counts)
    pos = torch.empty_like(order)
    pos[order] = torch.arange(T * K, device=top_e.device)
    return HeldRoutes(order[:R] // K, counts,
                      torch.clamp_max(pos, max(R - 1, 0)).reshape(T, K),
                      held.reshape(T, K), T * K - others, order)


class _Dispatch(torch.autograd.Function):
    """xs = x[tok]: each grouped row its token's input. The gradient
    gathers too, each token's grouped rows added in k order (`pos`,
    `held`), where indexing's own backward would scatter-add into the
    tokens."""

    @staticmethod
    def forward(ctx, x, r):
        ctx.r = r
        return x[r.tok]

    @staticmethod
    def backward(ctx, dxs):
        r = ctx.r
        dx = torch.zeros((r.pos.shape[0], dxs.shape[1]), dtype=dxs.dtype,
                         device=dxs.device)
        if dxs.shape[0]:
            for k in range(r.pos.shape[1]):
                dx = dx + dxs[r.pos[:, k]] * r.held[:, k, None]
        return dx, None


class _Combine(torch.autograd.Function):
    """out[t] = Σ_k w[t, k] · ys[pos[t, k]] over t's choices, added in k
    order (w is 0 at a choice not held). Its gradients are gathers: each
    grouped row's from its one token, each gate's a dot product. None
    scatters, so nothing adds with atomics, and no row that every unheld
    choice points at is written T·K times (indexing's own backward took
    1.45 s a step so at the cell's size)."""

    @staticmethod
    def forward(ctx, ys, w, r):
        ctx.save_for_backward(ys, w)
        ctx.r = r
        out = torch.zeros((w.shape[0], ys.shape[1]), dtype=ys.dtype,
                          device=ys.device)
        if ys.shape[0]:
            for k in range(w.shape[1]):
                out = out + ys[r.pos[:, k]] * w[:, k, None]
        return out

    @staticmethod
    def backward(ctx, dout):
        ys, w = ctx.saved_tensors
        r = ctx.r
        K = w.shape[1]
        dw = torch.zeros_like(w)
        if not ys.shape[0]:
            return torch.zeros_like(ys), dw, None
        # grouped row j is the choice (tok[j], order[j] % K)
        dys = dout[r.tok] * w[r.tok, r.order[:ys.shape[0]] % K][:, None]
        for k in range(K):
            dw[:, k] = torch.sum((dout * ys[r.pos[:, k]]).to(torch.float32),
                                 dim=-1).to(w.dtype) * r.held[:, k]
        return dys, dw, None


def _mm_groups(x: torch.Tensor, w: torch.Tensor, counts: list,
               out: torch.Tensor) -> torch.Tensor:
    """out[rows of group e] = x[rows of group e] @ w[e], one `torch.mm` a
    group written in place: the rows of a group are a contiguous slice."""
    a = 0
    for e, n in enumerate(counts):
        if n:
            torch.mm(x[a:a + n], w[e], out=out[a:a + n])
        a += n
    return out


class _GroupedMM(torch.autograd.Function):
    """y_e = x_e w_e over each held expert's group of rows (x (R, K)
    grouped in order, `counts` host ints, w (E, K, N)); dx_e = dy_e w_eᵀ,
    dw_e = x_eᵀ dy_e (zeros for an empty group). Forward and backward
    open the span `model.moe.experts`, so that the products' device time
    is charged to it also where autograd launches the backward."""

    @staticmethod
    def forward(ctx, x, w, counts):
        ctx.save_for_backward(x, w)
        ctx.counts = counts
        with obs.span("model.moe.experts"):
            return _mm_groups(x, w, counts,
                              x.new_empty((x.shape[0], w.shape[2])))

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        with obs.span("model.moe.experts"):
            dx = _mm_groups(dy, w.transpose(1, 2), ctx.counts,
                            dy.new_empty(x.shape))
            dw = w.new_empty(w.shape)
            a = 0
            for e, n in enumerate(ctx.counts):
                if n:
                    torch.mm(x[a:a + n].T, dy[a:a + n], out=dw[e])
                else:
                    dw[e].zero_()
                a += n
        return dx, dw, None


def grouped_mm(x: torch.Tensor, w: torch.Tensor,
               counts: list) -> torch.Tensor:
    """Each group of x's rows times its expert's matrix: (R, K) x (E, K,
    N) -> (R, N), differentiable in x and w."""
    return _GroupedMM.apply(x, w, counts)


def _held_swiglu(p: dict, xs: torch.Tensor, r: HeldRoutes,
                 act: str) -> torch.Tensor:
    """Each grouped row through its expert's FFN: (R, d) -> (R, d)."""
    cdt = xs.dtype

    def gmm(a, w):
        return grouped_mm(a, w.to(cdt), r.counts)
    if act not in ("swiglu", "geglu"):
        raise ValueError(f"moe_held_apply: {act} experts")
    g = gmm(xs, p["w_gate"])
    g = F.silu(g) if act == "swiglu" else F.gelu(g, approximate="tanh")
    return gmm(g * gmm(xs, p["w_up"]), p["w_down"])


def moe_held_apply(p: dict, x: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """The routed part of a `hybrid_moe` layer on the experts held here:
    x (B, S, d) -> Σ over each token's top-k experts that are held of
    gate · FFN_e(x), (B, S, d) in x's dtype. The router (float32, every
    expert) and the gates are `route`'s: the softmax of the top k of the
    logits, which is the renormalised top k of the softmax. No route is
    dropped. Records `moe.routes_held` (the routes computed),
    `moe.routes_dropped` (held routes not computed: 0) and
    `moe.routes_max_expert` (the largest group, observed a call)."""
    mc, hm = cfg.moe, cfg.hybrid_moe
    B, S, d = x.shape
    T, K = B * S, mc.top_k
    xf = x.reshape(T, d)
    logits = torch.einsum("td,de->te", xf.to(torch.float32),
                          p["router"].to(torch.float32))
    _, top_w, top_e = route(logits, K)
    r = held_routes(top_e, hm.expert_offset, hm.experts_held)
    ys = _held_swiglu(p["experts"], _Dispatch.apply(xf, r), r, cfg.mlp_act)
    out = _Combine.apply(ys, (top_w * r.held).to(ys.dtype), r)
    obs.inc("moe.routes_held", ys.shape[0])
    obs.inc("moe.routes_dropped", r.chosen - ys.shape[0])
    obs.observe("moe.routes_max_expert", max(r.counts, default=0))
    return out.reshape(B, S, d)


def _router_losses(logits, probs, top_e, valid, E: int, T: int, K: int):
    """Switch-style balance loss, z-loss and the fraction of the T·K
    choices dropped, over every token routed."""
    f32 = torch.float32
    first = top_e[:, 0, None] == torch.arange(E, device=top_e.device)
    f = torch.mean(first.to(f32), dim=0)
    pbar = torch.mean(probs, dim=0)
    aux_loss = E * torch.sum(f * pbar)
    z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    dropped = 1.0 - torch.sum(valid).to(f32) / (T * K)
    return aux_loss, z_loss, dropped


def _moe_apply_sharded(p: dict, x: DTensor, cfg: ModelConfig):
    """`moe_apply` on DTensors, the reference's one-batch layer: x
    (B, S, d) with its rows split over the data axes, replicated over
    `model`; the router's columns and the experts split over `model`
    (`sharding.rules`), replicated where E does not divide. On each
    rank's local tensors (`place.on_local`):

    1. the batch's rows gathered over the data axes and the router over
       `model` (`gather_blocks`: their gradients reduce-scattered back);
    2. `route` and `pack` on all T = B·S tokens: C = ⌈T·K·cf/E⌉, slots
       in the global (token, k) order, so capacity and drops are the
       unsharded layer's;
    3. the rank's experts [lo, hi) (`balanced`) on their (E/M, C, d)
       slots, the same on every data rank (the reference's
       `expert_batch` hint, P("model", None, None));
    4. `combine` of the rank's own rows, from its own experts only, in
       k order: the routed output is a partial sum over `model`.

    The balance loss, z-loss and drop fraction are computed alike on
    every rank from the whole routing; the two losses are returned
    divided by the ranks the work is split over and `Partial` there
    (summed back to the value, and each rank's gradient its share). The
    shared experts run as the dense MLP, column- and row-parallel
    (`mlp_partial`), and join the routed output's partial sum before its
    one all-reduce. Each rank thus runs its experts on every data rank's
    tokens: data × the expert FLOPs of a split expert batch."""
    mc = cfg.moe
    E, K = mc.n_experts, mc.top_k
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    x = grad_placed_as_input(x)
    split = split_dims(x)
    rows = [names[j] for j, q in enumerate(x.placements) if q.is_shard()]
    lo, hi = balanced(E, mesh)
    rpl = p["router"].placements
    epl = {k: v.placements for k, v in p["experts"].items()}
    scale = 1.0
    for j in split:
        scale *= mesh.size(j)
    # this rank's rows' offset in the gathered batch (pod major)
    row_rank = 0
    for a in rows:
        j = names.index(a)
        row_rank = row_rank * mesh.size(j) + mesh.get_local_rank(j)

    def local(xl, router, experts):
        xg = gather_blocks(xl, mesh, rows, 0)
        B, S, d = xg.shape
        T = B * S
        C = max(1, math.ceil(T * K * mc.capacity_factor / E))
        xf = xg.reshape(T, d)
        f32 = torch.float32
        w_r = block(router, rpl, mesh, 1, 0, E)
        logits = torch.einsum("td,de->te", xf.to(f32), w_r.to(f32))
        probs, top_w, top_e = route(logits, K)
        idx, valid, slot, kept = pack(top_e, E, C)
        own = slice(lo * C, hi * C)
        xe = xf[idx[own]].reshape(hi - lo, C, d)
        xe = xe * valid[own].reshape(hi - lo, C, 1).to(xe.dtype)
        ye = _expert_ffn({k: block(v, epl[k], mesh, 0, lo, hi)
                          for k, v in experts.items()}, xe, cfg.mlp_act)
        mine = slice(row_rank * xl.shape[0] * S,
                     (row_rank + 1) * xl.shape[0] * S)
        e = top_e[mine]
        here = (e >= lo) & (e < hi)
        out = combine(ye, top_w[mine],
                      torch.where(here, slot[mine] - lo * C, 0),
                      kept[mine] & here)
        aux_loss, z_loss, dropped = _router_losses(logits, probs, top_e,
                                                   valid, E, T, K)
        return (out.reshape(xl.shape), aux_loss / scale, z_loss / scale,
                dropped)

    losses = tuple(Partial() if j in split else Replicate()
                   for j in range(mesh.ndim))
    out, aux_loss, z_loss, dropped = on_local(
        local, x, (block_placements(x), losses, losses,
                   (Replicate(),) * mesh.ndim),
        x, p["router"], p["experts"])
    if mc.n_shared:
        out = out + mlp_partial(p["shared"], x, cfg.mlp_act)
    aux = {"moe_aux_loss": aux_loss, "moe_z_loss": z_loss,
           "moe_drop_frac": dropped}
    return placed_as(out, x), aux


def init_moe_params(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    """The reference's distributions and scales, drawn from `gen` on its
    device: experts N(0, 1) · d^-1/2 in and · d_expert^-1/2 out, the
    router N(0, 1) · d^-1/2 in float32."""
    mc, hm = cfg.moe, cfg.hybrid_moe
    d, E, f = cfg.d_model, mc.n_experts, mc.d_expert
    # a `hybrid_moe` layer holds its share of the experts, its router
    # spans them all, and its shared expert has a width of its own
    held = E if hm is None else hm.experts_held
    si, so = d ** -0.5, f ** -0.5
    experts = {"w_up": normal(gen, (held, d, f), si, dtype),
               "w_down": normal(gen, (held, f, d), so, dtype)}
    if cfg.mlp_act in ("swiglu", "geglu"):
        experts["w_gate"] = normal(gen, (held, d, f), si, dtype)
    p = {"router": normal(gen, (d, E), si, torch.float32),
         "experts": experts}
    if mc.n_shared:
        width = mc.n_shared * f if hm is None else hm.d_shared
        p["shared"] = init_mlp_params(gen, cfg, width, dtype)
    return p
