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

The reference's GSPMD sharding hints for the dispatch/combine boundary
(`moe_sharding` and the `with_sharding_constraint` points it feeds) have
no torch counterpart: the expert-parallel path is `moe_shard_map.py`,
where a rank holds its own blocks. `moe_sharding` keeps the reference's
signature for its one meaning here, no hint, and refuses any other.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import normal
from repro_torch.models.mlp import init_mlp_params, mlp_apply


@contextmanager
def moe_sharding(*, expert_batch, tokens):
    """The reference's sharding-constraint scope for (E, C, d) expert
    batches and (T, d) tokens. Only None (no hint) is taken: torch has
    no sharding constraint, so any other spec raises `ValueError`."""
    if expert_batch is not None or tokens is not None:
        raise ValueError("moe_sharding: torch has no sharding constraint; "
                         "run experts in parallel with "
                         "moe_shard_map.moe_apply_a2a")
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
    idx = torch.zeros(E * C, dtype=torch.long, device=top_e.device)
    valid = torch.zeros(E * C, dtype=torch.bool, device=top_e.device)
    idx[slot[kept]] = tok[kept]
    valid[slot[kept]] = True
    return idx, valid, slot.reshape(T, K), kept.reshape(T, K)


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
    tensors)."""
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

    # ---- expert compute on dense (E, C, d) batches ----
    xe = xf[idx].reshape(E, C, d)
    xe = xe * valid.reshape(E, C, 1).to(xe.dtype)
    ye = _expert_ffn(p["experts"], xe, cfg.mlp_act)

    # ---- combine with the router weights ----
    out = combine(ye, top_w, slot, kept)

    # ---- shared (always-on) experts ----
    if mc.n_shared:
        out = out + mlp_apply(p["shared"], xf[None], cfg.mlp_act)[0]

    # ---- router losses (Switch-style balance + z-loss) ----
    f = torch.mean(F.one_hot(top_e[:, 0], E).to(f32), dim=0)
    pbar = torch.mean(probs, dim=0)
    aux_loss = E * torch.sum(f * pbar)
    z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    dropped = 1.0 - torch.sum(valid).to(f32) / (T * K)
    aux = {"moe_aux_loss": aux_loss, "moe_z_loss": z_loss,
           "moe_drop_frac": dropped}
    return out.reshape(B, S, d), aux


def init_moe_params(gen: torch.Generator, cfg: ModelConfig, dtype) -> dict:
    """The reference's distributions and scales, drawn from `gen` on its
    device: experts N(0, 1) · d^-1/2 in and · d_expert^-1/2 out, the
    router N(0, 1) · d^-1/2 in float32."""
    mc = cfg.moe
    d, E, f = cfg.d_model, mc.n_experts, mc.d_expert
    si, so = d ** -0.5, f ** -0.5
    experts = {"w_up": normal(gen, (E, d, f), si, dtype),
               "w_down": normal(gen, (E, f, d), so, dtype)}
    if cfg.mlp_act in ("swiglu", "geglu"):
        experts["w_gate"] = normal(gen, (E, d, f), si, dtype)
    p = {"router": normal(gen, (d, E), si, torch.float32),
         "experts": experts}
    if mc.n_shared:
        p["shared"] = init_mlp_params(gen, cfg, mc.n_shared * f, dtype)
    return p
