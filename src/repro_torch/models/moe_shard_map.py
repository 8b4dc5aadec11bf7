"""Explicit all-to-all MoE dispatch, one process a rank.

The port of the JAX package's `models/moe_shard_map.py`. The reference
runs `body` under `shard_map` over a (data, model) mesh; here every rank
of a `DeviceMesh` runs it on its own blocks (`substrate`): its tokens
(sharded over `dp_axis`, the same on every rank of an `ep_axis` group)
and its resident experts (sharded over `ep_axis`).

Per rank:
  1. local router top-k (`moe.route`);
  2. pack tokens into a fixed (E, C_loc, d) send buffer
     (C_loc = ceil(T_loc * k * cf / E) — per-source-rank capacity);
  3. `all_to_all_experts` over `ep_axis`: -> (n_ep, E_loc, C_loc, d);
  4. local expert FFN on the resident experts;
  5. `all_to_all_experts` back + local weighted combine (`moe.combine`).

Communication per rank per layer = 2 x E * C_loc * d (send + return),
independent of the data-axis size, and no all-reduce of tokens.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.mlp import mlp_apply
from repro_torch.models.moe import _expert_ffn, combine, pack, route
from repro_torch.substrate.collectives import all_to_all_experts


def _local_pack(xf: torch.Tensor, logits: torch.Tensor, E: int, K: int,
                C: int, cdt):
    """Greedy capacity-bounded packing on one rank. xf: (T, d); returns
    the send buffer (E, C, d), the combine's bookkeeping and the router
    probabilities."""
    T, d = xf.shape
    probs, top_w, top_e = route(logits, K)
    idx, valid, slot, kept = pack(top_e, E, C)
    send = xf[idx].reshape(E, C, d).to(cdt)
    send = send * valid.reshape(E, C, 1).to(cdt)
    return send, top_w, slot, kept, probs


def moe_apply_a2a(p: dict, x: torch.Tensor, cfg: ModelConfig, mesh, *,
                  dp_axis: str = "data", ep_axis: str = "model"
                  ) -> Tuple[torch.Tensor, dict]:
    """The MoE layer with explicit all-to-all expert parallelism, on this
    rank's blocks.

    x: (B_loc, S, d), this rank's tokens. `p["router"]` (d, E) and
    `p["shared"]` are whole; `p["experts"]` holds this rank's E // n_ep
    experts, those of block j = its coordinate on `ep_axis`. Requires
    E % n_ep == 0. Returns (out (B_loc, S, d), aux): the balance loss
    over this rank's tokens, z-loss and drop fraction 0, as the
    reference's. `dp_axis` names the token dim, which no collective
    crosses.
    """
    mc = cfg.moe
    E, K = mc.n_experts, mc.top_k
    n_ep = mesh.size(mesh.mesh_dim_names.index(ep_axis))
    if E % n_ep:
        raise ValueError(f"moe_apply_a2a: {E} experts over {ep_axis} = "
                         f"{n_ep} ranks")
    E_loc = E // n_ep
    B_loc, S, d = x.shape
    T = B_loc * S
    C = max(1, math.ceil(T * K * mc.capacity_factor / E))
    cdt = x.dtype
    xf = x.reshape(T, d)
    f32 = torch.float32
    logits = torch.einsum("td,de->te", xf.to(f32), p["router"].to(f32))
    send, top_w, slot, kept, probs = _local_pack(xf, logits, E, K, C, cdt)

    # ---- the explicit communication: one all-to-all out, one back ----
    recv = all_to_all_experts(send.reshape(n_ep, E_loc, C, d), mesh,
                              ep_axis)
    # recv: (n_ep, E_loc, C, d) — every source rank's tokens for the
    # experts resident here
    ye = _expert_ffn(p["experts"],
                     recv.transpose(0, 1).reshape(E_loc, n_ep * C, d),
                     cfg.mlp_act)
    back = ye.reshape(E_loc, n_ep, C, d).transpose(0, 1)
    ret = all_to_all_experts(back, mesh, ep_axis).reshape(E, C, d)

    out = combine(ret, top_w, slot, kept)
    f = torch.mean(F.one_hot(torch.argmax(logits, -1), E).to(f32), dim=0)
    aux = E * torch.sum(f * torch.mean(probs, dim=0))
    out = out.reshape(B_loc, S, d)
    if mc.n_shared:
        out = out + mlp_apply(p["shared"], x, cfg.mlp_act)
    zero = torch.zeros((), dtype=f32, device=x.device)
    return out, {"moe_aux_loss": aux, "moe_z_loss": zero,
                 "moe_drop_frac": zero}
