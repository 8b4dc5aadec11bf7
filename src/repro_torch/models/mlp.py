"""Feed-forward variants: SwiGLU (llama), squared-ReLU (nemotron), GELU/GeGLU.

The port of the JAX package's `models/mlp.py`. GELU is the tanh form,
as `jax.nn.gelu`'s default (`approximate=True`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import normal
from repro_torch.sharding.place import grad_placed_as_input, placed_as


def mlp_apply(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """The feed-forward block. On DTensors (the sharded step) column- and
    row-parallel over `model` as the rules place its weights, the input's
    gradient summed over `model` once and the output placed as x (its
    partial sum all-reduced)."""
    return placed_as(mlp_partial(p, grad_placed_as_input(x), act), x)


def mlp_partial(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    """`mlp_apply` without its two placements: on DTensors the output is
    a partial sum over `model` (each rank's share of the ffn width), for a
    caller that adds another partial sum to it before the one all-reduce
    (the MoE's shared experts)."""
    cdt = x.dtype
    if act in ("swiglu", "geglu"):
        g = torch.einsum("bsd,df->bsf", x, p["w_gate"].to(cdt))
        u = torch.einsum("bsd,df->bsf", x, p["w_up"].to(cdt))
        g = F.silu(g) if act == "swiglu" else F.gelu(g, approximate="tanh")
        h = g * u
    else:
        h = torch.einsum("bsd,df->bsf", x, p["w_up"].to(cdt))
        if act == "squared_relu":
            h = torch.square(F.relu(h))
        elif act == "gelu":
            h = F.gelu(h, approximate="tanh")
        else:
            raise ValueError(act)
    # a matmul, not an einsum: on DTensors `einsum`'s flattening leads
    # DTensor to gather `w_down` in the backward
    return torch.matmul(h, p["w_down"].to(cdt))


def init_mlp_params(gen: torch.Generator, cfg: ModelConfig, d_ff: int,
                    dtype) -> dict:
    """N(0, 1) · d^-1/2 for the input projections, N(0, 1) · d_ff^-1/2 for
    `w_down`, as the reference."""
    d = cfg.d_model
    si, so = d ** -0.5, d_ff ** -0.5
    p = {"w_up": normal(gen, (d, d_ff), si, dtype),
         "w_down": normal(gen, (d_ff, d), so, dtype)}
    if cfg.mlp_act in ("swiglu", "geglu"):
        p["w_gate"] = normal(gen, (d, d_ff), si, dtype)
    return p
