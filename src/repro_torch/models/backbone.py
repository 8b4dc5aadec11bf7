"""Backbone assembly for dense decoder stacks.

The port of the JAX package's `models/backbone.py` for the configurations
whose layers are all attention (`layer_kinds() == ("attn",) * n_layers`)
with no encoder and no modality frontend: granite-3-2b, minitron-4b,
nemotron-4-15b and deepseek-67b. Any other layer kind, `encdec` or a
`frontend` raises NotImplementedError: MoE, SSD, RG-LRU, enc-dec and VLM
are ROADMAP queue A item 10, still to port.

The stack is a Python loop over a list of per-layer parameter dicts, not
a scan over a stacked layer axis (`convert.params_from_reference` splits
the reference's stack). Everything runs forward only, under
`torch.no_grad`.

Three entry points per model:
  forward_train   — full-sequence logits (+ the MoE aux, here 0)
  forward_prefill — causal forward that also returns per-layer caches
  forward_decode  — one-token step against the caches
`use_kernel` (on the entry points that reach the flash kernel) is passed
to its wrapper and changes nothing else.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.models.config import LayerKind, ModelConfig
from repro_torch.models.layers import (
    KVCache, attention_decode, attention_prefill, attention_train,
    init_attention_params, init_kv_cache, normal, rms_norm,
)
from repro_torch.models.mlp import init_mlp_params, mlp_apply

_PENDING = ("ROADMAP queue A item 10: the port runs dense stacks only "
            "(every layer 'attn', no encoder, no frontend)")


class Batch(NamedTuple):
    """Training / prefill inputs. `frontend` carries stub modality
    embeddings: vision patches (vlm, prepended) or audio frames (encdec,
    encoder input). Fields unused by an arch are None."""
    tokens: torch.Tensor                      # (B, S) integer
    labels: Optional[torch.Tensor] = None     # (B, S), -1 = masked
    frontend: Optional[torch.Tensor] = None   # (B, F, d) modality embeddings


def _check_dense(cfg: ModelConfig) -> None:
    kinds = cfg.layer_kinds()
    if kinds != ("attn",) * cfg.n_layers or cfg.arch_type == "encdec" \
            or cfg.cross_attention or cfg.frontend:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.arch_type}, kinds {sorted(set(kinds))}, "
            f"frontend {cfg.frontend}): {_PENDING}")


def stack_plan(cfg: ModelConfig) -> Tuple[Tuple[LayerKind, ...], int,
                                          Tuple[LayerKind, ...]]:
    """Returns (group pattern, n_scan_groups, tail kinds), as the
    reference's: the layout of its stacked parameters, which
    `convert.params_from_reference` reads.

    Homogeneous stacks scan one-layer groups; Griffin scans its 3-layer
    pattern; MoE scans the MoE layers with the leading dense layers in the
    (unrolled) *head*, which we represent as tail_kinds applied FIRST when
    `head=True` (see forward)."""
    kinds = cfg.layer_kinds()
    if cfg.arch_type == "hybrid":
        pat = cfg.layer_pattern or ("recurrent", "recurrent", "local_attn")
        n_groups = len(kinds) // len(pat)
        tail = kinds[n_groups * len(pat):]
        return tuple(pat), n_groups, tuple(tail)
    if cfg.arch_type == "moe" and cfg.moe.first_k_dense:
        fk = cfg.moe.first_k_dense
        return ("moe",), len(kinds) - fk, ("attn",) * fk
    return (kinds[0],), len(kinds), ()


# ---------------------------------------------------------------------------
# per-layer bodies
# ---------------------------------------------------------------------------

def _layer_train(p: dict, x, cfg: ModelConfig, positions, use_kernel):
    h = attention_train(p["attn"], rms_norm(x, p["norm1"], cfg.norm_eps),
                        cfg, positions=positions, window=cfg.window,
                        use_kernel=use_kernel)
    x = x + h
    return x + mlp_apply(p["mlp"], rms_norm(x, p["norm2"], cfg.norm_eps),
                         cfg.mlp_act)


def _layer_prefill(p: dict, x, cfg: ModelConfig, positions, cache_len,
                   use_kernel):
    h, cache = attention_prefill(p["attn"],
                                 rms_norm(x, p["norm1"], cfg.norm_eps), cfg,
                                 positions=positions, window=cfg.window,
                                 cache_len=cache_len, use_kernel=use_kernel)
    x = x + h
    x = x + mlp_apply(p["mlp"], rms_norm(x, p["norm2"], cfg.norm_eps),
                      cfg.mlp_act)
    return x, cache


def _layer_decode(p: dict, x, cfg: ModelConfig, pos, cache: KVCache):
    h, new_cache = attention_decode(p["attn"],
                                    rms_norm(x, p["norm1"], cfg.norm_eps),
                                    cfg, position=pos, cache=cache,
                                    window=cfg.window)
    x = x + h
    h = mlp_apply(p["mlp"], rms_norm(x, p["norm2"], cfg.norm_eps),
                  cfg.mlp_act)
    return x + h, new_cache


# ---------------------------------------------------------------------------
# parameters and caches
# ---------------------------------------------------------------------------

def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters from `gen`, on its device: the reference's
    distributions and scales (N(0, 1) · d^-1/2 for the embedding and the
    head, zeros for the norm scales), not its random bits.

    {"embed": (V_pad, d), "final_norm": (d,), "layers": [per-layer
    {"norm1", "attn", "mlp", "norm2"}], "head": (d, V_pad) unless tied}."""
    _check_dense(cfg)
    dtype = _dtype(cfg.param_dtype)
    d, dev = cfg.d_model, gen.device
    params = {
        "embed": normal(gen, (cfg.padded_vocab, d), d ** -0.5, dtype),
        "final_norm": torch.zeros((d,), dtype=dtype, device=dev),
        "layers": [{
            "norm1": torch.zeros((d,), dtype=dtype, device=dev),
            "attn": init_attention_params(gen, cfg, dtype),
            "mlp": init_mlp_params(gen, cfg, cfg.d_ff, dtype),
            "norm2": torch.zeros((d,), dtype=dtype, device=dev),
        } for _ in range(cfg.n_layers)],
    }
    if not cfg.tie_embeddings:
        params["head"] = normal(gen, (d, cfg.padded_vocab), d ** -0.5, dtype)
    return params


def init_caches(cfg: ModelConfig, batch: int, cache_len: int,
                device="cuda") -> dict:
    """Decode caches shaped like forward_prefill's output (fresh/empty)."""
    _check_dense(cfg)
    L = min(cache_len, cfg.window) if cfg.window else cache_len
    stack = [init_kv_cache(batch, L, cfg.n_kv_heads, cfg.resolved_head_dim,
                           dtype=_dtype(cfg.compute_dtype), device=device)
             for _ in range(cfg.n_layers)]
    return {"stack": stack, "tail": [], "enc_out": None}


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _embed(params, cfg, tokens):
    return params["embed"][tokens].to(_dtype(cfg.compute_dtype))


def _unembed(params, cfg, x):
    head = params["head"] if "head" in params else params["embed"].T
    return torch.einsum("bsd,dv->bsv", x, head.to(x.dtype))


def _positions(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[1], device=x.device)


@torch.no_grad()
def forward_train(params, cfg: ModelConfig, batch: Batch, *,
                  remat: bool = True, use_kernel: bool | None = None):
    """Full-sequence forward. Returns (logits (B,S,V), aux_loss). `remat`
    is accepted for the reference's signature and has no effect here (no
    backward)."""
    _check_dense(cfg)
    x = _embed(params, cfg, batch.tokens)
    positions = _positions(x)
    for lp in params["layers"]:
        x = _layer_train(lp, x, cfg, positions, use_kernel)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _unembed(params, cfg, x), aux


@torch.no_grad()
def forward_features(params, cfg: ModelConfig, batch: Batch, *,
                     remat: bool = False,
                     use_kernel: bool | None = None) -> torch.Tensor:
    """Final-norm hidden states (B, S, d) — the feature interface used by
    multitask.sparse_probe (DSML heads on any backbone). `remat` has no
    effect here."""
    _check_dense(cfg)
    x = _embed(params, cfg, batch.tokens)
    positions = _positions(x)
    for lp in params["layers"]:
        x = _layer_train(lp, x, cfg, positions, use_kernel)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


@torch.no_grad()
def forward_prefill(params, cfg: ModelConfig, batch: Batch, *,
                    cache_len: Optional[int] = None,
                    use_kernel: bool | None = None):
    """Causal prompt pass. Returns (last-position logits, caches). As in
    the reference, these logits are not masked for the padded vocabulary
    (decode's are)."""
    _check_dense(cfg)
    x = _embed(params, cfg, batch.tokens)
    positions = _positions(x)
    cl = cache_len or x.shape[1]
    stack = []
    for lp in params["layers"]:
        x, c = _layer_prefill(lp, x, cfg, positions, cl, use_kernel)
        stack.append(c)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _unembed(params, cfg, x[:, -1:])
    return logits, {"stack": stack, "tail": [], "enc_out": None}


@torch.no_grad()
def forward_decode(params, cfg: ModelConfig, token: torch.Tensor, pos,
                   caches: dict):
    """One decode step. token: (B, 1) integer; pos: an int.

    Returns (logits (B,1,V), new caches). The caches' tensors are updated
    in place (`layers.attention_decode`)."""
    _check_dense(cfg)
    x = _embed(params, cfg, token)
    stack = []
    for lp, c in zip(params["layers"], caches["stack"]):
        x, nc = _layer_decode(lp, x, cfg, pos, c)
        stack.append(nc)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _unembed(params, cfg, x)
    if cfg.padded_vocab != cfg.vocab:
        logits[..., cfg.vocab:] = torch.finfo(logits.dtype).min
    return logits, {"stack": stack, "tail": [], "enc_out": None}
