"""Backbone assembly: decoder-only / enc-dec / hybrid / SSM model stacks.

The port of the JAX package's `models/backbone.py`, for every family of
the zoo: dense and MoE decoders, the audio encoder-decoder, the VLM
decoder (stub patches prepended), Griffin's RG-LRU / local-attention
hybrid and Mamba-2's SSD stack.

The reference stacks its parameters along a leading layer axis and scans
repeating *groups* (`stack_plan`: Griffin's 3-layer pattern, one layer
elsewhere), with the remainder (Griffin) or the leading dense layers
(MoE, applied FIRST) unrolled as a *tail*. The port keeps that order
as plain lists: `params["layers"]` holds the groups' layers one after
another (layer j has kind `pattern[j % len(pattern)]`), `params["tail"]`
the tail's, `params["encoder"]["layers"]` the encoder's, and a Python
loop runs them (`convert.params_from_reference` splits the reference's
stacks). The caches follow the same lists.

`forward_train` is differentiable (the training step of
`training/step.py` takes its gradient); with `remat` each group of
`stack_plan`'s pattern is checkpointed
(`torch.utils.checkpoint.checkpoint`, non-reentrant) as the reference's
`jax.checkpoint(group)`: its activations are recomputed in the backward,
and the tail (the MoE head, Griffin's remainder) is not. The serving
entry points run under `torch.no_grad`.

Three entry points per model:
  forward_train   — full-sequence logits (+ the MoE aux)
  forward_prefill — causal forward that also returns per-layer caches
  forward_decode  — one-token step against the caches
and `forward_features`, the final-norm hidden states. `use_kernel` (on
the entry points that reach the flash kernel) is passed to its wrapper
and changes nothing else.

Run a family on the CPU with `python -m repro_torch.launch.serve --arch
<name> --device cpu` (the smoke size); `chip_smoke.py` phase 9 serves
the non-dense families at full width on the card.

`forward_train` also runs on DTensors (the sharded train step), for
every family: the embeddings are looked up vocab-parallel
(`_embed_vocab_parallel`) and placed as the tokens, and the head's input
gradient is summed over `model` (`sharding.place`); the rest is the
blocks' own: attention on each rank's heads (`layers`), the MLP column-
and row-parallel (`mlp`), the MoE expert parallel with global routing
(`moe`), the RG-LRU block on each rank's channels (`rglru`) and the SSD
block on its heads (`ssd`), each summing its input's gradient over
`model` once (`place.grad_placed_as_input`) and its output's partial sum
where it joins the residual stream.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from repro_torch.models.config import LayerKind, ModelConfig
from repro_torch.models.layers import (
    attention_decode, attention_prefill, attention_train,
    init_attention_params, init_kv_cache, normal, rms_norm,
)
from repro_torch.models.mlp import init_mlp_params, mlp_apply
from repro_torch.models.moe import init_moe_params, moe_apply
from repro_torch.models.rglru import (
    init_recurrent_cache, init_recurrent_params, recurrent_block_decode,
    recurrent_block_train,
)
from repro_torch.models.ssd import (
    init_ssd_cache, init_ssd_params, ssd_block_decode, ssd_block_train,
)
from repro_torch.sharding.place import (
    grad_placed_as_input, local_offset, placed_as, replicated_like,
)


class Batch(NamedTuple):
    """Training / prefill inputs. `frontend` carries stub modality
    embeddings: vision patches (vlm, prepended) or audio frames (encdec,
    encoder input). Fields unused by an arch are None."""
    tokens: torch.Tensor                      # (B, S) integer
    labels: Optional[torch.Tensor] = None     # (B, S), -1 = masked
    frontend: Optional[torch.Tensor] = None   # (B, F, d) modality embeddings


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


def _moe_head_first(cfg: ModelConfig) -> bool:
    return cfg.arch_type == "moe" and bool(cfg.moe.first_k_dense)


def _stack_kinds(cfg: ModelConfig) -> Tuple[LayerKind, ...]:
    """The kind of each layer of `params["layers"]`, in order."""
    pat, n_groups, _ = stack_plan(cfg)
    return pat * n_groups


def _run_order(cfg: ModelConfig):
    """(kinds, parameter key, cache key) of the two layer lists in the
    order they run: the tail first where it is the MoE head, else last."""
    stack = (_stack_kinds(cfg), "layers", "stack")
    tail = (stack_plan(cfg)[2], "tail", "tail")
    return (tail, stack) if _moe_head_first(cfg) else (stack, tail)


# ---------------------------------------------------------------------------
# per-layer bodies
# ---------------------------------------------------------------------------

def _cross(p: dict, x, cfg: ModelConfig, positions, enc_out):
    """The decoder layer's cross attention over the encoder output (the
    dense branch, `kv_override`)."""
    return x + attention_train(p["cross"], rms_norm(x, p["norm_x"],
                                                    cfg.norm_eps),
                               cfg, positions=positions, kv_override=enc_out)


def _layer_train(kind: LayerKind, p: dict, x, cfg: ModelConfig, positions,
                 enc_out, use_kernel):
    """Returns (x, aux_loss_scalar)."""
    aux = replicated_like(torch.zeros((), dtype=torch.float32,
                                      device=x.device), x)
    if kind in ("attn", "local_attn"):
        x = x + attention_train(p["attn"], rms_norm(x, p["norm1"],
                                                    cfg.norm_eps),
                                cfg, positions=positions, window=cfg.window,
                                use_kernel=use_kernel)
        if enc_out is not None:
            x = _cross(p, x, cfg, positions, enc_out)
        x = x + mlp_apply(p["mlp"], rms_norm(x, p["norm2"], cfg.norm_eps),
                          cfg.mlp_act)
    elif kind == "moe":
        x = x + attention_train(p["attn"], rms_norm(x, p["norm1"],
                                                    cfg.norm_eps),
                                cfg, positions=positions, window=cfg.window,
                                use_kernel=use_kernel)
        h, moe_aux = moe_apply(p["moe"], rms_norm(x, p["norm2"], cfg.norm_eps),
                               cfg)
        # the two losses summed first: on DTensors both are partial sums
        # (`moe._moe_apply_sharded`), all-reduced once where they join
        aux = aux + (cfg.moe.router_aux_weight * moe_aux["moe_aux_loss"]
                     + cfg.moe.router_z_weight * moe_aux["moe_z_loss"])
        x = x + h
    elif kind == "recurrent":
        x = x + recurrent_block_train(p["rec"], rms_norm(x, p["norm1"],
                                                         cfg.norm_eps), cfg)
        x = x + mlp_apply(p["mlp"], rms_norm(x, p["norm2"], cfg.norm_eps),
                          cfg.mlp_act)
    elif kind == "ssd":
        x = x + ssd_block_train(p["ssd"], rms_norm(x, p["norm1"],
                                                   cfg.norm_eps), cfg)
    else:
        raise ValueError(kind)
    return x, aux


def _ffn(kind: LayerKind, p: dict, x, cfg: ModelConfig):
    """The second half of an attention or MoE layer."""
    xn = rms_norm(x, p["norm2"], cfg.norm_eps)
    if kind == "moe":
        return x + moe_apply(p["moe"], xn, cfg)[0]
    return x + mlp_apply(p["mlp"], xn, cfg.mlp_act)


def _layer_prefill(kind: LayerKind, p: dict, x, cfg: ModelConfig, positions,
                   cache_len, enc_out, use_kernel):
    """Returns (x, cache) — the cache's type depends on the layer kind."""
    if kind in ("attn", "local_attn", "moe"):
        h, cache = attention_prefill(p["attn"],
                                     rms_norm(x, p["norm1"], cfg.norm_eps),
                                     cfg, positions=positions,
                                     window=cfg.window, cache_len=cache_len,
                                     use_kernel=use_kernel)
        x = x + h
        if enc_out is not None:
            x = _cross(p, x, cfg, positions, enc_out)
        return _ffn(kind, p, x, cfg), cache
    if kind == "recurrent":
        h, cache = recurrent_block_train(
            p["rec"], rms_norm(x, p["norm1"], cfg.norm_eps), cfg,
            with_cache=True)
        x = x + h
        x = x + mlp_apply(p["mlp"], rms_norm(x, p["norm2"], cfg.norm_eps),
                          cfg.mlp_act)
        return x, cache
    if kind == "ssd":
        h, cache = ssd_block_train(
            p["ssd"], rms_norm(x, p["norm1"], cfg.norm_eps), cfg,
            with_cache=True)
        return x + h, cache
    raise ValueError(kind)


def _layer_decode(kind: LayerKind, p: dict, x, cfg: ModelConfig, pos, cache,
                  enc_out):
    if kind in ("attn", "local_attn", "moe"):
        h, new_cache = attention_decode(p["attn"],
                                        rms_norm(x, p["norm1"], cfg.norm_eps),
                                        cfg, position=pos, cache=cache,
                                        window=cfg.window)
        x = x + h
        if enc_out is not None:
            # k and v from the whole encoder output again at every step,
            # positions unused (no RoPE across), as the reference does
            x = _cross(p, x, cfg, torch.zeros((1,), device=x.device),
                       enc_out)
        return _ffn(kind, p, x, cfg), new_cache
    if kind == "recurrent":
        h, new_cache = recurrent_block_decode(
            p["rec"], rms_norm(x, p["norm1"], cfg.norm_eps), cfg, cache)
        x = x + h
        x = x + mlp_apply(p["mlp"], rms_norm(x, p["norm2"], cfg.norm_eps),
                          cfg.mlp_act)
        return x, new_cache
    if kind == "ssd":
        h, new_cache = ssd_block_decode(
            p["ssd"], rms_norm(x, p["norm1"], cfg.norm_eps), cfg, cache)
        return x + h, new_cache
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# parameters and caches
# ---------------------------------------------------------------------------

def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def _init_layer(gen: torch.Generator, kind: LayerKind, cfg: ModelConfig,
                dtype, cross: bool = False) -> dict:
    d, dev = cfg.d_model, gen.device

    def zeros():
        return torch.zeros((d,), dtype=dtype, device=dev)

    p: dict = {"norm1": zeros()}
    if kind in ("attn", "local_attn"):
        p["attn"] = init_attention_params(gen, cfg, dtype)
        p["mlp"] = init_mlp_params(gen, cfg, cfg.d_ff, dtype)
        p["norm2"] = zeros()
    elif kind == "moe":
        p["attn"] = init_attention_params(gen, cfg, dtype)
        p["moe"] = init_moe_params(gen, cfg, dtype)
        p["norm2"] = zeros()
    elif kind == "recurrent":
        p["rec"] = init_recurrent_params(gen, cfg, dtype)
        p["mlp"] = init_mlp_params(gen, cfg, cfg.d_ff, dtype)
        p["norm2"] = zeros()
    elif kind == "ssd":
        p["ssd"] = init_ssd_params(gen, cfg, dtype)
    else:
        raise ValueError(kind)
    if cross:
        p["cross"] = init_attention_params(gen, cfg, dtype)
        p["norm_x"] = zeros()
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    """Random parameters from `gen`, on its device: the reference's
    distributions and scales (N(0, 1) · d^-1/2 for the embedding and the
    head, zeros for the norm scales; each block's as its `init_*`), not
    its random bits.

    {"embed": (V_pad, d), "final_norm": (d,), "layers": [per-layer dicts
    of the stack, in order], "tail": [...] where the plan has one,
    "head": (d, V_pad) unless tied, "encoder": {"layers": [...],
    "final_norm"} for enc-dec}."""
    dtype = _dtype(cfg.param_dtype)
    d, dev = cfg.d_model, gen.device
    _, _, tail = stack_plan(cfg)
    params = {
        "embed": normal(gen, (cfg.padded_vocab, d), d ** -0.5, dtype),
        "final_norm": torch.zeros((d,), dtype=dtype, device=dev),
        "layers": [_init_layer(gen, kind, cfg, dtype,
                               cross=cfg.cross_attention)
                   for kind in _stack_kinds(cfg)],
    }
    if not cfg.tie_embeddings:
        params["head"] = normal(gen, (d, cfg.padded_vocab), d ** -0.5, dtype)
    if tail:
        params["tail"] = [_init_layer(gen, kind, cfg, dtype,
                                      cross=cfg.cross_attention)
                          for kind in tail]
    if cfg.arch_type == "encdec":
        params["encoder"] = {
            "layers": [_init_layer(gen, "attn", cfg, dtype)
                       for _ in range(cfg.n_encoder_layers)],
            "final_norm": torch.zeros((d,), dtype=dtype, device=dev),
        }
    return params


def _init_layer_cache(kind: LayerKind, cfg: ModelConfig, batch: int,
                      cache_len: int, device):
    if kind in ("attn", "local_attn", "moe"):
        L = min(cache_len, cfg.window) if cfg.window else cache_len
        return init_kv_cache(batch, L, cfg.n_kv_heads, cfg.resolved_head_dim,
                             dtype=_dtype(cfg.compute_dtype), device=device)
    if kind == "recurrent":
        return init_recurrent_cache(batch, cfg, device)
    if kind == "ssd":
        return init_ssd_cache(batch, cfg, device)
    raise ValueError(kind)


def init_caches(cfg: ModelConfig, batch: int, cache_len: int,
                device="cuda") -> dict:
    """Decode caches shaped like forward_prefill's output (fresh/empty)."""
    _, _, tail = stack_plan(cfg)
    enc_out = None
    if cfg.arch_type == "encdec":
        enc_out = torch.zeros((batch, cfg.n_frontend_tokens, cfg.d_model),
                              dtype=_dtype(cfg.compute_dtype), device=device)
    return {"stack": [_init_layer_cache(k, cfg, batch, cache_len, device)
                      for k in _stack_kinds(cfg)],
            "tail": [_init_layer_cache(k, cfg, batch, cache_len, device)
                     for k in tail],
            "enc_out": enc_out}


# ---------------------------------------------------------------------------
# forward passes
# ---------------------------------------------------------------------------

def _embed(params, cfg, tokens):
    table = params["embed"]
    if isinstance(table, DTensor) and \
            Shard(0) in table.placements:
        return _embed_vocab_parallel(table, tokens).to(
            _dtype(cfg.compute_dtype))
    return table[tokens].to(_dtype(cfg.compute_dtype))


def _embed_vocab_parallel(table: DTensor, tokens: DTensor) -> DTensor:
    """The lookup of a table whose rows (the vocabulary) are split over a
    mesh dim (Megatron's vocab-parallel embedding): each rank looks up the
    tokens that fall in its rows and gives 0 for the rest, so the result
    is partial over that dim (summed where it joins the residual stream,
    `_inputs`) and a rank's gradient falls on its own rows. DTensor's own
    lookup would move the table to a split of d instead (an all-to-all of
    the table) and gather the embeddings over d."""
    mesh, tp = table.device_mesh, list(table.placements)
    xp = list(tokens.placements)
    split = [j for j, p in enumerate(tp) if p == Shard(0)]
    if len(split) != 1 or any(p.is_shard() and p.dim != 0 for p in tp):
        raise ValueError(f"embedding placed {tp}: one mesh dim may split "
                         "the vocabulary, none d")
    j = split[0]

    def lookup(tab, tok):
        n = tab.shape[0]
        idx = tok.long() - mesh.get_local_rank(j) * n
        inside = (idx >= 0) & (idx < n)
        rows = tab[torch.clamp(idx, 0, n - 1)]
        return torch.where(inside[..., None], rows, 0.0)

    out = [Partial() if i == j else p for i, p in enumerate(xp)]
    # the table's gradient: its own rows, summed over the ranks that
    # split the batch
    grad = [Partial() if x.is_shard() else p for p, x in zip(tp, xp)]
    return local_map(lookup, out_placements=out, in_placements=(tp, xp),
                     in_grad_placements=(grad, xp),
                     device_mesh=mesh)(table, tokens)


def _unembed(params, cfg, x):
    x = grad_placed_as_input(x)
    head = params["head"] if "head" in params else params["embed"].T
    return torch.einsum("bsd,dv->bsv", x, head.to(x.dtype))


def _positions(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[1], device=x.device)


def _encoder_forward(params, cfg: ModelConfig, frames: torch.Tensor,
                     use_kernel):
    """Bidirectional encoder over stub audio-frame embeddings (B, F, d)."""
    x = frames.to(_dtype(cfg.compute_dtype))
    positions = _positions(x)
    enc = params["encoder"]
    for lp in enc["layers"]:
        x = x + attention_train(lp["attn"],
                                rms_norm(x, lp["norm1"], cfg.norm_eps), cfg,
                                positions=positions, causal=False,
                                use_kernel=use_kernel)
        x = x + mlp_apply(lp["mlp"], rms_norm(x, lp["norm2"], cfg.norm_eps),
                          cfg.mlp_act)
    return rms_norm(x, enc["final_norm"], cfg.norm_eps)


def _inputs(params, cfg: ModelConfig, batch: Batch, use_kernel):
    """(x, enc_out): the token embeddings, the VLM's patches prepended,
    and the encoder's output for enc-dec (else None)."""
    # on DTensors, the embeddings placed as the tokens (the batch over
    # the data axes, d whole: summed over a vocab-sharded table's ranks)
    x = placed_as(_embed(params, cfg, batch.tokens), batch.tokens)
    enc_out = None
    if cfg.arch_type == "encdec":
        enc_out = _encoder_forward(params, cfg, batch.frontend, use_kernel)
    elif cfg.arch_type == "vlm" and batch.frontend is not None:
        x = torch.cat([batch.frontend.to(x.dtype), x], dim=1)
    return x, enc_out


def _decoder_stack_train(params, cfg: ModelConfig, x, enc_out, use_kernel,
                         remat: bool = False):
    """The stack in its run order; with `remat` (and a gradient to take)
    each group of `stack_plan`'s pattern in `params["layers"]` runs under
    a checkpoint, the tail does not."""
    positions = _positions(x)
    aux_total = replicated_like(torch.zeros((), dtype=torch.float32,
                                            device=x.device), x)
    group = len(stack_plan(cfg)[0])

    def run(layers, kinds, x, aux_total):
        for lp, kind in zip(layers, kinds):
            x, aux = _layer_train(kind, lp, x, cfg, positions, enc_out,
                                  use_kernel)
            aux_total = aux_total + aux
        return x, aux_total

    remat = remat and torch.is_grad_enabled()
    for kinds, key, _ in _run_order(cfg):
        layers = params.get(key, [])
        if key != "layers" or not remat:
            x, aux_total = run(layers, kinds, x, aux_total)
            continue
        for g in range(0, len(layers), group):
            x, aux_total = checkpoint(run, layers[g:g + group],
                                      kinds[g:g + group], x, aux_total,
                                      use_reentrant=False)
    return x, aux_total


def forward_train(params, cfg: ModelConfig, batch: Batch, *,
                  remat: bool = True, use_kernel: bool | None = None):
    """Full-sequence forward. Returns (logits (B,S,V), aux_loss): the
    MoE layers' router_aux_weight · balance loss + router_z_weight ·
    z-loss, summed (0 without MoE). Differentiable in the parameters;
    `remat` checkpoints each scanned group of layers, as the reference's
    `jax.checkpoint` does, where a gradient is taken."""
    x, enc_out = _inputs(params, cfg, batch, use_kernel)
    x, aux = _decoder_stack_train(params, cfg, x, enc_out, use_kernel,
                                  remat)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if cfg.arch_type == "vlm" and batch.frontend is not None:
        x = x[:, batch.frontend.shape[1]:]    # loss only on token positions
    return _unembed(params, cfg, x), aux


@torch.no_grad()
def forward_features(params, cfg: ModelConfig, batch: Batch, *,
                     remat: bool = False,
                     use_kernel: bool | None = None) -> torch.Tensor:
    """Final-norm hidden states (B, S, d) — the feature interface used by
    multitask.sparse_probe (DSML heads on any backbone); for the VLM the
    patches' positions come first, as in the reference. `remat` has no
    effect here."""
    x, enc_out = _inputs(params, cfg, batch, use_kernel)
    x, _ = _decoder_stack_train(params, cfg, x, enc_out, use_kernel)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


@torch.no_grad()
def forward_prefill(params, cfg: ModelConfig, batch: Batch, *,
                    cache_len: Optional[int] = None,
                    use_kernel: bool | None = None):
    """Causal prompt pass. Returns (last-position logits, caches). As in
    the reference, these logits are not masked for the padded vocabulary
    (decode's are)."""
    x, enc_out = _inputs(params, cfg, batch, use_kernel)
    positions = _positions(x)
    cl = cache_len or x.shape[1]
    caches = {"stack": [], "tail": [], "enc_out": enc_out}
    for kinds, key, name in _run_order(cfg):
        for lp, kind in zip(params.get(key, []), kinds):
            x, c = _layer_prefill(kind, lp, x, cfg, positions, cl, enc_out,
                                  use_kernel)
            caches[name].append(c)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _unembed(params, cfg, x[:, -1:]), caches


@torch.no_grad()
def forward_decode(params, cfg: ModelConfig, token: torch.Tensor, pos,
                   caches: dict):
    """One decode step. token: (B, 1) integer; pos: an int.

    Returns (logits (B,1,V), new caches). The attention caches' tensors
    are updated in place (`layers.attention_decode`); the recurrent and
    SSD caches are new, as the reference's."""
    x = placed_as(_embed(params, cfg, token), token)
    enc_out = caches.get("enc_out")
    new = {"stack": [], "tail": [], "enc_out": enc_out}
    for kinds, key, name in _run_order(cfg):
        for lp, kind, c in zip(params.get(key, []), kinds, caches[name]):
            x, nc = _layer_decode(kind, lp, x, cfg, pos, c, enc_out)
            new[name].append(nc)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _unembed(params, cfg, x)
    if cfg.padded_vocab != cfg.vocab:
        logits = _mask_padded_vocab(logits, cfg.vocab)
    return logits, new


def _mask_padded_vocab(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """`logits` with columns `vocab` and beyond set to the dtype's lowest
    value, in place; on DTensor logits split over the vocabulary each
    rank masks its own block by global column (the padded columns may
    fall inside one rank's block, as granite-3-2b's 49155 of 49408), a
    partial sum summed first."""
    low = torch.finfo(logits.dtype).min
    if not isinstance(logits, DTensor):
        logits[..., vocab:] = low
        return logits
    if any(p.is_partial() for p in logits.placements):
        logits = logits.redistribute(
            logits.device_mesh, [Replicate() if p.is_partial() else p
                                 for p in logits.placements])
    local = logits.to_local()
    start = max(0, vocab - local_offset(logits, logits.ndim - 1))
    local[..., start:] = low
    return logits
