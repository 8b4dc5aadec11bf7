"""Serving steps: prefill and single-token decode, plus a simple batched
greedy engine (the port of the JAX package's `serving/engine.py`).

The two steps also run sharded, as the reference's dry run lowers them:
on parameters placed by `rules.param_pspecs`, a batch (or a token) by
`batch_pspecs` and caches by `cache_pspecs` (DTensors, one process a
rank). The prefill's caches come out placed by `cache_pspecs`, and the
decode step's next token is the argmax of the vocab-split logits
(`sharding.place.argmax_last`, the lowest index winning a tie)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import (
    Batch, forward_decode, forward_prefill,
)
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.place import argmax_last


def frontend_offset(cfg: ModelConfig,
                    frontend: Optional[torch.Tensor]) -> int:
    """The cache positions the VLM's stub patches take ahead of the
    prompt (0 for the other families, or without a frontend): decode
    positions start after them."""
    return cfg.n_frontend_tokens \
        if cfg.arch_type == "vlm" and frontend is not None else 0


def make_prefill_step(cfg: ModelConfig, cache_len: Optional[int] = None,
                      use_kernel: bool | None = None):
    def prefill_step(params, batch: Batch):
        return forward_prefill(params, cfg, batch, cache_len=cache_len,
                               use_kernel=use_kernel)
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """ONE new token against a pre-existing KV/state cache."""
    def serve_step(params, token, pos, caches):
        logits, caches = forward_decode(params, cfg, token, pos, caches)
        return argmax_last(logits[:, -1]), logits, caches
    return serve_step


@torch.no_grad()
def greedy_generate(params, cfg: ModelConfig, prompt: torch.Tensor,
                    steps: int, cache_extra: int = 0,
                    frontend: Optional[torch.Tensor] = None,
                    use_kernel: bool | None = None) -> torch.Tensor:
    """Batched greedy decoding. prompt: (B, S) -> (B, S + steps), in the
    prompt's dtype.

    The prefill's last logits already yield token 0, so only steps - 1
    decode iterations run (the reference's rule: an earlier version of it
    decoded a `steps`-th token only to slice it away). `frontend` is the
    stub modality input (the VLM's patches, prepended: the cache holds
    them and decode positions start after them; the enc-dec's audio
    frames, the encoder's input). `cache_extra` pads the cache past the
    written range — decode writes stop at position S + off + steps - 2 —
    so it never shifts positions or tokens; `steps=0` returns the prompt
    unchanged (the prefill still runs, as in the reference). `use_kernel`
    goes to the prefill's flash kernel; decode runs no kernel.
    """
    B, S = prompt.shape
    off = frontend_offset(cfg, frontend)
    cache_len = S + off + steps + cache_extra
    logits, caches = forward_prefill(params, cfg,
                                     Batch(tokens=prompt, frontend=frontend),
                                     cache_len=cache_len,
                                     use_kernel=use_kernel)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    serve_step = make_serve_step(cfg)
    toks = [tok]
    for i in range(max(steps - 1, 0)):
        tok, _, caches = serve_step(params, tok[:, None], S + off + i, caches)
        toks.append(tok)
    gen = torch.stack(toks, dim=1)[:, :steps].to(prompt.dtype)
    return torch.cat([prompt, gen], dim=1)
