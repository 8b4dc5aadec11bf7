"""Serving steps: prefill and single-token decode, plus a simple batched
greedy engine (the port of the JAX package's `serving/engine.py`)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import (
    Batch, forward_decode, forward_prefill,
)
from repro_torch.models.config import ModelConfig


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
        next_token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_token, logits, caches
    return serve_step


@torch.no_grad()
def greedy_generate(params, cfg: ModelConfig, prompt: torch.Tensor,
                    steps: int, cache_extra: int = 0,
                    use_kernel: bool | None = None) -> torch.Tensor:
    """Batched greedy decoding. prompt: (B, S) -> (B, S + steps), in the
    prompt's dtype.

    The prefill's last logits already yield token 0, so only steps - 1
    decode iterations run (the reference's rule: an earlier version of it
    decoded a `steps`-th token only to slice it away). `cache_extra` pads
    the cache past the written range — decode writes stop at position
    S + steps - 2 — so it never shifts positions or tokens; `steps=0`
    returns the prompt unchanged (the prefill still runs, as in the
    reference). `use_kernel` goes to the prefill's flash kernel; decode
    runs no kernel. The reference's `frontend` (VLM patches) comes with
    the VLM stack, ROADMAP queue A item 7.
    """
    B, S = prompt.shape
    cache_len = S + steps + cache_extra
    logits, caches = forward_prefill(params, cfg, Batch(tokens=prompt),
                                     cache_len=cache_len,
                                     use_kernel=use_kernel)
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    serve_step = make_serve_step(cfg)
    toks = [tok]
    for i in range(max(steps - 1, 0)):
        tok, _, caches = serve_step(params, tok[:, None], S + i, caches)
        toks.append(tok)
    gen = torch.stack(toks, dim=1)[:, :steps].to(prompt.dtype)
    return torch.cat([prompt, gen], dim=1)
