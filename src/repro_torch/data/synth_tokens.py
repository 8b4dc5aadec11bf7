"""Synthetic token pipeline: a learnable bigram-ish language so the loss
actually falls (pure-noise tokens would bottom out at log V immediately).

The port of the JAX package's `data/synth_tokens.py`. Sequences follow a
random sparse Markov chain over the vocabulary: each token has 4
successors (`nxt`) drawn with fixed logits, both drawn once from the
generator, so a model can learn the chain. Each batch starts from
uniform tokens and draws every next token from its row's logits (the
Gumbel-max draw `jax.random.categorical` makes); labels are the tokens
shifted by one, -1 at the end; the stub frontend is 0.1 · N(0, 1).
Everything comes from the one `torch.Generator`, on its device, so the
same seed gives the same stream; the bits are not the reference's (the
two RNGs differ). For the sharded step every rank draws the same global
stream from the seed and keeps its block of each batch
(`sharded_lm_batches`), so no batch is sent between ranks.
"""
from __future__ import annotations

from typing import Iterator, Optional

import torch

from repro_torch.models import Batch
from repro_torch.sharding.place import distribute_tree
from repro_torch.sharding.rules import batch_pspecs

BRANCHING = 4


def _markov_params(gen: torch.Generator, vocab: int,
                   branching: int = BRANCHING):
    dev = gen.device
    nxt = torch.randint(0, vocab, (vocab, branching), generator=gen,
                        device=dev)
    logits = torch.randn((vocab, branching), generator=gen, device=dev)
    return nxt, logits


def _gumbel(gen: torch.Generator, shape) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=gen.device)
    u = torch.clamp_min(u, torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def synthetic_lm_batches(gen: torch.Generator, *, vocab: int, batch: int,
                         seq: int, frontend_shape: Optional[tuple] = None
                         ) -> Iterator[Batch]:
    """Yields Batch(tokens, labels[, frontend]) forever: tokens and labels
    (batch, seq) int32 on `gen`'s device, frontend (batch,
    *frontend_shape) f32 where a shape is given."""
    nxt, logits = _markov_params(gen, vocab)
    while True:
        tok = torch.randint(0, vocab, (batch,), generator=gen,
                            device=gen.device)
        noise = _gumbel(gen, (seq - 1, batch, nxt.shape[1]))
        toks = [tok]
        for t in range(seq - 1):
            choice = torch.argmax(logits[tok] + noise[t], dim=-1)
            tok = nxt[tok, choice]
            toks.append(tok)
        tokens = torch.stack(toks, dim=1).to(torch.int32)   # (batch, seq)
        labels = torch.cat([tokens[:, 1:],
                            torch.full((batch, 1), -1, dtype=torch.int32,
                                       device=gen.device)], dim=1)
        fe = None
        if frontend_shape is not None:
            fe = 0.1 * torch.randn((batch, *frontend_shape), generator=gen,
                                   device=gen.device)
        yield Batch(tokens=tokens, labels=labels, frontend=fe)


def sharded_lm_batches(gen: torch.Generator, mesh, *, vocab: int,
                       batch: int, seq: int,
                       frontend_shape: Optional[tuple] = None
                       ) -> Iterator[Batch]:
    """`synthetic_lm_batches`' global batches (every rank draws the same
    stream from `gen`'s seed), each leaf a DTensor on `mesh` placed by
    `batch_pspecs` (rows over the data axes) from this rank's own copy."""
    specs = batch_pspecs(mesh, batch, frontend_shape is not None)
    for b in synthetic_lm_batches(gen, vocab=vocab, batch=batch, seq=seq,
                                  frontend_shape=frontend_shape):
        yield distribute_tree(b, specs, mesh)
