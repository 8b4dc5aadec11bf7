"""Training step: cross-entropy loss + AdamW update, on one card.

The port of the JAX package's `training/step.py`. `make_train_step(cfg)`
returns a function

    train_step(state, batch) -> (state, metrics)

which takes the gradient of `forward_train`'s loss with `torch.autograd`
(`remat` checkpoints each scanned group of layers, as the reference's
`jax.checkpoint`), accumulates microbatches in f32 in a loop (the
reference's `lax.scan`), and applies `optim.adamw.adamw_update`, which
writes the new parameters and optimizer state into the state's tensors
(the reference donates them to its jitted step). Metrics: the loss over
the microbatches, the last microbatch's `ce` and `aux`, `grad_norm` and
`lr`, each a 0-d f32 tensor on the state's device.

The reference's `logits_pspec` and `grads_pspec` are sharding
constraints of its mesh; the one-card step has none (the sharding rules
are not ported yet, `ROADMAP.md` queue A).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models import Batch, forward_train, init_params
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import (
    AdamWState, adamw_init, adamw_update, warmup_cosine,
)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

NEG_INF = -1e30


class TrainState(NamedTuple):
    params: dict
    opt: AdamWState
    step: torch.Tensor          # 0-d int32


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                  vocab: Optional[int] = None) -> torch.Tensor:
    """Token-mean CE in float32; labels == -1 are masked out.

    logits: (B, S, Vp), possibly padded past `vocab` (the pad columns are
    masked at -1e30, so the loss is exact); labels: (B, S)."""
    logits = logits.to(torch.float32)
    if vocab is not None and vocab < logits.shape[-1]:
        pad_mask = torch.arange(logits.shape[-1], device=logits.device) < vocab
        logits = torch.where(pad_mask, logits, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1,
                      torch.clamp_min(labels, 0).long()[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    nll = (lse - ll) * mask
    return torch.sum(nll) / torch.clamp_min(torch.sum(mask), 1.0)


def make_loss_fn(cfg: ModelConfig, *, remat: bool = True,
                 use_kernel: bool | None = None):
    """loss_fn(params, batch) -> (ce + aux, {"ce", "aux"});
    `use_kernel` goes to the flash kernel's wrapper."""
    def loss_fn(params, batch: Batch):
        logits, aux = forward_train(params, cfg, batch, remat=remat,
                                    use_kernel=use_kernel)
        ce = cross_entropy(logits, batch.labels, vocab=cfg.vocab)
        return ce + aux, {"ce": ce, "aux": aux}
    return loss_fn


def make_grad_fn(cfg: ModelConfig, *, remat: bool = True,
                 use_kernel: bool | None = None):
    """grad_fn(params, batch) -> (loss, parts, grads): `make_loss_fn`'s
    loss and parts (detached) and its gradient, a tree like `params` in
    the parameters' dtypes (zeros for a parameter the loss does not
    reach). The parameters are read through detached aliases, so their
    own `requires_grad` is left as it is."""
    loss_fn = make_loss_fn(cfg, remat=remat, use_kernel=use_kernel)

    def grad_fn(params, batch: Batch):
        aliases = tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = tree_leaves(aliases)
        loss, parts = loss_fn(aliases, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return (loss.detach(), {k: v.detach() for k, v in parts.items()},
                tree_unflatten(params, grads))
    return grad_fn


def make_train_step(cfg: ModelConfig, *, peak_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10000,
                    weight_decay: float = 0.1, clip_norm: float = 1.0,
                    remat: bool = True, microbatches: int = 1):
    """`microbatches > 1` accumulates the gradients of that many slices of
    the batch in f32 (peak activation memory drops by the same factor),
    as the reference's scan does."""
    grad_fn = make_grad_fn(cfg, remat=remat)

    def train_step(state: TrainState, batch: Batch):
        if microbatches > 1:
            def split(x, i):
                if x is None:
                    return None
                n = x.shape[0] // microbatches
                return x.reshape(microbatches, n, *x.shape[1:])[i]

            loss = torch.zeros((), dtype=torch.float32,
                               device=state.step.device)
            grads = tree_map(lambda p: torch.zeros(p.shape,
                                                   dtype=torch.float32,
                                                   device=p.device),
                             state.params)
            for i in range(microbatches):
                loss_i, parts, grads_i = grad_fn(
                    state.params, Batch(*(split(x, i) for x in batch)))
                # in place: a + g into a's memory, the f32 accumulator
                for a, g in zip(tree_leaves(grads), tree_leaves(grads_i)):
                    a.add_(g.to(torch.float32))
                del grads_i
                loss = loss + loss_i
            loss = loss / microbatches
            for g in tree_leaves(grads):
                g.div_(microbatches)
        else:
            loss, parts, grads = grad_fn(state.params, batch)

        lr = warmup_cosine(state.step, peak_lr=peak_lr, warmup=warmup,
                           total=total_steps)
        with torch.profiler.record_function("optim.adamw_update"):
            params, opt, opt_metrics = adamw_update(
                grads, state.opt, state.params, lr=lr,
                weight_decay=weight_decay, clip_norm=clip_norm)
        metrics = {"loss": loss, **parts, **opt_metrics}
        return TrainState(params, opt, state.step + 1), metrics

    return train_step


def init_train_state(gen: torch.Generator, cfg: ModelConfig) -> TrainState:
    """Random parameters from `gen` (`init_params`: the reference's
    distributions, not its bits) on `gen`'s device, their AdamW state and
    step 0."""
    params = init_params(gen, cfg)
    return TrainState(params=params, opt=adamw_init(params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=gen.device))
