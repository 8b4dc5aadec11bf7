"""Training step: cross-entropy loss + AdamW update, on one card or
sharded.

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

Sharded, as the reference's jit of the same step under a mesh: the
state is a tree of DTensors (`shard_train_state`,
`init_sharded_train_state`: parameters by `sharding.rules.param_pspecs`,
AdamW's master and moments by `opt_pspecs`, ZeRO-1), the batch is
placed by `batch_pspecs`, and DTensor carries the forward and the
backward (the model code adds the constraints it cannot infer:
`sharding.place`). The reference's sharding constraints become
`logits_pspec` (the logits placed before the loss: vocabulary-parallel
cross entropy, the token mean taken over the global batch) and
`grads_pspec` (each f32 gradient, and the microbatch accumulator,
placed as the master: a reduce-scatter over `data`). The metrics are
then plain tensors, the same on every rank. Every family runs so, at any
(data, model) mesh the rules allow: the blocks DTensor does not carry
by itself (the MoE's routing, the RG-LRU and SSD scans) run on each
rank's local tensors inside the model (`sharding.place.on_local`).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
from torch.distributed.tensor import (
    DTensor, Partial, Replicate, Shard,
)
from torch.distributed.tensor import zeros as dtensor_zeros
from torch.distributed.tensor.experimental import local_map

from repro_torch.models import Batch, forward_train, init_params
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import (
    AdamWState, adamw_init, adamw_update, warmup_cosine,
)
from repro_torch.sharding.place import (
    constrain, distribute_tree, full, local, place,
    replicated_like,
)
from repro_torch.sharding.rules import (
    opt_pspecs, param_pspecs, placements,
)
from repro_torch.tree import named_leaves, tree_leaves, tree_map, tree_unflatten

NEG_INF = -1e30


class TrainState(NamedTuple):
    params: dict
    opt: AdamWState
    step: torch.Tensor          # 0-d int32


def _sharded_lse_ll(logits: DTensor, labels: DTensor):
    """Each row's log-sum-exp and its label's logit, for DTensor logits
    placed as `logits_pspec` places them, the vocabulary split over
    `model` included, without gathering the (B, S, V) logits: the row max
    and the sum of exponentials are reduced over the vocabulary's ranks,
    and each rank picks the labels that fall in its slice of the
    vocabulary (`local_map`), 0 elsewhere, summed over the same ranks.
    Both come back placed as the labels. The reference's formula
    (max + log Σ exp(x − max), the max without a gradient), in another
    order of summation; where no mesh dim of more than one rank splits
    the vocabulary, each rank's rows' `torch.logsumexp`, as the
    unsharded step's."""
    mesh, lp = logits.device_mesh, list(logits.placements)
    vdim = logits.ndim - 1
    row = [Replicate() if p == Shard(vdim) else p for p in lp]
    split = [j for j, p in enumerate(lp) if p == Shard(vdim)]

    def rows(t):
        return t.redistribute(mesh, row)

    if all(mesh.size(j) == 1 for j in split):
        lse = local_map(functools.partial(torch.logsumexp, dim=-1),
                        out_placements=row, in_placements=(lp,),
                        device_mesh=mesh)(logits)
    else:
        m = rows(torch.amax(logits, dim=-1, keepdim=True)).detach()
        lse = (m + torch.log(rows(torch.sum(torch.exp(logits - m), dim=-1,
                                            keepdim=True))))[..., 0]

    def picked(lg, lab):
        n = lg.shape[-1]
        lo = mesh.get_local_rank(split[0]) * n if split else 0
        idx = torch.clamp_min(lab, 0).long() - lo
        got = torch.gather(lg, -1, torch.clamp(idx, 0, n - 1)[..., None])
        return torch.where((idx >= 0) & (idx < n), got[..., 0], 0.0)

    ll = local_map(picked, out_placements=[Partial() if p == Shard(vdim)
                                           else p for p in lp],
                   in_placements=(lp, row), device_mesh=mesh,
                   redistribute_inputs=True)(logits, labels)
    return lse, rows(ll)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                  pspec=None, vocab: Optional[int] = None) -> torch.Tensor:
    """Token-mean CE in float32; labels == -1 are masked out.

    logits: (B, S, Vp), possibly padded past `vocab` (the pad columns are
    masked at -1e30, so the loss is exact); labels: (B, S). On DTensors
    (the sharded step) the logits are first placed by `pspec` (a
    `rules.NamedSharding`, the reference's sharding constraint), and the
    mean is over the global batch: the masked sum and the count of valid
    labels are each summed over the data axes before the division."""
    if pspec is not None:
        logits = constrain(logits, pspec)
    logits = logits.to(torch.float32)
    if vocab is not None and vocab < logits.shape[-1]:
        pad_mask = torch.arange(logits.shape[-1], device=logits.device) < vocab
        logits = torch.where(replicated_like(pad_mask, logits), logits,
                             NEG_INF)
    if isinstance(logits, DTensor):
        lse, ll = _sharded_lse_ll(logits, labels)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1,
                          torch.clamp_min(labels, 0).long()[..., None])[..., 0]
    mask = (labels >= 0).to(torch.float32)
    nll = (lse - ll) * mask
    return torch.sum(nll) / torch.clamp_min(torch.sum(mask), 1.0)


def make_loss_fn(cfg: ModelConfig, *, remat: bool = True,
                 logits_pspec=None, use_kernel: bool | None = None):
    """loss_fn(params, batch) -> (ce + aux, {"ce", "aux"});
    `logits_pspec` places sharded logits (`cross_entropy`), `use_kernel`
    goes to the flash kernel's wrapper."""
    def loss_fn(params, batch: Batch):
        logits, aux = forward_train(params, cfg, batch, remat=remat,
                                    use_kernel=use_kernel)
        ce = cross_entropy(logits, batch.labels, pspec=logits_pspec,
                           vocab=cfg.vocab)
        return ce + aux, {"ce": ce, "aux": aux}
    return loss_fn


def make_grad_fn(cfg: ModelConfig, *, remat: bool = True,
                 logits_pspec=None, use_kernel: bool | None = None):
    """grad_fn(params, batch) -> (loss, parts, grads): `make_loss_fn`'s
    loss and parts (detached; on DTensors their global values, plain
    tensors) and its gradient, a tree like `params` in the parameters'
    dtypes (zeros for a parameter the loss does not reach; on DTensors,
    placed as DTensor's backward leaves them). The parameters are read
    through detached aliases, so their own `requires_grad` is left as it
    is. Every family runs on DTensors alike: the model's blocks carry
    their own sharding (`models.backbone`), and the cross entropy is the
    token mean over the global batch."""
    loss_fn = make_loss_fn(cfg, remat=remat, logits_pspec=logits_pspec,
                           use_kernel=use_kernel)

    def grad_fn(params, batch: Batch):
        aliases = tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = tree_leaves(aliases)
        loss, parts = loss_fn(aliases, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        # 0-d results as plain tensors, the same on every rank
        return (full(loss.detach()),
                {k: full(v.detach()) for k, v in parts.items()},
                tree_unflatten(params, grads))
    return grad_fn


def _microbatch(x: Optional[torch.Tensor], i: int, n: int):
    """Rows [i B / n, (i + 1) B / n) of the batch leaf `x`, the
    reference's i-th microbatch; on a DTensor the same global rows,
    placed as `x` (gathered over the data axes and each rank's block
    taken)."""
    if x is None:
        return None
    if not isinstance(x, DTensor):
        return x.reshape(n, x.shape[0] // n, *x.shape[1:])[i]
    whole = full(x)
    rows = whole.reshape(n, whole.shape[0] // n, *whole.shape[1:])[i]
    return place(rows, x.device_mesh, x.placements)


def _f32_zeros(p: torch.Tensor, sharding) -> torch.Tensor:
    """An f32 accumulator for the gradient of `p`, placed by `sharding`
    (a `rules.NamedSharding`) where one is given."""
    if sharding is None:
        return torch.zeros(p.shape, dtype=torch.float32,
                           device=local(p).device)
    return dtensor_zeros(p.shape, dtype=torch.float32,
                         device_mesh=sharding.mesh,
                         placements=sharding.placements)


def make_train_step(cfg: ModelConfig, *, peak_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10000,
                    weight_decay: float = 0.1, clip_norm: float = 1.0,
                    remat: bool = True, logits_pspec=None,
                    microbatches: int = 1, grads_pspec=None):
    """`microbatches > 1` accumulates the gradients of that many slices of
    the batch in f32 (peak activation memory drops by the same factor),
    as the reference's scan does. `grads_pspec` (the ZeRO opt specs as
    `rules.named` gives them) places each f32 gradient, and the
    accumulator, over `data` (a reduce-scatter of the data ranks'
    partial sums), and `logits_pspec` places the logits, as the
    reference's sharding constraints do."""
    grad_fn = make_grad_fn(cfg, remat=remat, logits_pspec=logits_pspec)
    shard_of = (tree_leaves(grads_pspec) if grads_pspec is not None
                else None)

    def placed(leaves: list):
        """Each gradient leaf of `leaves` in f32, placed by `grads_pspec`
        where one is given, one at a time: each entry of `leaves` is
        dropped once its f32 copy is made, so the compute-dtype gradients
        are freed as the f32 ones are made."""
        for i in range(len(leaves)):
            g = leaves[i].to(torch.float32)
            leaves[i] = None
            yield g if shard_of is None else constrain(g, shard_of[i])

    def train_step(state: TrainState, batch: Batch):
        if microbatches > 1:
            loss = torch.zeros((), dtype=torch.float32,
                               device=state.step.device)
            grads = [_f32_zeros(p, None if shard_of is None else shard_of[i])
                     for i, p in enumerate(tree_leaves(state.params))]
            for i in range(microbatches):
                loss_i, parts, grads_i = grad_fn(
                    state.params,
                    Batch(*(_microbatch(x, i, microbatches) for x in batch)))
                flat = tree_leaves(grads_i)
                del grads_i
                # in place: a + g into a's memory, the f32 accumulator
                for a, g in zip(grads, placed(flat)):
                    a.add_(g)
                loss = loss + loss_i
            loss = loss / microbatches
            for g in grads:
                g.div_(microbatches)
            grads = tree_unflatten(state.params, grads)
        else:
            loss, parts, grads = grad_fn(state.params, batch)
            if shard_of is not None:
                flat = tree_leaves(grads)
                del grads
                grads = tree_unflatten(state.params, list(placed(flat)))

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


def init_sharded_train_state(gen: torch.Generator, cfg: ModelConfig,
                             mesh) -> TrainState:
    """`shard_train_state(init_train_state(gen, cfg), mesh)`, the same
    blocks, without the whole f32 state on any rank: every rank draws the
    full parameters from `gen` (the same seed on every rank) and places
    each leaf, its f32 master copy and its zero moments one leaf at a
    time, so a rank holds the whole compute-dtype parameters and its own
    blocks of the rest (granite-3-2b: 5.3 GB, not the 37 GB of the whole
    state)."""
    params = init_params(gen, cfg)
    pspecs = named_leaves(param_pspecs(params, mesh))
    ospecs = named_leaves(opt_pspecs(params, mesh))
    trees: list = [[], [], [], []]
    for name, p in named_leaves(params).items():
        pl = placements(ospecs[name], mesh)
        # adamw_init's master: an f32 copy even of an f32 parameter
        master = place(p.to(torch.float32, copy=True), mesh, pl)
        for tree, t in zip(trees, (
                place(p, mesh, placements(pspecs[name], mesh)), master,
                torch.zeros_like(master), torch.zeros_like(master))):
            tree.append(t)
    params, master, mu, nu = (tree_unflatten(params, t) for t in trees)
    dev = gen.device
    return TrainState(
        params=params,
        opt=AdamWState(master, mu, nu,
                       torch.zeros((), dtype=torch.int32, device=dev)),
        step=torch.zeros((), dtype=torch.int32, device=dev))


def shard_train_state(state: TrainState, mesh) -> TrainState:
    """`state` (every rank's same full copy) on `mesh`: the parameters as
    DTensors placed by `param_pspecs`, the master and moments by
    `opt_pspecs` (ZeRO-1), each rank keeping its own blocks (nothing is
    sent); the counts stay plain 0-d tensors."""
    pspecs = param_pspecs(state.params, mesh)
    ospecs = opt_pspecs(state.params, mesh)
    opt = state.opt
    return TrainState(
        params=distribute_tree(state.params, pspecs, mesh),
        opt=AdamWState(*(distribute_tree(t, ospecs, mesh)
                         for t in (opt.master, opt.mu, opt.nu)), opt.count),
        step=state.step)
