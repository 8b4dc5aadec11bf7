"""AdamW with f32 master weights, global-norm clipping and a
warmup-cosine schedule, in plain PyTorch.

The port of the JAX package's `optim/adamw.py`. The model parameters are
kept in their compute dtype (bf16 at full width); the f32 master copy and
both moments live in `AdamWState`. The update runs the reference's
arithmetic in its order, on the f32 master:

    g = g_f32 · min(1, clip / max(‖g‖, 1e-9))
    mu = b1 · mu + (1 − b1) · g,   nu = b2 · nu + ((1 − b2) · g) · g
    w = (w − lr · (mu / c1) / (sqrt(nu / c2) + eps)) − (lr · wd) · w

with c1 = 1 − b1^count and c2 = 1 − b2^count from the f32 count, and the
parameters cast back to their dtype. It is not `torch.optim.AdamW`, which
keeps no master copy and rounds in another order.

The reference donates the state to its jitted step, so XLA writes the new
master, moments and parameters into the old buffers; here
`adamw_update` does the same explicitly: it writes them into the
tensors of `state` and `params` in place (a copy of each would add the
state's size again: 37 GB for granite-3-2b) and returns those tensors.
The leaves are updated a group at a time with `torch._foreach_*` ops,
one op of the formula at a time, so each element sees the reference's
order of operations; a group holds at most `GROUP_ELEMS` elements, which
bounds the f32 temporaries.

The parameter trees are nested dicts and lists of tensors, as
`models.backbone.init_params` builds them, walked by `repro_torch.tree`
(dict keys in sorted order, as JAX's).

Sharded (ZeRO-1, the reference's scheme): the leaves are DTensors, the
parameters placed by `sharding.rules.param_pspecs` (split over `model`
only, replicated over `data`), the master and the moments by
`opt_pspecs` (split over `data` too). The gradients come placed as the
master (the train step's reduce-scatter over `data`; a gradient placed
otherwise is redistributed first). The update then runs on each rank's
local shards, its groups formed over local elements; `global_norm` is
the norm of the whole tree (each rank sums the squares of the shards it
owns, one all-reduce over the mesh); and the write-back crosses
placements: each new master shard is cast to the parameter's dtype and
gathered over `data` into the parameter's local tensor, the
reference's all-gather of the new bf16 parameters.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.sharding.place import gather, local
from repro_torch.tree import tree_leaves, tree_map

# elements of the leaves one group of the update takes at most (a leaf
# larger than this is a group alone): bounds the f32 temporaries to a
# few times 256 MiB
GROUP_ELEMS = 1 << 26


class AdamWState(NamedTuple):
    master: dict            # float32 master weights
    mu: dict
    nu: dict
    count: torch.Tensor     # 0-d int32


def warmup_cosine(step: torch.Tensor, *, peak_lr: float, warmup: int,
                  total: int, floor: float = 0.1) -> torch.Tensor:
    """The learning rate at `step` (a 0-d integer tensor), f32: linear
    warmup to `peak_lr` over `warmup` steps, then a cosine to
    floor · peak_lr at `total`."""
    step = step.to(torch.float32)
    warm = peak_lr * (step + 1.0) / max(warmup, 1)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi
                                                                * frac)))
    return torch.where(step < warmup, warm, cos)


def adamw_init(params) -> AdamWState:
    """f32 master copies (copies even of f32 parameters, which the
    in-place update must not alias), zero moments, count 0."""
    leaves = tree_leaves(params)
    return AdamWState(
        master=tree_map(lambda x: x.to(torch.float32, copy=True), params),
        mu=tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                    params),
        nu=tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                    params),
        count=torch.zeros((), dtype=torch.int32, device=leaves[0].device))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares, in f32.
    On DTensor leaves, the norm of the global tree (`_sharded_norm`)."""
    leaves = tree_leaves(tree)
    if any(isinstance(x, DTensor) for x in leaves):
        return _sharded_norm(leaves)
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves))


def _sharded_norm(leaves) -> torch.Tensor:
    """The global norm of DTensor leaves on one mesh: each rank sums the
    squares of its local shards, each shard counted once (on the ranks at
    coordinate 0 of every mesh dim a leaf is replicated over; a partial
    leaf summed first), and the sums are added over the mesh, one
    all-reduce a mesh dim. The result is a plain 0-d tensor, the same on
    every rank."""
    mesh = leaves[0].device_mesh
    total = torch.zeros((), dtype=torch.float32,
                        device=leaves[0].to_local().device)
    for x in leaves:
        pl = [Replicate() if p.is_partial() else p for p in x.placements]
        if pl != list(x.placements):
            x = x.redistribute(mesh, pl)
        if all(mesh.get_local_rank(j) == 0
               for j, p in enumerate(pl) if p.is_replicate()):
            total = total + torch.sum(torch.square(
                x.to_local().to(torch.float32)))
    return torch.sqrt(DTensor.from_local(
        total, mesh, [Partial()] * mesh.ndim, run_check=False).full_tensor())


def _write_back(p: torch.Tensor, w: torch.Tensor) -> None:
    """The new master `w` into the parameter `p`, cast to its dtype; a
    DTensor master shard is cast, then gathered to `p`'s placements (over
    `data`) into `p`'s local tensor."""
    if not isinstance(p, DTensor):
        p.copy_(w)
        return
    cast = DTensor.from_local(w.to_local().to(p.dtype), w.device_mesh,
                              w.placements, run_check=False)
    p.to_local().copy_(gather(cast, p.placements))


def _groups(n_elems: list[int]) -> list[list[int]]:
    """Leaf indices in runs of at most GROUP_ELEMS elements."""
    groups, cur, size = [], [], 0
    for i, n in enumerate(n_elems):
        if cur and size + n > GROUP_ELEMS:
            groups.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += n
    if cur:
        groups.append(cur)
    return groups


def adamw_update(grads, state: AdamWState, params, *, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0):
    """Returns (params, state, metrics {"grad_norm", "lr"}). The new
    master weights, moments and parameters are written into the tensors
    of `state` and `params` (see the module docstring), which are
    returned; the count is a new tensor. `grads` may be in the
    parameters' dtype: each leaf is cast to f32 before it is used, as
    the reference casts the tree. A DTensor gradient is placed as its
    master leaf first, which takes the place of the reference's
    `grads_pspec` constraint."""
    f32 = torch.float32
    p_all, w_all = tree_leaves(params), tree_leaves(state.master)
    g_all = [g.redistribute(w.device_mesh, w.placements)
             if isinstance(g, DTensor) and g.placements != w.placements
             else g for g, w in zip(tree_leaves(grads), w_all)]
    gnorm = global_norm(g_all)
    dev = gnorm.device
    scale = torch.minimum(
        torch.ones((), dtype=f32, device=dev),
        torch.tensor(clip_norm, dtype=f32, device=dev)
        / torch.clamp_min(gnorm, 1e-9))
    lr = torch.as_tensor(lr, dtype=f32, device=dev)
    count = state.count + 1
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=f32, device=dev),
                         count.to(f32))
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=f32, device=dev),
                         count.to(f32))
    lr_wd = lr * weight_decay

    # the local shards (the whole leaf where unsharded)
    g_loc, w_loc = [local(g) for g in g_all], [local(w) for w in w_all]
    m_loc = [local(m) for m in tree_leaves(state.mu)]
    v_loc = [local(v) for v in tree_leaves(state.nu)]
    with torch.no_grad():
        for idx in _groups([w.numel() for w in w_loc]):
            w = [w_loc[i] for i in idx]
            m = [m_loc[i] for i in idx]
            v = [v_loc[i] for i in idx]
            g = torch._foreach_mul([g_loc[i].to(f32) for i in idx], scale)
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
            gg = torch._foreach_mul(g, 1 - b2)
            torch._foreach_mul_(gg, g)
            torch._foreach_mul_(v, b2)
            torch._foreach_add_(v, gg)
            del g, gg
            step = torch._foreach_div(m, c1)
            torch._foreach_mul_(step, lr)
            den = torch._foreach_div(v, c2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, eps)
            torch._foreach_div_(step, den)
            del den
            decay = torch._foreach_mul(w, lr_wd)
            torch._foreach_sub_(w, step)
            torch._foreach_sub_(w, decay)
            del step, decay
            for i in idx:
                _write_back(p_all[i], w_all[i])
    return params, AdamWState(state.master, state.mu, state.nu, count), {
        "grad_norm": gnorm, "lr": lr}
