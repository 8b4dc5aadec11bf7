"""Trees of DTensors: placing a tree by its specs, gathering it back, and
the few helpers the model code needs where DTensor does not carry an op
by itself.

A sharded train state is the unsharded state's tree with DTensors at the
leaves, each placed by `rules.placements` of its spec. Every rank builds
the same full tree (the same seed) and keeps its own block of each leaf
(`place`): nothing is sent. Blocks are gathered back (`gather`, `full`)
by the synchronous all-gather of `substrate.collectives` (the ledger
records it). The model code's blocks that DTensor does not carry (the
MoE's routing, the RG-LRU and SSD scans) run on each rank's local
tensors (`on_local`), gathering what they need whole through the same
all-gather, differentiably (`gather_blocks`: its gradient is the
ledger's reduce-scatter). Both are the port's own: DTensor's `distribute_tensor` and
its all-gather (the functional collective, awaited by `wait_tensor`)
crashed gloo ranks on CUDA tensors with a segmentation fault (PyTorch
2.11 on an H100), where gloo's synchronous all-gather, and DTensor's
all-reduce and reduce-scatter, ran. The same blocks as DTensor's, in
its order of splits (mesh dim by mesh dim).
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.sharding.rules import placements
from repro_torch.substrate.collectives import (
    all_gather, all_to_all, pmax, pmin, reduce_scatter,
)
from repro_torch.tree import map_leaves, named_leaves


def place(x: torch.Tensor, mesh, pl) -> DTensor:
    """The DTensor placed by `pl` on `mesh` whose global value is `x`,
    every rank's own full copy: this rank keeps its block (a copy of it,
    contiguous), split mesh dim by mesh dim as DTensor splits (a dim
    split over two mesh dims holds block d · M + m at rank (d, m)), and
    nothing is sent. Dims must divide evenly."""
    local = x
    for j, p in enumerate(pl):
        if p.is_shard():
            n = mesh.size(j)
            if local.shape[p.dim] % n:
                raise ValueError(f"place: dim {p.dim} of {tuple(x.shape)} "
                                 f"does not split over {n} ranks")
            local = local.chunk(n, p.dim)[mesh.get_local_rank(j)]
    return DTensor.from_local(local.contiguous(), mesh, pl, run_check=False,
                              shape=x.shape, stride=x.stride())


def distribute_tree(tree, specs, mesh):
    """`tree` with each tensor leaf a DTensor on `mesh`, placed by its
    spec in `specs` (a tree of `rules.P` like `tree`), from this rank's
    own full copy of the leaf (`place`: no collective)."""
    spec_of = named_leaves(specs)
    return map_leaves(
        lambda name, x: place(x, mesh, placements(spec_of[name], mesh)),
        tree)


def gather(x: DTensor, pl) -> torch.Tensor:
    """This rank's local tensor of `x` placed as `pl`, where `pl` differs
    from `x`'s placements only by `Replicate()` in place of a `Shard` (a
    sharded mesh dim gathered): one all-gather a gathered mesh dim
    (`substrate.collectives.all_gather`, synchronous, in the ledger). A
    placement that splits one tensor dim over two mesh dims goes to
    DTensor's own redistribution."""
    src, mesh = list(x.placements), x.device_mesh
    pl = list(pl)
    split = [p.dim for p in src if p.is_shard()]
    if len(split) != len(set(split)):
        return x.redistribute(mesh, pl).to_local()
    out = x.to_local()
    for j, (a, b) in enumerate(zip(src, pl)):
        if a == b:
            continue
        if not (a.is_shard() and b.is_replicate()):
            raise ValueError(f"gather: {src} -> {pl} is not a gather")
        if mesh.size(j) > 1:
            out = all_gather(out, mesh, mesh.mesh_dim_names[j], dim=a.dim)
    return out


def full(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's global value on every rank (`gather` of every sharded
    mesh dim; a partial one summed by DTensor's all-reduce first); a
    plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    pl = [Replicate() if p.is_partial() else p for p in x.placements]
    if pl != list(x.placements):
        x = x.redistribute(x.device_mesh, pl)
    return gather(x, [Replicate()] * len(pl))


def full_tree(tree):
    """`tree` with each DTensor leaf gathered to its global tensor
    (`full`); plain tensors as they are."""
    return map_leaves(lambda _, x: full(x), tree)


def local(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's local tensor; a plain tensor as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


def replicated_like(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """`t` as a DTensor replicated on `ref`'s mesh where `ref` is a
    DTensor (each rank holds the same `t`), else `t`: DTensor refuses an
    op that mixes it with a plain tensor."""
    if not isinstance(ref, DTensor):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def placed_as(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """`t` redistributed to `ref`'s placements where both are DTensors
    (the sharded step's constraint, as the reference's
    `with_sharding_constraint`: a block's partial output summed over
    `model` where it joins the residual stream), else `t`."""
    if isinstance(t, DTensor) and isinstance(ref, DTensor) \
            and t.placements != ref.placements:
        return t.redistribute(ref.device_mesh, ref.placements)
    return t


def constrain(t: torch.Tensor, sharding) -> torch.Tensor:
    """`t` redistributed to `sharding` (a `rules.NamedSharding`) where it
    is a DTensor, else `t`: the reference's `with_sharding_constraint`."""
    if isinstance(t, DTensor) and tuple(t.placements) != sharding.placements:
        return t.redistribute(sharding.mesh, sharding.placements)
    return t


class _GradPlacedAsInput(torch.autograd.Function):
    """The identity, whose gradient is placed as its input was."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, x.placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if g.placements != ctx.placements:
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g


def grad_placed_as_input(x: torch.Tensor) -> torch.Tensor:
    """`x` itself; where it is a DTensor, its gradient is placed as `x` is
    (a partial gradient summed over `model`). Megatron's "f" at the input
    of a tensor-parallel block: the block's input gradient is partial over
    the ranks of `model`, each holding its share of the heads or of the
    ffn width, and is summed there once, before it reaches the norm and
    the residual stream. Left to itself DTensor would carry the partial
    gradient on and, where its cost model finds it cheaper, gather a
    weight and compute a product over the whole width on every rank."""
    if not isinstance(x, DTensor):
        return x
    return _GradPlacedAsInput.apply(x)


class _GatherBlocks(torch.autograd.Function):
    """The ledger's all-gather over one mesh dim, whose gradient is the
    ledger's reduce-scatter: each rank's gradient of the whole tensor is
    its partial sum, and a rank's block of the sum is its own."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.args = (mesh, axis, dim)
        return all_gather(x, mesh, axis, dim=dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim = ctx.args
        return reduce_scatter(g, mesh, axis, dim=dim), None, None, None


def gather_blocks(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """`x`, this rank's block of a tensor split on `dim` over the mesh dims
    named `axes` (major to minor, as `rules.placements` splits a dim over
    several), gathered whole: the minor dim first. Differentiable: the
    gradient of the whole, a partial sum on each rank, is reduce-scattered
    back to this rank's block. Dims of size 1 are skipped."""
    for axis in reversed(tuple(axes)):
        if mesh.size(mesh.mesh_dim_names.index(axis)) > 1:
            x = _GatherBlocks.apply(x, mesh, axis, dim)
    return x


def balanced(n: int, mesh, axis: str = "model") -> tuple:
    """[lo, hi): this rank's share of n items (heads, channels, experts)
    split over the mesh dim `axis`, in rank order; a rank's block of a dim
    that `Shard` splits evenly, else as even a split as there is."""
    j = mesh.mesh_dim_names.index(axis)
    k, r = mesh.size(j), mesh.get_local_rank(j)
    return r * n // k, (r + 1) * n // k


def block(t: torch.Tensor, pl, mesh, dim: int, lo: int, hi: int,
          axis: str = "model") -> torch.Tensor:
    """Indices [lo, hi) of dim `dim` of the global tensor whose local
    tensor `t` is placed by `pl`: `t` itself where its split over `axis`
    is that block, else sliced from `t` whole over `axis` (`whole`)."""
    j = mesh.mesh_dim_names.index(axis)
    p = pl[j]
    if p.is_shard() and p.dim == dim and mesh.size(j) > 1:
        n, r = t.shape[dim], mesh.get_local_rank(j)
        if (r * n, (r + 1) * n) == (lo, hi):
            return t
    return whole(t, pl, mesh, dim, axis).narrow(dim, lo, hi - lo)


def whole(t: torch.Tensor, pl, mesh, dim: int, axis: str = "model",
          weight_dim: int | None = None) -> torch.Tensor:
    """The local tensor `t` (placed by `pl`) whole on dim `dim` over the
    mesh dim `axis`: gathered (`gather_blocks`) where it is split there,
    else `t` (replicated: `fit_spec` dropped an axis that does not
    divide). With `weight_dim`, `pl` is a weight's, whose dim
    `weight_dim` splits `t`'s dim `dim` (a product's output columns)."""
    j = mesh.mesh_dim_names.index(axis)
    p = pl[j]
    if not p.is_shard() or mesh.size(j) == 1:
        return t
    if p.dim != (dim if weight_dim is None else weight_dim):
        raise ValueError(f"whole: placed {tuple(pl)}, not split on dim {dim}")
    return gather_blocks(t, mesh, (axis,), dim)


def rows_placements(x: DTensor) -> tuple:
    """The placements of a tensor whose dim 0 is split as `x`'s rows (the
    batch over the data axes) and which is replicated elsewhere."""
    return tuple(q if q == Shard(0) else Replicate() for q in x.placements)


def channel_split(x: DTensor, n: int, dim: int,
                  axis: str = "model") -> tuple:
    """The placements of a per-channel tensor (a serving cache's state)
    whose rows are `x`'s and whose dim `dim`, of n channels or heads, is
    split evenly over `axis`, each rank holding the ones it computes
    (`balanced`); n must divide."""
    mesh = x.device_mesh
    j = mesh.mesh_dim_names.index(axis)
    if n % mesh.size(j):
        raise ValueError(f"{n} channels do not split over {axis} of "
                         f"{mesh.size(j)}: the cache would be whole")
    return tuple(Shard(dim) if i == j else q
                 for i, q in enumerate(rows_placements(x)))


def split_dims(x: DTensor, axis: str = "model") -> set:
    """The mesh dims a block on local tensors divides its work over: those
    that split `x`'s rows (each rank its own) and `axis` (each rank its
    heads, channels or experts), where they have more than one rank."""
    mesh = x.device_mesh
    dims = {j for j, p in enumerate(x.placements) if p.is_shard()}
    dims.add(mesh.mesh_dim_names.index(axis))
    return {j for j in dims if mesh.size(j) > 1}


def on_local(fn, x: DTensor, out_placements, *args):
    """`fn(*local args)` on each rank's local tensors, for trees of
    DTensors `args` on `x`'s mesh (plain values pass as they are), its
    outputs (a tensor or a tuple of tensors) made DTensors placed by
    `out_placements`, one a output. The work is divided over
    `split_dims(x)`: each rank's local backward gives its own share of
    the gradient of an input replicated over such a dim (its rows, its
    heads, channels or experts), so that gradient is `Partial` there,
    summed where it is next placed; a sharded dim keeps its `Shard`, and
    a dim the work is not divided over its `Replicate`. A value that
    every rank of a divided dim computes alike must be scaled so that
    the sum over those ranks is the value (`models/moe.py`'s aux
    losses)."""
    mesh = x.device_mesh
    split = split_dims(x)

    def unwrap(_, t):
        if not isinstance(t, DTensor):
            return t
        grad = [Partial() if p.is_replicate() and j in split else p
                for j, p in enumerate(t.placements)]
        return t.to_local(grad_placements=grad)

    out = fn(*map_leaves(unwrap, tuple(args)))
    single = not isinstance(out, tuple)
    outs = (out,) if single else out
    pls = (out_placements,) if single else out_placements
    wrapped = tuple(DTensor.from_local(o, mesh, pl, run_check=False)
                    for o, pl in zip(outs, pls))
    return wrapped[0] if single else wrapped


def block_placements(x: DTensor, axis: str = "model") -> tuple:
    """The placements of a block's (B, S, d) output computed on local
    tensors (`on_local`): split as `x`'s rows, a partial sum over `axis`
    where it has more than one rank (each rank's heads, channels or
    experts), replicated elsewhere."""
    mesh = x.device_mesh
    jm = mesh.mesh_dim_names.index(axis)
    return tuple(Partial() if j == jm and mesh.size(j) > 1
                 else (p if p.is_shard() else Replicate())
                 for j, p in enumerate(x.placements))


def reshard(x: DTensor, pl) -> DTensor:
    """`x` placed as `pl`, each mesh dim's change through the ledger:
    `Shard(a)` to `Replicate` a gather, `Shard(a)` to `Shard(b)` an
    all-to-all (`collectives.all_to_all`), `Replicate` to `Shard(b)`
    each rank keeping its block (nothing is sent); in that order, the
    gathers minor mesh dim first and the blocks major first, so that a
    tensor dim split over several mesh dims (the batch over `pod` and
    `data`) is split as DTensor splits it. Splits are even. The serving
    caches move between the layouts their producers give and
    `rules.cache_pspecs`' this way (the attention's head split to the
    cache's sequence split, a batch split over `model`); DTensor's own
    `redistribute` would gather them whole first."""
    mesh, src, pl = x.device_mesh, list(x.placements), list(pl)
    names = mesh.mesh_dim_names
    if any(p.is_partial() for p in src + pl):
        raise ValueError(f"reshard: {src} -> {pl}")
    # a mesh dim of one rank changes nothing
    changed = [j for j in range(mesh.ndim)
               if src[j] != pl[j] and mesh.size(j) > 1]
    gathers = [j for j in changed if pl[j].is_replicate()]
    out = x.to_local()
    for j in reversed(gathers):
        out = all_gather(out, mesh, names[j], dim=src[j].dim)
    for j in changed:
        a, b = src[j], pl[j]
        if a.is_shard() and b.is_shard():
            # the splits of the other mesh dims: those left after the
            # gathers, and the blocks taken after this all-to-all
            others = [src[k] for k in range(mesh.ndim) if k != j
                      and k not in gathers and mesh.size(k) > 1] + [
                pl[k] for k in changed if k != j and src[k].is_replicate()]
            if any(q.is_shard() and q.dim in (a.dim, b.dim)
                   for q in others):
                raise ValueError(f"reshard: {src} -> {pl} moves a split "
                                 "another mesh dim shares")
            out = all_to_all(out, mesh, names[j], split_dim=b.dim,
                             concat_dim=a.dim)
    for j in changed:
        if src[j].is_replicate():
            n, d = mesh.size(j), pl[j].dim
            if out.shape[d] % n:
                raise ValueError(f"reshard: dim {d} of {tuple(out.shape)} "
                                 f"does not split over {n} ranks")
            out = out.chunk(n, d)[mesh.get_local_rank(j)]
    return DTensor.from_local(out.contiguous(), mesh, pl, run_check=False)


def local_offset(x: DTensor, dim: int) -> int:
    """The global index, on dim `dim`, of this rank's block of `x` (split
    evenly there, or not at all)."""
    mesh, off, n = x.device_mesh, 0, x.shape[dim]
    for j, p in enumerate(x.placements):
        if p.is_shard() and p.dim == dim:
            k = mesh.size(j)
            if n % k:
                raise ValueError(f"local_offset: dim {dim} of "
                                 f"{tuple(x.shape)} is split unevenly")
            n //= k
            off = off * k + mesh.get_local_rank(j)
    return off * n


def argmax_last(x: torch.Tensor) -> torch.Tensor:
    """`torch.argmax` over the last dim as int32, of a DTensor whose last
    dim may be split (vocab-parallel logits): each rank's argmax of its
    block (the first of equal maxima), the largest of those values over
    the ranks that split the dim (`pmax`), then the lowest index among
    the ranks that hold it (`pmin`): the lowest index wins a tie, as in
    `torch.argmax` and the reference's `jnp.argmax`. The result is
    placed as `x`'s other dims and replicated over the split; a plain
    tensor's is `torch.argmax`'s."""
    if not isinstance(x, DTensor):
        return torch.argmax(x, dim=-1).to(torch.int32)
    mesh, d = x.device_mesh, x.ndim - 1
    if any(p.is_partial() for p in x.placements):
        x = x.redistribute(mesh, [Replicate() if p.is_partial() else p
                                  for p in x.placements])
    split = [j for j, p in enumerate(x.placements)
             if p.is_shard() and p.dim == d]
    xl = x.to_local()
    idx = torch.argmax(xl, dim=-1, keepdim=True)
    val = torch.gather(xl, -1, idx)[..., 0].to(torch.float32)
    idx = idx[..., 0] + local_offset(x, d)
    names = mesh.mesh_dim_names
    best = val
    for j in split:
        best = pmax(best, mesh, names[j])
    cand = torch.where(val == best, idx, torch.iinfo(idx.dtype).max)
    for j in split:
        cand = pmin(cand, mesh, names[j])
    out = [Replicate() if j in split else p
           for j, p in enumerate(x.placements)]
    return DTensor.from_local(cand.to(torch.int32), mesh, out,
                              run_check=False)
