"""Trees of DTensors: placing a tree by its specs, gathering it back, and
the few helpers the model code needs where DTensor does not carry an op
by itself.

A sharded train state is the unsharded state's tree with DTensors at the
leaves, each placed by `rules.placements` of its spec. Every rank builds
the same full tree (the same seed) and keeps its own block of each leaf
(`place`): nothing is sent. Blocks are gathered back (`gather`, `full`)
by the synchronous all-gather of `substrate.collectives` (the ledger
records it). Both are the port's own: DTensor's `distribute_tensor` and
its all-gather (the functional collective, awaited by `wait_tensor`)
crashed gloo ranks on CUDA tensors with a segmentation fault (PyTorch
2.11 on an H100), where gloo's synchronous all-gather, and DTensor's
all-reduce and reduce-scatter, ran. The same blocks as DTensor's, in
its order of splits (mesh dim by mesh dim).
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.sharding.rules import placements
from repro_torch.substrate.collectives import all_gather
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


def is_sharded(tree) -> bool:
    """Whether any leaf of `tree` is a DTensor."""
    return any(isinstance(x, DTensor) for x in named_leaves(tree).values())


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
