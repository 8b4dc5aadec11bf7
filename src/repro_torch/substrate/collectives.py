"""The collectives of the port's distributed paths, with their byte ledger.

The port's counterpart of the JAX package's `repro/substrate/collectives.py`.
Algorithm code states *what* it communicates (gather the per-task rows,
one round; sum partial statistics) and this module says how, on
`torch.distributed`. Each helper takes the group as a `DeviceMesh` (and
the name of its dim), a `ProcessGroup`, or None for the default group.

The ledger has the reference's names: `collective.calls` and
`collective.bytes` counters tagged by `op` and `axis`, and its byte
model, participants x the local operand's nbytes (what each rank puts on
the wire for a ring collective of k shards). The reference counts once
per trace, the port once per call; for one fit both give one call.

Operands go to the backend where they lie: NCCL takes CUDA tensors,
gloo CPU tensors and, on the card's PyTorch (2.11), CUDA tensors for
the all-gather, the all-reduce, the reduce-scatter and the all-to-all;
staging a CUDA operand through the host for gloo gave the same bits and
was slower
(`python -m repro_torch.launch.gloo_operands`).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import obs
from repro_torch.substrate.compat import all_gather_into, reduce_scatter_into


def resolve_group(group, axis: str):
    """The `ProcessGroup` of `group`'s dim `axis` (a `DeviceMesh`), or
    `group` itself (a `ProcessGroup`, None for the default group)."""
    if isinstance(group, DeviceMesh):
        return group.get_group(axis)
    return group


def _record(op: str, x: torch.Tensor, group, axis: str) -> None:
    if not obs.enabled():
        return
    k = dist.get_world_size(group)
    nbytes = x.numel() * x.element_size()
    obs.inc("collective.calls", op=op, axis=axis)
    obs.inc("collective.bytes", k * nbytes, op=op, axis=axis)


def all_gather_tasks(x: torch.Tensor, group=None,
                     axis: str = "task") -> torch.Tensor:
    """Gather every rank's `x` over `axis`, concatenated on dim 0 in rank
    order (tiled): (m_local, ...) -> (k * m_local, ...)."""
    g = resolve_group(group, axis)
    _record("all_gather_tasks", x, g, axis)
    src = x.contiguous()
    out = src.new_empty((dist.get_world_size(g) * x.shape[0],
                         *x.shape[1:]))
    all_gather_into(out, src, g)
    return out


def all_gather(x: torch.Tensor, group=None, axis: str = "data", *,
               dim: int = 0) -> torch.Tensor:
    """Every rank's `x` over `axis`, concatenated on dim `dim` in rank
    order: the gather of a DTensor's blocks (`sharding.place.gather`),
    through the synchronous `torch.distributed` call, which gloo runs on
    CUDA tensors too."""
    g = resolve_group(group, axis)
    _record("all_gather", x, g, axis)
    src = torch.movedim(x, dim, 0).contiguous()
    out = src.new_empty((dist.get_world_size(g) * src.shape[0],
                         *src.shape[1:]))
    all_gather_into(out, src, g)
    return torch.movedim(out, 0, dim)


def reduce_scatter(x: torch.Tensor, group=None, axis: str = "data", *,
                   dim: int = 0) -> torch.Tensor:
    """The sum of every rank's `x` over `axis`, split on dim `dim` into
    one block a rank in rank order, this rank's block returned: the
    gradient of `all_gather` (`sharding.place.gather_blocks`)."""
    g = resolve_group(group, axis)
    _record("reduce_scatter", x, g, axis)
    src = torch.movedim(x, dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // dist.get_world_size(g),
                         *src.shape[1:]))
    reduce_scatter_into(out, src, g)
    return torch.movedim(out, 0, dim)


def all_to_all_experts(x: torch.Tensor, group=None, axis: str = "model",
                       *, split_axis: int = 0,
                       concat_axis: int = 0) -> torch.Tensor:
    """All-to-all over `axis` (MoE dispatch/return), untiled as the
    reference's: dim `split_axis` of `x` has one slice per rank; slice j
    goes to rank j, and the slices received are stacked along a new dim
    at `concat_axis` of the result, in rank order."""
    g = resolve_group(group, axis)
    _record("all_to_all_experts", x, g, axis)
    src = torch.movedim(x, split_axis, 0).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=g)
    return torch.movedim(out, 0, concat_axis)


def all_to_all(x: torch.Tensor, group=None, axis: str = "model", *,
               split_dim: int, concat_dim: int) -> torch.Tensor:
    """All-to-all over `axis`, tiled: dim `split_dim` of `x` is cut into
    one equal block a rank, block j goes to rank j, and the blocks
    received are concatenated on dim `concat_dim` in rank order (a
    tensor split on `concat_dim` becomes one split on `split_dim`:
    `sharding.place.reshard`)."""
    g = resolve_group(group, axis)
    k = dist.get_world_size(g)
    if x.shape[split_dim] % k:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} "
                         f"does not split over {k} ranks")
    _record("all_to_all", x, g, axis)
    blocks = torch.stack(x.chunk(k, split_dim)).contiguous()
    out = torch.empty_like(blocks)
    dist.all_to_all_single(out, blocks, group=g)
    return torch.cat(out.unbind(0), dim=concat_dim)


def _all_reduce(op_name: str, reduce_op, x: torch.Tensor, group,
                axis: str) -> torch.Tensor:
    g = resolve_group(group, axis)
    _record(op_name, x, g, axis)
    # a new tensor: the caller's operand (a state's field) is never
    # written in place
    out = x.clone()
    dist.all_reduce(out, op=reduce_op, group=g)
    return out


def psum_stats(x: torch.Tensor, group=None,
               axis: str = "data") -> torch.Tensor:
    """Sum partial sufficient statistics over `axis`.

    The streaming accumulator computes per-rank partial (Sigma, c) sums
    over the minibatch rows it owns and reduces them here — the
    additive-stats property is what makes the sharded ingest a single
    all-reduce instead of gathering raw samples."""
    return _all_reduce("psum_stats", dist.ReduceOp.SUM, x, group, axis)


def pmax(x: torch.Tensor, group=None, axis: str = "task") -> torch.Tensor:
    """Elementwise max over `axis`: a verdict all ranks must share (the
    sharded stream service's refit health)."""
    return _all_reduce("pmax", dist.ReduceOp.MAX, x, group, axis)


def pmin(x: torch.Tensor, group=None, axis: str = "task") -> torch.Tensor:
    """Elementwise min over `axis`: a value all ranks must share (the
    generation a sharded stream service restores)."""
    return _all_reduce("pmin", dist.ReduceOp.MIN, x, group, axis)
