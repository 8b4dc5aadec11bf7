"""The one place that resolves what differs between PyTorch versions in
the port's distributed layer.

The port's counterpart of the JAX package's `repro/substrate/compat.py`,
with the port's own purpose: that file papers over `shard_map`'s moves
between jax releases; this one over `torch.distributed`'s. The all-gather
into one tensor is `all_gather_single` on new PyTorch and
`all_gather_into_tensor` (deprecated there) on older ones, and the
reduce-scatter `reduce_scatter_single` or `reduce_scatter_tensor`. They
are looked up when called, never bound at import, so a caller that wraps
`torch.distributed`'s functions (a collective count) sees every call.

`init_ranks` joins a process group through a `file://` rendezvous (no
port to pick, nothing left listening) with a finite timeout, so a rank
whose peer died raises instead of waiting in a collective forever.
"""
from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 60.0


def all_gather_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """Gather every rank's `x` of `group` into `out`, concatenated on
    dim 0 in rank order."""
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    fn(out, x, group=group)


def reduce_scatter_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """Sum every rank's `x` of `group` and scatter the sum on dim 0 in
    rank order, this rank's block into `out`."""
    fn = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    fn(out, x, group=group)


def init_ranks(rank: int, world: int, init_file: str, backend: str = "gloo",
               timeout: float = DEFAULT_TIMEOUT_S,
               device: torch.device | None = None) -> None:
    """Join the default process group as `rank` of `world`.

    `init_file` is the rendezvous file, a path that no earlier group
    used; `timeout` (seconds) bounds every collective of the group.
    NCCL wants its card chosen before the first collective, so a CUDA
    `device` is made current first; without an index, rank r takes card
    r modulo the cards there are.
    """
    if device is not None and torch.device(device).type == "cuda":
        device = torch.device(device)
        torch.cuda.set_device(device.index if device.index is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"file://{init_file}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout))
