"""Feeding streaming minibatches onto a `data x task` mesh.

The port's counterpart of the JAX package's `repro/substrate/feed.py`.
The sharded ingest worker (`stream.accumulate`) takes on each rank its
block of the chunk: the tasks of its `task` coordinate and the rows of
its `data` coordinate, features whole (`chunk_specs`). Two ways to get
there, as in the reference:

* **`feed_chunk`** — every rank holds the whole chunk (tests, a
  single-node deployment, a broadcast ingest) and takes its own block.
* **`feed_shards`** — the multi-host idiom: each ingest worker hands
  over only ITS rows (`(m, n_local, p)` blocks along the data dim, one
  per data slot), and a rank takes the task rows of the block of its
  data slot. No rank concatenates the chunk. Every block's shape is
  checked, with the reference's messages.

Both return the rank's contiguous (m_local, n_local, p) / (m_local,
n_local) block, which the accumulator consumes as is. Byte accounting
goes through `obs` counters (`substrate.feed.bytes`, `.chunks`, tagged
by `path`): the bytes this rank took.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import obs


def chunk_specs(data_axis: str = "data", task_axis: str = "task"
                ) -> Tuple[tuple, tuple]:
    """The (X, y) layouts the sharded accumulator ingests, one mesh dim
    name (or None, whole) per tensor dim: tasks over `task_axis`, rows
    over `data_axis`, features whole."""
    return (task_axis, data_axis, None), (task_axis, data_axis)


def _record_feed(nbytes: int, path: str) -> None:
    if obs.enabled():
        obs.inc("substrate.feed.bytes", nbytes, path=path)
        obs.inc("substrate.feed.chunks", path=path)


def _coords(mesh: DeviceMesh, data_axis: str, task_axis: str):
    """(n_data, n_task, this rank's data index, its task index)."""
    names = mesh.mesh_dim_names
    coord = mesh.get_coordinate()
    d, t = names.index(data_axis), names.index(task_axis)
    return mesh.size(d), mesh.size(t), coord[d], coord[t]


def _block(a: torch.Tensor, tasks: slice, rows: slice) -> torch.Tensor:
    return a[tasks, rows].contiguous()


def feed_chunk(X: torch.Tensor, y: torch.Tensor, mesh: DeviceMesh,
               data_axis: str = "data", task_axis: str = "task"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's block of one chunk X (m, n, p) / y (m, n) that every
    rank holds. Requires m and n divisible by the sizes of `task_axis`
    and `data_axis` (the accumulator's own contract)."""
    n_data, n_task, d, t = _coords(mesh, data_axis, task_axis)
    m, n = X.shape[0], X.shape[1]
    if m % n_task or n % n_data:
        raise ValueError(f"chunk ({m}, {n}, ...) does not split over "
                         f"{task_axis}={n_task} x {data_axis}={n_data}")
    ml, nl = m // n_task, n // n_data
    tasks, rows = slice(t * ml, (t + 1) * ml), slice(d * nl, (d + 1) * nl)
    Xd, yd = _block(X, tasks, rows), _block(y, tasks, rows)
    _record_feed(Xd.numel() * Xd.element_size()
                 + yd.numel() * yd.element_size(), "chunk")
    return Xd, yd


def feed_shards(X_shards: Sequence, y_shards: Sequence, mesh: DeviceMesh,
                data_axis: str = "data", task_axis: str = "task"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's block of a chunk given as per-worker row blocks.

    `X_shards[i]` is worker i's rows (m, n_i, p) (equal n_i across
    workers), ordered along `data_axis`; `y_shards[i]` the matching
    (m, n_i). The rank takes the task rows of its own data slot's block;
    the result equals `feed_chunk`'s on the concatenated chunk.
    """
    n_data, n_task, d, t = _coords(mesh, data_axis, task_axis)
    if len(X_shards) != n_data or len(y_shards) != n_data:
        raise ValueError(
            f"got {len(X_shards)} row blocks for a mesh with "
            f"{n_data} '{data_axis}' slots (one block per slot)")
    m, n_local, p = X_shards[0].shape
    if m % n_task:
        raise ValueError(f"m={m} tasks not divisible by "
                         f"{task_axis}={n_task}")
    m_local = m // n_task
    for i in range(n_data):
        Xb, yb = X_shards[i], y_shards[i]
        if tuple(Xb.shape) != (m, n_local, p) \
                or tuple(yb.shape) != (m, n_local):
            raise ValueError(
                f"row block {i} has shape {tuple(Xb.shape)}/"
                f"{tuple(yb.shape)}; every block must be "
                f"({m}, {n_local}, {p})/({m}, {n_local})")
    tasks, rows = slice(t * m_local, (t + 1) * m_local), slice(None)
    Xd = _block(torch.as_tensor(X_shards[d]), tasks, rows)
    yd = _block(torch.as_tensor(y_shards[d]), tasks, rows)
    _record_feed(Xd.numel() * Xd.element_size()
                 + yd.numel() * yd.element_size(), "shards")
    return Xd, yd
