"""Sharded streaming accumulation: the ingest over a data x task mesh.

The port's counterpart of the JAX package's `repro/stream/accumulate.py`.
A chunk arrives split over the ranks of a `DeviceMesh` with dims `data`
and `task` (`substrate.feed`): each rank holds the rows of its data
coordinate for the tasks of its task coordinate. Every rank reduces its
rows to partial unnormalized `(Sigma, c)` sums — one `rank_update`
launch on CUDA tensors, the kernel the unsharded ingest launches a
chunk, times its row count — and one `psum_stats` over `data` each for
Sigma and c turns them into the whole chunk's statistics, task-sharded
and replicated along `data`. No raw sample crosses a rank boundary, and
the reduction is the same additivity that makes `StreamState` ingest
exact.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.core.engine import sufficient_stats
from repro_torch.stream.state import StreamState, ingest_stats
from repro_torch.substrate.collectives import psum_stats, resolve_group


def accumulate_stats_fn(mesh, data_axis: str = "data",
                        task_axis: str = "task", *,
                        use_kernel: bool | None = None):
    """The rank's accumulator as a callable (X_blk, y_blk) -> (S, c).

    X_blk (m_local, n_local, p), y_blk (m_local, n_local): this rank's
    block. Returns UNNORMALIZED sums S = X'X (m_local, p, p), c = X'y
    (m_local, p) over the whole chunk's rows of this rank's tasks, the
    same on every rank of its `data_axis` group (divide by the chunk's n
    for the mean convention). Exposed apart, as in the reference, so
    probes can wrap the actual implementation and count its collectives.
    `task_axis` names the dim the tasks are split over; the sums need no
    communication along it.
    """

    def worker(X_blk, y_blk):
        n_local = X_blk.shape[1]
        S_mean, c_mean = sufficient_stats(X_blk, y_blk,
                                          use_kernel=use_kernel)
        S = psum_stats(S_mean * n_local, mesh, data_axis)
        c = psum_stats(c_mean * n_local, mesh, data_axis)
        return S, c

    return worker


def accumulate_stats_sharded(X_batch: torch.Tensor, y_batch: torch.Tensor,
                             mesh, data_axis: str = "data",
                             task_axis: str = "task", *,
                             use_kernel: bool | None = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunk-mean sufficient statistics of this rank's block of a chunk.

    Equal (to roundoff) to `engine.sufficient_stats` on the gathered
    chunk's rows of this rank's tasks; communicates two all-reduces of
    partial sums instead.
    """
    n = X_batch.shape[1] * dist.get_world_size(
        resolve_group(mesh, data_axis))
    fn = accumulate_stats_fn(mesh, data_axis, task_axis,
                             use_kernel=use_kernel)
    S_sum, c_sum = fn(X_batch, y_batch)
    return S_sum / n, c_sum / n


def ingest_sharded(state: StreamState, X_batch: torch.Tensor,
                   y_batch: torch.Tensor, mesh, decay=1.0,
                   data_axis: str = "data", task_axis: str = "task", *,
                   use_kernel: bool | None = None) -> StreamState:
    """`stream.state.ingest` with the row reduction sharded over `mesh`.

    `state` holds this rank's tasks; the merge is elementwise over tasks,
    so it needs no communication.
    """
    n = X_batch.shape[1] * dist.get_world_size(
        resolve_group(mesh, data_axis))
    Sigma_b, c_b = accumulate_stats_sharded(X_batch, y_batch, mesh,
                                            data_axis, task_axis,
                                            use_kernel=use_kernel)
    return ingest_stats(state, Sigma_b, c_b, n, decay)
