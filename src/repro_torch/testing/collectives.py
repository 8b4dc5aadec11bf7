"""Count the collectives a rank issues, independently of the byte ledger.

`substrate.collectives` records what it sends in `obs` (`collective.*`).
A check that a distributed path communicates once must not trust the
code under test to report itself, so `count_collectives` wraps
`torch.distributed`'s own communication functions for the duration of a
`with` block and counts the calls that reach them from outside (a
function that calls another, such as a deprecated spelling forwarding to
the new one, counts once). It stands in for the JAX package's HLO probe
of the compiled program (`benchmarks/communication.py`).
"""
from __future__ import annotations

import contextlib
import functools
from collections import Counter
from typing import Iterator

import torch.distributed as dist

COLLECTIVES = (
    "all_gather", "all_gather_into_tensor", "all_gather_single",
    "all_gather_object", "all_gather_coalesced", "all_reduce",
    "all_reduce_coalesced", "all_to_all", "all_to_all_single", "barrier",
    "monitored_barrier", "batch_isend_irecv", "broadcast",
    "broadcast_object_list", "gather", "gather_object", "irecv", "isend",
    "recv", "reduce", "reduce_scatter", "reduce_scatter_tensor", "scatter",
    "scatter_object_list", "send",
)


@contextlib.contextmanager
def count_collectives() -> Iterator[Counter]:
    """Within the block, count each outermost call of a
    `torch.distributed` communication function by name; yields the
    `Counter`, complete when the block ends."""
    counts: Counter = Counter()
    depth = [0]
    saved = {name: getattr(dist, name) for name in COLLECTIVES
             if hasattr(dist, name)}

    def wrap(name, fn):
        @functools.wraps(fn)
        def counted(*args, **kwargs):
            if depth[0] == 0:
                counts[name] += 1
            depth[0] += 1
            try:
                return fn(*args, **kwargs)
            finally:
                depth[0] -= 1
        return counted

    for name, fn in saved.items():
        setattr(dist, name, wrap(name, fn))
    try:
        yield counts
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)
