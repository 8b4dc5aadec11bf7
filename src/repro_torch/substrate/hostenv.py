"""The environment of one rank of a distributed run.

The port's counterpart of the JAX package's `repro/substrate/hostenv.py`.
There, one process exposes N forced host devices (`XLA_FLAGS`) and
`shard_map` runs the SPMD program over them. Here every rank is a process
of its own, as in every `torch.distributed` program, and what a rank
needs is its place in the group: `rank_env` writes it into a copy of the
environment of a child process, and `init_from_env` reads it back in the
rank and joins the group.

Variables: `RANK`, `WORLD_SIZE`, `REPRO_INIT_FILE` (the `file://`
rendezvous), `REPRO_BACKEND` (`gloo` or `nccl`) and `REPRO_PG_TIMEOUT`
(seconds); `src` goes on `PYTHONPATH`, and one thread per rank
(`OMP_NUM_THREADS=1`, `MKL_NUM_THREADS=1`), since N ranks share the
host's cores.
"""
from __future__ import annotations

import os
from typing import Mapping

import torch

from repro_torch.substrate.compat import DEFAULT_TIMEOUT_S, init_ranks


def rank_env(rank: int, world: int, init_file: str, *,
             backend: str = "gloo", timeout: float = DEFAULT_TIMEOUT_S,
             extra_pythonpath: str | None = None,
             base: Mapping[str, str] | None = None) -> dict:
    """Environment dict for rank `rank` of `world` (default base:
    `os.environ`), with `extra_pythonpath` prepended to PYTHONPATH."""
    env = dict(os.environ if base is None else base)
    env.update(RANK=str(rank), WORLD_SIZE=str(world),
               REPRO_INIT_FILE=str(init_file), REPRO_BACKEND=backend,
               REPRO_PG_TIMEOUT=repr(float(timeout)),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    if extra_pythonpath:
        prev = env.get("PYTHONPATH", "")
        env["PYTHONPATH"] = extra_pythonpath + (os.pathsep + prev
                                                if prev else "")
    return env


def init_from_env(device: torch.device | None = None) -> tuple[int, int]:
    """Join the process group `rank_env` describes; returns (rank,
    world). A CUDA `device` is made current first (NCCL)."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    init_ranks(rank, world, os.environ["REPRO_INIT_FILE"],
               backend=os.environ.get("REPRO_BACKEND", "gloo"),
               timeout=float(os.environ.get("REPRO_PG_TIMEOUT",
                                            DEFAULT_TIMEOUT_S)),
               device=device)
    return rank, world
