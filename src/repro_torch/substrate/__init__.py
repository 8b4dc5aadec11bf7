"""Substrate: the port's distributed layer, on `torch.distributed`.

The port's counterpart of the JAX package's `repro.substrate`, with its
names where there is a counterpart. The reference runs one SPMD program
over a `Mesh` of devices in one process (`shard_map`); the port runs
one process per rank, each joining a process group (`hostenv`,
`compat.init_ranks`), and its meshes are `DeviceMesh`es with named dims
(`mesh`). So three of the reference's names have no counterpart:
`shard_map` (a rank runs its own block), `use_mesh` (no ambient mesh:
meshes and groups are passed explicitly) and `force_host_device_count`
(no forced devices: `rank_env` gives a rank its place, and
`host_device_env`'s counterpart is `rank_env`).
"""
from repro_torch.substrate.collectives import (
    all_gather_tasks, all_to_all_experts, pmax, psum_stats, resolve_group,
)
from repro_torch.substrate.compat import all_gather_into, init_ranks
from repro_torch.substrate.feed import chunk_specs, feed_chunk, feed_shards
from repro_torch.substrate.hostenv import init_from_env, rank_env
from repro_torch.substrate.mesh import (
    data_model_mesh, data_task_mesh, make_mesh, task_mesh,
)
from repro_torch.substrate.probes import (
    REPO_ROOT, ProbeRun, popen_probe, run_probe,
)

__all__ = [
    "all_gather_tasks", "all_to_all_experts", "pmax", "psum_stats",
    "resolve_group",
    "all_gather_into", "init_ranks",
    "chunk_specs", "feed_chunk", "feed_shards",
    "init_from_env", "rank_env",
    "data_model_mesh", "data_task_mesh", "make_mesh", "task_mesh",
    "REPO_ROOT", "ProbeRun", "popen_probe", "run_probe",
]
