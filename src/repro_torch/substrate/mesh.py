"""Device meshes for the task-parallel DSML layer.

The port's counterpart of the JAX package's `repro/substrate/mesh.py`: a
`torch.distributed.device_mesh.DeviceMesh` with named dims over the ranks
of the default process group, which must be initialized first
(`hostenv.init_from_env`). Every rank calls a constructor, with the same
arguments, since each builds the sub-groups of every dim. Ranks fill the
mesh in row-major order: on `data_task_mesh`, rank r sits at
(data, task) = divmod(r, n_task).

`device_type` only labels the mesh (the port takes its groups from it,
`mesh.get_group(dim)`, and runs no DTensor); by default it follows the
backend, `cuda` for NCCL and `cpu` otherwise.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(shape, axis_names, device_type: str | None = None
              ) -> DeviceMesh:
    """A mesh of `shape` over the ranks of the default group, its dims
    named `axis_names`."""
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def task_mesh(n_tasks: int | None = None, axis: str = "task",
              device_type: str | None = None) -> DeviceMesh:
    """1-D mesh over `n_tasks` ranks (default: the whole world)."""
    n = dist.get_world_size() if n_tasks is None else n_tasks
    return make_mesh((n,), (axis,), device_type)


def data_model_mesh(model_axis: int = 1,
                    device_type: str | None = None) -> DeviceMesh:
    """2-D (data, model) mesh over the whole world."""
    n = dist.get_world_size()
    return make_mesh((n // model_axis, model_axis), ("data", "model"),
                     device_type)


def data_task_mesh(n_task: int = 1, n_data: int | None = None,
                   axes: tuple[str, str] = ("data", "task"),
                   device_type: str | None = None) -> DeviceMesh:
    """2-D (data, task) mesh for the streaming layer: minibatch rows are
    sharded over `data` and reduced with one all-reduce; tasks stay
    sharded over `task` (default: all remaining ranks go to `data`)."""
    if n_data is None:
        n_data = dist.get_world_size() // n_task
    return make_mesh((n_data, n_task), axes, device_type)
