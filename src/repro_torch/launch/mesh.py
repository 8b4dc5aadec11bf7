"""Production and host meshes for sharded training, and the card's
constants for the roofline.

The port of the JAX package's `launch/mesh.py`. A mesh is a
`DeviceMesh` over the ranks of the default process group, which must be
initialised first: the dry run's fake group of 256 (or 512) ranks, or
the gloo/NCCL ranks of `substrate.hostenv.init_from_env`. Nothing here
touches a process group at import time.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.substrate.mesh import make_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None) -> DeviceMesh:
    """16 x 16 = 256 ranks as (data, model); 2 x 16 x 16 = 512 as (pod,
    data, model) when multi_pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_host_mesh(model_axis: int = 1,
                   device_type: str | None = None) -> DeviceMesh:
    """(world // model_axis, model_axis) as (data, model) over the default
    group."""
    n = dist.get_world_size()
    if n % model_axis:
        raise ValueError(f"make_host_mesh: model axis {model_axis} does not "
                         f"divide the world of {n}")
    return make_mesh((n // model_axis, model_axis), ("data", "model"),
                     device_type)


# NVIDIA H100 SXM, from NVIDIA's data sheet (dense rates, 700 W), not
# measured here: used by the dry run's roofline (launch/hlo.py)
HW = {
    "peak_flops_bf16": 989e12,      # FLOP/s per card, tensor cores
    "hbm_bw": 3.35e12,              # B/s per card, HBM3
    "link_bw": 450e9,               # B/s per card each way, NVLink 4
    "hbm_bytes": 80e9,              # HBM capacity per card
}
