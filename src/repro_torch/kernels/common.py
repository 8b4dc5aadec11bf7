"""Shared dispatch helpers for the port's kernel wrappers.

Every wrapper follows one convention (`use_kernel`):

* `None`  — the CUDA kernel when the tensors lie on a CUDA device, the
  plain PyTorch version (`ref.py`) when they lie on the CPU;
* `True`  — the kernel; a CPU tensor raises;
* `False` — the plain version on any device (the on-card reference).

A CUDA tensor with `use_kernel=None` launches the kernel or raises;
nothing falls back to the plain version.

`LAUNCHES` counts kernel launches, one plain integer per wrapper and
CUDA kernel (two wrappers that launch one compiled kernel count apart),
incremented by the wrapper right where it launches. A run proves it
went through a kernel by zeroing the counts (`reset_launches`) before
it and reading them after.
"""
from __future__ import annotations

import torch

LAUNCHES: dict[str, int] = {
    "rank_update": 0,        # kernels/rank_update: Sigma and c in one pass
    "fista_step_gemv": 0,    # kernels/ista_step, r == 1 path
    "fista_step_gemm": 0,    # kernels/ista_step, r > 1 path
    "logistic_grad": 0,      # kernels/logistic_grad: the fused gradient
    "logistic_z": 0,         # kernels/logistic_grad, unfused: z = X b
    "logistic_backproject": 0,  # kernels/logistic_grad, unfused: -X'r/n
    "ista_step_batched_gemv": 0,  # kernels/ista_step, no momentum, r == 1
    "ista_step_batched_gemm": 0,  # kernels/ista_step, no momentum, r > 1
    "ista_step_gemv": 0,     # kernels/ista_step, one task, r == 1
    "ista_step_gemm": 0,     # kernels/ista_step, one task, r > 1
    "rank_update_sigma": 0,  # kernels/rank_update, unfused: Sigma alone
    "rank_update_c": 0,      # kernels/rank_update, unfused: c alone
    "group_threshold": 0,    # kernels/group_threshold
    "flash_attention": 0,    # kernels/flash_attention: the prefill attention
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def on_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def check_f32(name: str, **tensors: torch.Tensor) -> None:
    """The kernels and their plain versions take float32 only."""
    for arg, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} must be float32, got {t.dtype}")


def resolve_use_kernel(name: str, use_kernel: bool | None,
                       *tensors: torch.Tensor) -> bool:
    """Apply the `use_kernel` convention to a call's tensors; they must
    share one device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")
    cuda = on_cuda(tensors[0])
    if use_kernel is None:
        return cuda
    if use_kernel and not cuda:
        raise ValueError(f"{name}: use_kernel=True needs CUDA tensors")
    return bool(use_kernel)
