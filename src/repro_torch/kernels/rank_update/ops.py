"""Wrapper of the fused rank-n update kernel (`kernels/csrc/rank_update.cu`).

`use_kernel` follows `kernels/common.py`: the CUDA kernel for CUDA
tensors, the plain version (`ref.py`) for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (
    LAUNCHES, check_f32, resolve_use_kernel,
)
from repro_torch.kernels.rank_update.ref import rank_update_ref

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def rank_update(Xs: torch.Tensor, ys: torch.Tensor,
                weights: torch.Tensor | None = None, *,
                use_kernel: bool | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sigma_t = X_t' W_t X_t / n and c_t = X_t' W_t y_t / n for all m
    tasks. Xs (m, n, p); ys and optional weights (m, n); float32.
    Returns (Sigmas (m, p, p), cs (m, p))."""
    if Xs.ndim != 3:
        raise ValueError(f"rank_update: Xs must be (m, n, p), got "
                         f"{tuple(Xs.shape)}")
    m, n, p = Xs.shape
    args = {"Xs": Xs, "ys": ys}
    if weights is not None:
        args["weights"] = weights
    for name, t in args.items():
        if name != "Xs" and tuple(t.shape) != (m, n):
            raise ValueError(f"rank_update: {name} must be {(m, n)}, got "
                             f"{tuple(t.shape)}")
    check_f32("rank_update", **args)
    if not resolve_use_kernel("rank_update", use_kernel, *args.values()):
        return rank_update_ref(Xs, ys, weights)
    if min(m, n, p) == 0:
        raise ValueError(f"rank_update: empty shape {(m, n, p)}")
    if not all(t.is_contiguous() for t in args.values()):
        raise ValueError("rank_update: the kernel takes contiguous tensors")

    Sigmas = torch.empty((m, p, p), dtype=torch.float32, device=Xs.device)
    cs = torch.empty((m, p), dtype=torch.float32, device=Xs.device)
    launch(Xs, ys, weights, Sigmas, cs)
    return Sigmas, cs


def launch(Xs: torch.Tensor, ys: torch.Tensor, weights: torch.Tensor | None,
           Sigmas: torch.Tensor, cs: torch.Tensor) -> None:
    """Launch the kernel into the given outputs, with no checks: the
    operands are what `rank_update` passes (float32, contiguous, one CUDA
    device; Xs (m, n, p), ys and weights (m, n), Sigmas (m, p, p), cs
    (m, p)). A timing loop calls it to time the kernel alone."""
    m, n, p = Xs.shape
    fn = _build.function("rank_update", "rank_update_f32", _ARGTYPES)
    _build.call(fn, Xs.data_ptr(), ys.data_ptr(),
                None if weights is None else weights.data_ptr(),
                Sigmas.data_ptr(), cs.data_ptr(), m, n, p,
                Xs.device.index, _build.stream(Xs.device))
    LAUNCHES["rank_update"] += 1
