"""Wrapper of the fused FISTA step kernel (`kernels/csrc/fista_step.cu`).

One wrapper, two CUDA kernels chosen by shape: r == 1 (the lasso, a
batched matrix-vector product) and r > 1 (the debias solve, a batched
matrix product). `use_kernel` follows `kernels/common.py`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (
    LAUNCHES, check_f32, resolve_use_kernel,
)
from repro_torch.kernels.ista_step.ref import fista_step_batched_ref

_GEMV_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_float]
                  + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                  + [ctypes.c_void_p])
_GEMM_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_float]
                  + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                  + [ctypes.c_void_p])


def fista_step_batched(Sigmas: torch.Tensor, zs: torch.Tensor,
                       xs: torch.Tensor, cs: torch.Tensor,
                       etas: torch.Tensor, lam, theta, *,
                       use_kernel: bool | None = None):
    """One fused FISTA iteration (prox step + momentum extrapolation)
    for m tasks. Sigmas (m, p, p); zs/xs/cs (m, p) or (m, p, r); etas
    (m,) per-task step sizes; lam a scalar or per-task (m,); theta the
    float32 scalar momentum coefficient, a host number. Returns
    (x_next, z_next), fresh tensors (never aliasing zs or xs)."""
    squeeze = zs.ndim == 2
    if squeeze:
        zs, xs, cs = zs[..., None], xs[..., None], cs[..., None]
    if zs.ndim != 3 or Sigmas.ndim != 3:
        raise ValueError(f"fista_step_batched: Sigmas (m, p, p) and zs "
                         f"(m, p[, r]) expected, got {tuple(Sigmas.shape)}, "
                         f"{tuple(zs.shape)}")
    m, p, r = zs.shape
    if tuple(Sigmas.shape) != (m, p, p) or xs.shape != zs.shape \
            or cs.shape != zs.shape or tuple(etas.shape) != (m,):
        raise ValueError(
            f"fista_step_batched: shapes Sigmas {tuple(Sigmas.shape)}, zs "
            f"{tuple(zs.shape)}, xs {tuple(xs.shape)}, cs {tuple(cs.shape)}, "
            f"etas {tuple(etas.shape)} do not fit (m, p, r) = {(m, p, r)}")
    check_f32("fista_step_batched", Sigmas=Sigmas, zs=zs, xs=xs, cs=cs,
              etas=etas)
    if isinstance(lam, torch.Tensor):
        check_f32("fista_step_batched", lam=lam)
    lam_t = torch.as_tensor(lam, dtype=torch.float32, device=zs.device)
    lam_t = lam_t.reshape(-1).expand(m).contiguous()
    tensors = (Sigmas, zs, xs, cs, etas, lam_t)
    if not resolve_use_kernel("fista_step_batched", use_kernel, *tensors):
        xn, zn = fista_step_batched_ref(Sigmas, zs, xs, cs, etas, lam_t,
                                        theta)
        return (xn[..., 0], zn[..., 0]) if squeeze else (xn, zn)
    if min(m, p, r) == 0:
        raise ValueError(f"fista_step_batched: empty shape {(m, p, r)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fista_step_batched: the kernel takes contiguous "
                         "tensors")
    xn = torch.empty_like(zs)
    zn = torch.empty_like(zs)
    launch(Sigmas, zs, xs, cs, etas, lam_t, theta, xn, zn)
    return (xn[..., 0], zn[..., 0]) if squeeze else (xn, zn)


def launch(Sigmas, zs, xs, cs, etas, lams, theta, xn, zn) -> None:
    """Launch the kernel into the given outputs, with no checks: the
    operands are what `fista_step_batched` passes (float32, contiguous,
    one CUDA device; Sigmas (m, p, p), zs/xs/cs/xn/zn (m, p, r), etas and
    lams (m,), xn and zn aliasing neither zs nor xs). A timing loop calls
    it to time the kernel alone."""
    m, p, r = zs.shape
    ptrs = [t.data_ptr() for t in (Sigmas, zs, xs, cs, etas, lams)]
    dev = zs.device
    if r == 1:
        fn = _build.function("fista_step", "fista_step_gemv_f32",
                             _GEMV_ARGTYPES)
        _build.call(fn, *ptrs, float(theta), xn.data_ptr(), zn.data_ptr(), m,
                    p, dev.index, _build.stream(dev))
        LAUNCHES["fista_step_gemv"] += 1
    else:
        fn = _build.function("fista_step", "fista_step_gemm_f32",
                             _GEMM_ARGTYPES)
        _build.call(fn, *ptrs, float(theta), xn.data_ptr(), zn.data_ptr(), m,
                    p, r, dev.index, _build.stream(dev))
        LAUNCHES["fista_step_gemm"] += 1
