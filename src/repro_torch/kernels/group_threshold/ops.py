"""Wrapper of the group hard-threshold kernel (`kernels/csrc/
group_threshold.cu`), the master step of DSML (paper eq. 5-6).

`use_kernel` follows `kernels/common.py`: the CUDA kernel for CUDA
tensors, the plain version (`ref.py`) for CPU tensors. `row_lanes` is the
kernel's lane mapping in plain Python (the .cu applies the same rule, and
`kernel_row_lanes` returns its choice); `launch_empty` launches a kernel
that does nothing, the launch floor the kernel is timed against.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import LAUNCHES, resolve_use_kernel
from repro_torch.kernels.group_threshold.ref import group_threshold_ref

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_float] + [ctypes.c_int] * 3 \
    + [ctypes.c_void_p]
_ENTRIES = {torch.float32: "group_threshold_f32",
            torch.bfloat16: "group_threshold_bf16"}
VECTOR = 4                  # elements a lane loads at once where it can


def row_vectors(m: int, aligned: bool = True) -> int:
    """The vectors of a row of m elements: groups of VECTOR (a float4,
    or four bf16 in 8 bytes) where m % 4 == 0 and both pointers are
    aligned, else single elements."""
    return m // VECTOR if aligned and m % VECTOR == 0 else m


def row_lanes(vecs: int) -> int:
    """The lanes of a warp that take one row of `vecs` vectors: the
    least power of two that covers them, at most 32 (a lane then takes
    vectors s, s + 32, ...). 32 / row_lanes rows share a warp."""
    lanes = 1
    while lanes < vecs and lanes < 32:
        lanes *= 2
    return lanes


def kernel_row_lanes(vecs: int) -> int:
    """`row_lanes` as the launcher computes it."""
    fn = _build.function("group_threshold", "group_threshold_lanes",
                         [ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    lanes = ctypes.c_int(0)
    _build.call(fn, vecs, ctypes.byref(lanes))
    return lanes.value


def launch_empty(device: torch.device) -> None:
    """Launch a kernel that does nothing on the current stream of
    `device` (a CUDA device): the floor of any launch's time. Counted
    nowhere."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    fn = _build.function("group_threshold", "empty_launch",
                         [ctypes.c_int, ctypes.c_void_p])
    _build.call(fn, index, _build.stream(device))


def group_threshold(B: torch.Tensor, Lam, *,
                    use_kernel: bool | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-wise group hard threshold. B (p, m) float32 or bfloat16 (rows
    are variables, columns tasks); Lam a number or a one-element tensor.
    Returns (filtered (p, m) in B's dtype, keep (p,) bool): row j is kept
    where sum_t B[j, t]^2 > Lam^2, the squares summed in float32.

    That is the comparison of the reference's Pallas body. The
    reference's oracle (`group_threshold_ref` of the JAX package), which
    its wrapper takes on ragged shapes, tests ||B_j||_2 > Lam instead.
    The two part in two places: where a row's norm lies within an ulp
    or so of Lam (rounding of the square and of the square root), and
    where Lam < 0, since every norm exceeds a negative Lam but a row
    whose sum of squares is at most Lam^2 is dropped here.

    The kernel takes B row-major; a strided B (such as beta_u.T) is
    copied to a contiguous one first."""
    if B.ndim != 2:
        raise ValueError(f"group_threshold: B must be (p, m), got "
                         f"{tuple(B.shape)}")
    if B.dtype not in _ENTRIES:
        raise TypeError(f"group_threshold: B must be float32 or bfloat16, "
                        f"got {B.dtype}")
    lam = float(np.float32(Lam.item() if isinstance(Lam, torch.Tensor)
                           else Lam))
    if not resolve_use_kernel("group_threshold", use_kernel, B):
        return group_threshold_ref(B, lam)
    p, m = B.shape
    if min(p, m) == 0:
        raise ValueError(f"group_threshold: empty shape {(p, m)}")
    B = B.contiguous()
    out = torch.empty_like(B)
    keep = torch.empty(p, dtype=torch.int8, device=B.device)
    launch(B, lam, out, keep)
    return out, keep.view(torch.bool)


def launch(B: torch.Tensor, lam: float, out: torch.Tensor,
           keep: torch.Tensor) -> None:
    """Launch the kernel into `out` (like B) and `keep` (p,) int8, with
    no checks: the operands are what `group_threshold` passes (B (p, m)
    float32 or bfloat16, contiguous, on one CUDA device). A timing loop
    calls it to time the kernel alone."""
    p, m = B.shape
    fn = _build.function("group_threshold", _ENTRIES[B.dtype], _ARGTYPES)
    _build.call(fn, B.data_ptr(), out.data_ptr(), keep.data_ptr(), lam, p, m,
                B.device.index, _build.stream(B.device))
    LAUNCHES["group_threshold"] += 1
