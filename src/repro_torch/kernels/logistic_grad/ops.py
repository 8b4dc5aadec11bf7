"""Wrappers of the logistic-gradient kernels (`kernels/csrc/logistic_grad.cu`).

`logistic_grad` is the fused kernel: the whole gradient in one launch.
`logistic_grad_unfused` is its two-kernel twin (the forward product and
its residual, then the back-projection), the yardstick the fusion is
measured against. `use_kernel` follows `kernels/common.py`: the CUDA
kernels for CUDA tensors, the plain versions (`ref.py`) for CPU tensors.

`plan` chooses the fused kernel's launch shape from the card's SM count
and shared-memory limit, `unfused_plan` the two unfused kernels' from the
SM count; they are plain Python, so the CPU tests check them (the .cu
applies the same rule for the unfused pair, `logistic_unfused_plan`
returns its choice).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (
    LAUNCHES, check_f32, resolve_use_kernel,
)
from repro_torch.kernels.logistic_grad.ref import (
    logistic_backproject_ref, logistic_grad_ref, logistic_residual_ref,
)

SLAB_MAX = 8                 # rows per shared-memory slab (SLAB_MAX in the .cu)
BLOCKS_PER_SM = 2            # blocks the plan aims to give every SM
TAIL_BYTES = 512 * 1024      # partial rows per task the last block reduces
_STATIC_SMEM = 512           # the kernel's static shared memory, rounded up
_SM_RESERVED = 1024          # shared memory the card reserves per block

# the unfused pair: the blocks per SM its plan asks for, the warps of a
# block, the forward kernel's (rows per warp, warps per row) and the
# back-projection's column slices in floats, first choice first
# (UNFUSED_BLOCKS_PER_SM, WARPS, Z_PLANS, UNFUSED_COLS in the .cu)
UNFUSED_BLOCKS_PER_SM = 2
UNFUSED_WARPS = 8
UNFUSED_Z_PLANS = ((2, 1), (1, 1), (1, 2), (1, 4), (1, 8))
UNFUSED_COLS = (128, 64, 32)

_GRAD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_UNFUSED_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + \
    [ctypes.c_void_p]
_UNFUSED_PLAN_ARGTYPES = [ctypes.c_int] * 4 + \
    [ctypes.POINTER(ctypes.c_int)] * 4
_DEVICE: dict[int, tuple[int, int]] = {}


class Plan(NamedTuple):
    chunks: int          # blocks per task, each a run of consecutive samples
    rows_per_chunk: int
    slab: int            # rows per shared-memory slab
    smem_bytes: int      # dynamic shared memory; 0 = X read twice from HBM


def plan(m: int, n: int, p: int, sms: int, smem_optin: int) -> Plan:
    """Launch shape of the fused kernel for (m, n, p) on a card with `sms`
    SMs and `smem_optin` bytes of shared memory per block.

    Chunks: enough blocks for BLOCKS_PER_SM on every SM, but no more
    partial rows per task than TAIL_BYTES (one block adds them up) and
    no empty chunk. Slab: a block stages (slab + 2) p floats (rows, b and
    its accumulator); the slab is the most rows, up to SLAB_MAX, that fit
    in a share of the SM that leaves room for BLOCKS_PER_SM blocks, or in
    the whole per-block limit where the grid has no more blocks than SMs
    or one row does not fit in the share. Where one row does not fit in
    the whole limit, smem_bytes is 0 and the kernel reads X twice."""
    chunks = -(-BLOCKS_PER_SM * sms // m)
    chunks = max(1, min(chunks, TAIL_BYTES // (4 * p), n))
    rows = -(-n // chunks)
    chunks = -(-n // rows)
    row_bytes = 4 * p
    usable = smem_optin - _STATIC_SMEM
    share = smem_optin // BLOCKS_PER_SM - _SM_RESERVED - _STATIC_SMEM
    slab = (share - 2 * row_bytes) // row_bytes
    if slab < 1 or m * chunks <= sms:
        slab = (usable - 2 * row_bytes) // row_bytes
    slab = min(slab, SLAB_MAX, rows)
    if slab < 1:
        return Plan(chunks, rows, SLAB_MAX, 0)
    return Plan(chunks, rows, slab, (slab + 2) * row_bytes)


class UnfusedPlan(NamedTuple):
    rows_per_warp: int   # forward kernel: sample rows a warp takes
    warps_per_row: int   # forward kernel: warps that share a sample row
    rows_per_block: int  # UNFUSED_WARPS * rows_per_warp / warps_per_row
    z_blocks: int        # m * ceil(n / rows_per_block)
    cols: int            # back-projection: floats of p per block
    bp_blocks: int       # m * ceil(p / cols)


def unfused_plan(m: int, n: int, p: int, sms: int) -> UnfusedPlan:
    """Launch shapes of the unfused pair for (m, n, p) on a card with
    `sms` SMs, each grid aiming at UNFUSED_BLOCKS_PER_SM blocks an SM.
    The forward kernel takes the first (rows per warp, warps per row) of
    UNFUSED_Z_PLANS whose grid reaches it (the most rows a block first);
    the back-projection the widest column slice of UNFUSED_COLS that
    does, with all n samples in the block. Where none does, the last of
    each."""
    want = UNFUSED_BLOCKS_PER_SM * sms

    def rows_per_block(zp):
        return UNFUSED_WARPS * zp[0] // zp[1]

    rpw, wpr = next((zp for zp in UNFUSED_Z_PLANS
                     if m * -(-n // rows_per_block(zp)) >= want),
                    UNFUSED_Z_PLANS[-1])
    rows = rows_per_block((rpw, wpr))
    cols = next((c for c in UNFUSED_COLS if m * -(-p // c) >= want),
                UNFUSED_COLS[-1])
    return UnfusedPlan(rpw, wpr, rows, m * -(-n // rows), cols,
                       m * -(-p // cols))


def kernel_unfused_plan(m: int, n: int, p: int,
                        device: torch.device) -> tuple[int, int, int, int]:
    """(rows per warp, warps per row, floats per column slice, SMs) as
    the unfused kernels' launcher chooses them on `device`."""
    fn = _build.function("logistic_grad", "logistic_unfused_plan",
                         _UNFUSED_PLAN_ARGTYPES)
    out = [ctypes.c_int(0) for _ in range(4)]
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    _build.call(fn, m, n, p, index, *(ctypes.byref(v) for v in out))
    return tuple(v.value for v in out)


def _device_limits(device: torch.device) -> tuple[int, int]:
    """(SMs, opt-in shared memory per block) of a CUDA device."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    limits = _DEVICE.get(index)
    if limits is None:
        fn = _build.function("logistic_grad", "logistic_grad_smem_optin",
                             [ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
        optin = ctypes.c_int(0)
        _build.call(fn, index, ctypes.byref(optin))
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        limits = _DEVICE[index] = (sms, optin.value)
    return limits


def _check(name: str, Xs: torch.Tensor, ys: torch.Tensor,
           B: torch.Tensor, use_kernel: bool | None) -> bool:
    """Check a call's operands; return whether it launches the kernel."""
    if Xs.ndim != 3:
        raise ValueError(f"{name}: Xs must be (m, n, p), got "
                         f"{tuple(Xs.shape)}")
    m, n, p = Xs.shape
    for arg, t, shape in (("ys", ys, (m, n)), ("B", B, (m, p))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {arg} must be {shape}, got "
                             f"{tuple(t.shape)}")
    check_f32(name, Xs=Xs, ys=ys, B=B)
    if not resolve_use_kernel(name, use_kernel, Xs, ys, B):
        return False
    if min(m, n, p) == 0:
        raise ValueError(f"{name}: empty shape {(m, n, p)}")
    if not all(t.is_contiguous() for t in (Xs, ys, B)):
        raise ValueError(f"{name}: the kernel takes contiguous tensors")
    return True


def logistic_grad(Xs: torch.Tensor, ys: torch.Tensor, B: torch.Tensor, *,
                  use_kernel: bool | None = None) -> torch.Tensor:
    """All-tasks logistic gradient -X_t'(y_t sigmoid(-y_t X_t b_t))/n.
    Xs (m, n, p), ys (m, n) in {-1, +1}, B (m, p); float32. Returns
    (m, p). One launch of the fused kernel on CUDA tensors."""
    if not _check("logistic_grad", Xs, ys, B, use_kernel):
        return logistic_grad_ref(Xs, ys, B)
    m, n, p = Xs.shape
    pl = plan(m, n, p, *_device_limits(Xs.device))
    G = torch.empty((m, p), dtype=torch.float32, device=Xs.device)
    work = torch.empty((m, pl.chunks, p), dtype=torch.float32,
                       device=Xs.device)
    counters = torch.zeros(m, dtype=torch.int32, device=Xs.device)
    launch(Xs, ys, B, G, work, counters, pl)
    return G


def launch(Xs: torch.Tensor, ys: torch.Tensor, B: torch.Tensor,
           G: torch.Tensor, work: torch.Tensor, counters: torch.Tensor,
           pl: Plan) -> None:
    """Launch the fused kernel into the given outputs, with no checks: the
    operands are what `logistic_grad` passes (float32, contiguous, one
    CUDA device; Xs (m, n, p), ys (m, n), B and G (m, p), work (m,
    pl.chunks, p), counters (m,) int32, zero). The kernel leaves the
    counters at zero, so a timing loop reuses them."""
    m, n, p = Xs.shape
    fn = _build.function("logistic_grad", "logistic_grad_f32", _GRAD_ARGTYPES)
    _build.call(fn, Xs.data_ptr(), ys.data_ptr(), B.data_ptr(),
                work.data_ptr(), counters.data_ptr(), G.data_ptr(), m, n, p,
                pl.chunks, pl.rows_per_chunk, pl.slab, pl.smem_bytes,
                Xs.device.index, _build.stream(Xs.device))
    LAUNCHES["logistic_grad"] += 1


def logistic_grad_unfused(Xs: torch.Tensor, ys: torch.Tensor,
                          B: torch.Tensor, *,
                          use_kernel: bool | None = None) -> torch.Tensor:
    """The same gradient in two kernels: the residual r = y sigmoid(-y X
    b), then -X' r / n. The fused kernel's baseline; X is read twice and
    r passes through device memory."""
    if not _check("logistic_grad_unfused", Xs, ys, B, use_kernel):
        return logistic_backproject_ref(Xs, logistic_residual_ref(Xs, ys, B))
    m, n, p = Xs.shape
    z = torch.empty((m, n), dtype=torch.float32, device=Xs.device)
    G = torch.empty((m, p), dtype=torch.float32, device=Xs.device)
    launch_unfused(Xs, ys, B, z, G)
    return G


def launch_unfused(Xs: torch.Tensor, ys: torch.Tensor, B: torch.Tensor,
                   z: torch.Tensor, G: torch.Tensor) -> None:
    """Both unfused kernels into the given outputs, with no checks: the
    operands are what `logistic_grad_unfused` passes. `z` (m, n) is the
    vector between them: it receives the residual r = y sigmoid(-y X b),
    which the second kernel reads to write G (m, p). One host call
    launches the two kernels on the current stream, each with its launch
    shape from `unfused_plan`'s rule."""
    m, n, p = Xs.shape
    fn = _build.function("logistic_grad", "logistic_unfused_f32",
                         _UNFUSED_ARGTYPES)
    _build.call(fn, Xs.data_ptr(), ys.data_ptr(), B.data_ptr(), z.data_ptr(),
                G.data_ptr(), m, n, p, Xs.device.index,
                _build.stream(Xs.device))
    LAUNCHES["logistic_z"] += 1
    LAUNCHES["logistic_backproject"] += 1
