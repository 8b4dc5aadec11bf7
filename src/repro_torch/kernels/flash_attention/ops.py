"""Wrapper of the flash-attention forward kernel (`kernels/csrc/
flash_attention.cu`), the prefill attention of the model stack and the
forward of its training attention.

`use_kernel` follows `kernels/common.py`: the CUDA kernel for CUDA
tensors, the plain version (`ref.py`) for CPU tensors. Nothing on CUDA
routes to the plain version: ragged S and T are masked in the kernel.
Shapes and types the kernel does not take raise on both paths, so that
the CPU and the card refuse the same calls.

`flash_attention_fwd_lse` also returns each row's log-sum-exp (B, N, S)
in float32, which the blockwise backward of `models/attention_core.py`
reads: the kernel writes it beside the output (the .cu's `_lse` entry),
and serving's `flash_attention` writes none.

`launch_plan` says which of the .cu's two designs a call takes (bf16:
`wgmma`; float32: `tf32x3`, three TF32 products a product) and its
launch shape; it is plain Python, so the CPU tests check it. The lse
output changes neither design's registers nor shared memory (it is
written in the epilogue from m and l), so the plan is the same with it.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import LAUNCHES, resolve_use_kernel
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_fwd_lse_ref, flash_attention_ref,
)

HEAD_DIMS = (64, 128, 256)                 # the kernel's template instances
WGMMA_HEAD_DIMS = (64, 128, 256)           # bf16 heads of the Hopper design
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] * 12 + [ctypes.c_int] * 2
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
# `flash_attention_fwd_lse`: the same with the lse pointer after out's
_ARGTYPES_LSE = _ARGTYPES[:4] + [ctypes.c_void_p] + _ARGTYPES[4:]


class LaunchPlan(NamedTuple):
    design: str          # "wgmma" (bf16: TMA, wgmma) or "tf32x3" (float32:
                         # three TF32 products on mma.sync, a cp.async ring)
    rows: int            # query rows per work item
    keys: int            # keys per tile
    stages: int          # K/V tiles in shared memory at once
    threads: int         # per block
    smem_bytes: int      # dynamic shared memory per block
    items: int           # B N ceil(S / rows): one block each ("tf32x3"),
                         # or walked by one persistent block per SM
                         # ("wgmma")


def launch_plan(B: int, S: int, N: int, H: int,
                dtype: torch.dtype) -> LaunchPlan:
    """The launch of `flash_attention_fwd` for q (B, S, N, H): the
    constants of `kernels/csrc/flash_attention.cu`. bf16 takes the Hopper
    design (`Layout<H>`): consumer warpgroups of 64 rows (three at
    H = 64, two at 128 and 256) and a producer warpgroup; Q and a ring of
    K/V stages in 128-byte swizzled panels (128 keys in three stages at
    H = 64 and 128; 64 keys in two at 256, where O's accumulator takes
    128 registers and three stages would not fit), the mbarriers, and
    1024 bytes to align the base. float32 takes the 3xTF32 design
    (`Tf32Tile<H>`): warps of 16 rows, 8 at H = 64 and 128 and 4 at 256;
    32 keys a tile (16 at 256) in a ring of 3 stages at H = 64 and 2 at
    128 and 256; Q, the ring and the tile being computed split into hi
    and lo words, in rows padded to H + 4."""
    if dtype == torch.bfloat16 and H in WGMMA_HEAD_DIMS:
        consumers = 3 if H == 64 else 2
        rows = 64 * consumers
        keys, stages = (64, 2) if H == 256 else (128, 3)
        panels = H // 64
        # full and empty barriers a stage, two pairs where K and V are
        # released apart (two stages), and Q's pair
        bars = (4 if stages == 2 else 2) * stages + 2
        smem = (panels * rows * 128 + 2 * stages * panels * keys * 128
                + 8 * bars + 1024)
        return LaunchPlan("wgmma", rows, keys, stages, 128 * (consumers + 1),
                          smem, B * N * -(-S // rows))
    warps = 8 if H <= 128 else 4
    rows, keys = 16 * warps, (32 if H <= 128 else 16)
    stages = 3 if H == 64 else 2
    # Q and the ring's stages of K and V, and the tile being computed split
    # into hi and lo, in rows padded to H + 4 words
    smem = (rows + 2 * stages * keys + 4 * keys) * (H + 4) * 4
    return LaunchPlan("tf32x3", rows, keys, stages, 32 * warps, smem,
                      B * N * -(-S // rows))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention: q must be (B, S, N, H) and k, v "
                         "(B, T, K, H)")
    B, S, N, H = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != H:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    K = k.shape[2]
    if min(B, S, N, K, k.shape[1]) == 0 or N % K:
        raise ValueError(f"flash_attention: N = {N} must be a positive "
                         f"multiple of K = {K}, and no axis empty")
    if H not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {H} not in {HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    use_kernel: bool | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Causal (or not) attention with an optional sliding window, by
    position index: query s sees key t where t <= s (causal) and
    t > s - window (window > 0). q (B, S, N, H), k/v (B, T, K, H) with
    N % K == 0 (query head n reads kv head n // (N // K)), float32 or
    bfloat16, H in {64, 128, 256} -> (B, S, N, H) in q's dtype. A row
    that sees no key is zero. The scores are q·k times `scale` (None:
    1/sqrt(H))."""
    _check(q, k, v, window)
    if not resolve_use_kernel("flash_attention", use_kernel, q, k, v):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
    q, k, v = (_aligned(t) for t in (q, k, v))
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    launch(q, k, v, out, causal=causal, window=window, scale=scale)
    return out


def flash_attention_fwd_lse(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: int = 0, use_kernel: bool | None = None,
                            scale: float | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """`flash_attention` and each query row's log-sum-exp of its scaled
    scores: (out (B, S, N, H) in q's dtype, lse (B, N, S) float32), lse =
    m + log(max(l, 1e-30)) in natural-log units, as the reference's
    `_flash_fwd` returns it (-1e30 for a row that sees no key). On CPU
    tensors the plain version (`ref.py`), on CUDA tensors the kernel."""
    _check(q, k, v, window)
    if not resolve_use_kernel("flash_attention", use_kernel, q, k, v):
        return flash_attention_fwd_lse_ref(q, k, v, causal=causal,
                                           window=window, scale=scale)
    q, k, v = (_aligned(t) for t in (q, k, v))
    B, S, N, _ = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B, N, S), dtype=torch.float32, device=q.device)
    launch(q, k, v, out, causal=causal, window=window, lse=lse, scale=scale)
    return out, lse


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """`t` itself when the kernel can read it through its strides (last
    axis contiguous, 16-byte rows and base), else a contiguous copy."""
    vec = 16 // t.element_size()
    if t.stride(3) == 1 and t.data_ptr() % 16 == 0 and \
            all(s % vec == 0 for s in t.stride()[:3]):
        return t
    return t.contiguous()


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, *, causal: bool = True, window: int = 0,
           lse: torch.Tensor | None = None,
           scale: float | None = None) -> None:
    """Launch the kernel into `out` (B, S, N, H), and into `lse` (B, N, S)
    float32 contiguous where given, with no checks: the operands are what
    `flash_attention` or `flash_attention_fwd_lse` passes (checked shapes
    and types, strides the kernel reads, one CUDA device). A timing loop
    calls it to time the kernel alone. `scale` multiplies the scores
    (None: 1/sqrt(H), as ref.py)."""
    B, S, N, H = q.shape
    T, K = k.shape[1], k.shape[2]
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    if scale is None:
        scale = float(np.float32(1.0) / np.sqrt(np.float32(H)))
    if lse is None:
        fn = _build.function("flash_attention", "flash_attention_fwd",
                             _ARGTYPES)
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    else:
        fn = _build.function("flash_attention", "flash_attention_fwd_lse",
                             _ARGTYPES_LSE)
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr())
    _build.call(fn, *ptrs, int(q.dtype == torch.bfloat16), B, S, T, N, K, H,
                *strides, int(causal), int(window), scale, q.device.index,
                _build.stream(q.device))
    LAUNCHES["flash_attention"] += 1
