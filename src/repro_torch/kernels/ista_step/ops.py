"""Wrappers of the proximal-gradient step kernels (`kernels/csrc/fista_step.cu`).

Three entry points, each with two CUDA kernels chosen by shape: r == 1 (a
batched matrix-vector product) and r > 1 (a batched matrix product).

* `fista_step_batched`: the fused FISTA step (prox step + momentum), the
  body of the engine's solves;
* `ista_step_batched`: the same step without momentum, m tasks;
* `ista_step`: one task with scalar eta and lam (the kernel at m = 1), and
  `ista_solve`, a whole proximal-gradient solve with it as the body.

`use_kernel` follows `kernels/common.py`.

`gemm_plan` is the r > 1 kernel's choice of block tile and `gemv_plan`
the r == 1 kernel's rows per warp and warps per block, plain Python so
that the CPU tests check them; the kernels' launchers apply the same
rules (`fista_gemm_plan` and `fista_gemv_plan` in the .cu return their
choices).

`block=` overrides the rule: a `(rows_per_warp, warps)` entry of
GEMV_PLANS where r == 1, a `(bm, bn)` entry of GEMM_TILES where r > 1,
or None for the rule's plan. On CUDA tensors the kernel launches exactly
that plan; the plain version ignores it. Every plan gives the same bits.
Anything else raises ValueError on every path, the CPU's too, the JAX
package's TPU tilings (`128`, `(bp, br, bk)`) included.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.common import (
    LAUNCHES, check_f32, resolve_use_kernel,
)
from repro_torch.kernels.ista_step.ref import (
    fista_step_batched_ref, ista_step_batched_ref, ista_step_ref,
)

# the launch entries take the plan last (-1: the rule's)
_GEMV_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_float]
                  + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                  + [ctypes.c_void_p, ctypes.c_int])
_GEMM_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_float]
                  + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                  + [ctypes.c_void_p, ctypes.c_int])
_ISTA_GEMV_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + \
    [ctypes.c_void_p, ctypes.c_int]
_ISTA_GEMM_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + \
    [ctypes.c_void_p, ctypes.c_int]
_PLAN_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 3
_GEMV_PLAN_ARGTYPES = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 3

# the SGEMM's block tiles, larger first (PLAN_TILES in the .cu), and its
# ring: k per stage and stages (BK, STAGES in the .cu)
GEMM_TILES = ((128, 64), (64, 64))
GEMM_BK = 16
GEMM_STAGES = 4
# the GEMV's (rows per warp, warps per block), first choice first, and
# the blocks per SM its plan asks for (GV_PLANS, GV_BLOCKS_PER_SM)
GEMV_PLANS = ((4, 8), (2, 8), (1, 8), (1, 4), (1, 2))
GEMV_BLOCKS_PER_SM = 4


class GemmPlan(NamedTuple):
    bm: int              # output rows (i) per block
    bn: int              # output columns (j) per block
    blocks: int          # m * ceil(p / bm) * ceil(r / bn)
    threads: int         # one 8 x 8 register tile each
    smem_bytes: int      # the ring of stages, dynamic shared memory


def gemm_plan(m: int, p: int, r: int, sms: int) -> GemmPlan:
    """Block tile of the r > 1 kernel for (m, p, r) on a card with `sms`
    SMs: the larger of GEMM_TILES where its grid has at least one block
    per SM, else the smaller. No split-K, so every tile gives the same
    bits."""
    def blocks(bm: int, bn: int) -> int:
        return m * -(-p // bm) * -(-r // bn)

    bm, bn = GEMM_TILES[0]
    if blocks(bm, bn) < sms:
        bm, bn = GEMM_TILES[1]
    return GemmPlan(bm, bn, blocks(bm, bn), bm * bn // 64,
                    4 * GEMM_STAGES * GEMM_BK * (bm + bn))


class GemvPlan(NamedTuple):
    rows_per_warp: int   # output rows a warp streams at once
    warps: int           # warps per block
    blocks: int          # m * ceil(p / (rows_per_warp * warps))
    threads: int         # 32 * warps


def gemv_plan(m: int, p: int, sms: int) -> GemvPlan:
    """Rows per warp and warps per block of the r == 1 kernel for (m, p)
    on a card with `sms` SMs: the first of GEMV_PLANS whose grid gives
    every SM GEMV_BLOCKS_PER_SM blocks, else the last. Warp w of block b
    of task t owns rows (b * warps + w) * rows_per_warp onwards; a row is
    one warp's FMA chains in the same order under every plan, so every
    plan gives the same bits."""
    for rows, warps in GEMV_PLANS:
        blocks = m * -(-p // (rows * warps))
        if blocks >= GEMV_BLOCKS_PER_SM * sms:
            break
    return GemvPlan(rows, warps, blocks, 32 * warps)


def kernel_gemv_plan(m: int, p: int,
                     device: torch.device) -> tuple[int, int, int]:
    """(rows per warp, warps per block, SMs) as the r == 1 kernel's
    launcher chooses them on `device`."""
    fn = _build.function("fista_step", "fista_gemv_plan", _GEMV_PLAN_ARGTYPES)
    rows, warps, sms = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    _build.call(fn, m, p, index, ctypes.byref(rows), ctypes.byref(warps),
                ctypes.byref(sms))
    return rows.value, warps.value, sms.value


def kernel_gemm_plan(m: int, p: int, r: int,
                     device: torch.device) -> tuple[int, int, int]:
    """(bm, bn, SMs) as the kernel's launcher chooses them on `device`."""
    fn = _build.function("fista_step", "fista_gemm_plan", _PLAN_ARGTYPES)
    bm, bn, sms = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    _build.call(fn, m, p, r, index, ctypes.byref(bm), ctypes.byref(bn),
                ctypes.byref(sms))
    return bm.value, bn.value, sms.value


def check_block(name: str, r: int, block) -> int:
    """The launcher's `plan` for `block` at r columns: -1 for None (the
    rule), else the index of `block` in GEMV_PLANS (r == 1) or GEMM_TILES
    (r > 1). Raises ValueError for anything else."""
    if block is None:
        return -1
    table, what = (GEMV_PLANS, "GEMV_PLANS (rows_per_warp, warps)") \
        if r == 1 else (GEMM_TILES, "GEMM_TILES (bm, bn)")
    entry = tuple(block) if isinstance(block, (list, tuple)) else block
    if entry in table and all(type(b) is int for b in entry):
        return table.index(entry)
    raise ValueError(f"{name}: block={block!r} is not an entry of {what} "
                     f"{table} (r = {r}), nor None for the rule's plan")


def _check_batch(name: str, Sigmas: torch.Tensor, etas: torch.Tensor,
                 **iterates: torch.Tensor) -> tuple[int, int, int]:
    """Sigmas (m, p, p), every iterate (m, p, r), etas (m,), float32.
    Returns (m, p, r)."""
    first = next(iter(iterates.values()))
    if first.ndim != 3 or Sigmas.ndim != 3:
        raise ValueError(f"{name}: Sigmas (m, p, p) and iterates "
                         f"(m, p[, r]) expected, got {tuple(Sigmas.shape)}, "
                         f"{tuple(first.shape)}")
    m, p, r = first.shape
    if tuple(Sigmas.shape) != (m, p, p) or tuple(etas.shape) != (m,) \
            or any(t.shape != first.shape for t in iterates.values()):
        shapes = ", ".join(f"{k} {tuple(t.shape)}"
                           for k, t in iterates.items())
        raise ValueError(
            f"{name}: shapes Sigmas {tuple(Sigmas.shape)}, {shapes}, etas "
            f"{tuple(etas.shape)} do not fit (m, p, r) = {(m, p, r)}")
    check_f32(name, Sigmas=Sigmas, etas=etas, **iterates)
    return m, p, r


def _per_task(name: str, arg: str, v, m: int,
              device: torch.device) -> torch.Tensor:
    """A scalar or per-task (m,) value `arg` as a contiguous float32 (m,)
    tensor on `device`."""
    if isinstance(v, torch.Tensor):
        check_f32(name, **{arg: v})
    t = torch.as_tensor(v, dtype=torch.float32, device=device).reshape(-1)
    if t.numel() not in (1, m):
        raise ValueError(f"{name}: {arg} must be a scalar or ({m},), got "
                         f"{t.numel()} values")
    return t.expand(m).contiguous()


def _kernel_ready(name: str, shape, tensors) -> None:
    if min(shape) == 0:
        raise ValueError(f"{name}: empty shape {tuple(shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: the kernel takes contiguous tensors")


def fista_step_batched(Sigmas: torch.Tensor, zs: torch.Tensor,
                       xs: torch.Tensor, cs: torch.Tensor,
                       etas: torch.Tensor, lam, theta, *,
                       use_kernel: bool | None = None, block=None):
    """One fused FISTA iteration (prox step + momentum extrapolation)
    for m tasks. Sigmas (m, p, p); zs/xs/cs (m, p) or (m, p, r); etas
    (m,) per-task step sizes; lam a scalar or per-task (m,); theta the
    float32 scalar momentum coefficient, a host number; `block` a plan
    of GEMV_PLANS (r == 1) or GEMM_TILES (r > 1), or None for the
    rule's. Returns (x_next, z_next), fresh tensors (never aliasing zs
    or xs)."""
    squeeze = zs.ndim == 2
    if squeeze:
        zs, xs, cs = zs[..., None], xs[..., None], cs[..., None]
    m, p, r = _check_batch("fista_step_batched", Sigmas, etas, zs=zs, xs=xs,
                           cs=cs)
    plan = check_block("fista_step_batched", r, block)
    lam_t = _per_task("fista_step_batched", "lam", lam, m, zs.device)
    tensors = (Sigmas, zs, xs, cs, etas, lam_t)
    if not resolve_use_kernel("fista_step_batched", use_kernel, *tensors):
        xn, zn = fista_step_batched_ref(Sigmas, zs, xs, cs, etas, lam_t,
                                        theta)
        return (xn[..., 0], zn[..., 0]) if squeeze else (xn, zn)
    _kernel_ready("fista_step_batched", (m, p, r), tensors)
    xn = torch.empty_like(zs)
    zn = torch.empty_like(zs)
    launch(Sigmas, zs, xs, cs, etas, lam_t, theta, xn, zn, plan)
    return (xn[..., 0], zn[..., 0]) if squeeze else (xn, zn)


def launch(Sigmas, zs, xs, cs, etas, lams, theta, xn, zn,
           plan: int = -1) -> None:
    """Launch the kernel into the given outputs, with no checks: the
    operands are what `fista_step_batched` passes (float32, contiguous,
    one CUDA device; Sigmas (m, p, p), zs/xs/cs/xn/zn (m, p, r), etas and
    lams (m,), xn and zn aliasing neither zs nor xs); `plan` as
    `check_block` returns it (the launcher refuses one out of range). A
    timing loop calls it to time the kernel alone."""
    m, p, r = zs.shape
    ptrs = [t.data_ptr() for t in (Sigmas, zs, xs, cs, etas, lams)]
    dev = zs.device
    if r == 1:
        fn = _build.function("fista_step", "fista_step_gemv_f32",
                             _GEMV_ARGTYPES)
        _build.call(fn, *ptrs, float(theta), xn.data_ptr(), zn.data_ptr(), m,
                    p, dev.index, _build.stream(dev), plan)
        LAUNCHES["fista_step_gemv"] += 1
    else:
        fn = _build.function("fista_step", "fista_step_gemm_f32",
                             _GEMM_ARGTYPES)
        _build.call(fn, *ptrs, float(theta), xn.data_ptr(), zn.data_ptr(), m,
                    p, r, dev.index, _build.stream(dev), plan)
        LAUNCHES["fista_step_gemm"] += 1


def ista_step_batched(Sigmas: torch.Tensor, betas: torch.Tensor,
                      cs: torch.Tensor, etas: torch.Tensor, lam, *,
                      use_kernel: bool | None = None,
                      block=None) -> torch.Tensor:
    """One ISTA step for m tasks, beta' = soft(beta - eta (Sigma beta -
    c), eta lam). Sigmas (m, p, p); betas, cs (m, p) or (m, p, r); etas
    (m,) per-task step sizes; lam a scalar or per-task (m,); `block` as
    in `fista_step_batched`. Returns a fresh tensor shaped like
    `betas`."""
    squeeze = betas.ndim == 2
    if squeeze:
        betas, cs = betas[..., None], cs[..., None]
    m, p, r = _check_batch("ista_step_batched", Sigmas, etas, betas=betas,
                           cs=cs)
    plan = check_block("ista_step_batched", r, block)
    lam_t = _per_task("ista_step_batched", "lam", lam, m,
                      betas.device)
    tensors = (Sigmas, betas, cs, etas, lam_t)
    if resolve_use_kernel("ista_step_batched", use_kernel, *tensors):
        _kernel_ready("ista_step_batched", (m, p, r), tensors)
        out = torch.empty_like(betas)
        launch_ista(*tensors, out, "ista_step_batched", plan)
    else:
        out = ista_step_batched_ref(*tensors)
    return out[..., 0] if squeeze else out


def ista_step(Sigma: torch.Tensor, beta: torch.Tensor, c: torch.Tensor,
              eta, lam, *, use_kernel: bool | None = None,
              block=None) -> torch.Tensor:
    """One ISTA step for one task: Sigma (p, p); beta, c (p,) or (p, r);
    eta and lam scalars (numbers or one-element float32 tensors); `block`
    as in `fista_step_batched`. On CUDA tensors it is the batched kernel
    at m = 1. Returns a fresh tensor shaped like `beta`."""
    squeeze = beta.ndim == 1
    if squeeze:
        beta, c = beta[:, None], c[:, None]
    if Sigma.ndim != 2 or beta.ndim != 2:
        raise ValueError(f"ista_step: Sigma (p, p) and beta (p[, r]) "
                         f"expected, got {tuple(Sigma.shape)}, "
                         f"{tuple(beta.shape)}")
    p, r = beta.shape
    plan = check_block("ista_step", r, block)
    eta_t = _per_task("ista_step", "eta", eta, 1, beta.device)
    lam_t = _per_task("ista_step", "lam", lam, 1, beta.device)
    _check_batch("ista_step", Sigma[None], eta_t, beta=beta[None],
                 c=c[None])
    tensors = (Sigma, beta, c, eta_t, lam_t)
    if resolve_use_kernel("ista_step", use_kernel, *tensors):
        _kernel_ready("ista_step", (p, r), tensors)
        out = torch.empty_like(beta)
        launch_ista(Sigma[None], beta[None], c[None], eta_t, lam_t,
                    out[None], "ista_step", plan)
    else:
        out = ista_step_ref(Sigma, beta, c, eta_t[0], lam_t[0])
    return out[:, 0] if squeeze else out


def ista_solve(Sigma: torch.Tensor, c: torch.Tensor, lam, *,
               iters: int = 400, use_kernel: bool | None = None,
               block=None) -> torch.Tensor:
    """Proximal-gradient (ISTA, no momentum) lasso solve on sufficient
    statistics, min_b 1/2 b'Sigma b - c'b + lam |b|_1, for one task:
    Sigma (p, p), c (p,) or (p, r) (multi-RHS). The step is
    1/max(lambda_max(Sigma), 1e-12); `iters` steps of `ista_step` from
    zero, a host loop, each launching `block` (as in `ista_step`)."""
    check_block("ista_solve", 1 if c.ndim == 1 else c.shape[-1], block)
    from repro_torch.core.solvers import power_iteration
    eta = 1.0 / torch.clamp_min(power_iteration(Sigma), 1e-12)
    lam_t = torch.as_tensor(lam, dtype=torch.float32, device=c.device)
    beta = torch.zeros_like(c)
    for _ in range(iters):
        beta = ista_step(Sigma, beta, c, eta, lam_t, use_kernel=use_kernel,
                         block=block)
    return beta


def launch_ista(Sigmas, betas, cs, etas, lams, out, counter: str,
                plan: int = -1) -> None:
    """Launch the ISTA step kernel into `out`, with no checks: the
    operands are what `ista_step_batched` passes (float32, contiguous, one
    CUDA device; Sigmas (m, p, p), betas/cs/out (m, p, r), etas and lams
    (m,), out not aliasing betas; `plan` as `check_block` returns it).
    Adds one to LAUNCHES[counter + "_gemv"] or [counter + "_gemm"]. A
    timing loop calls it to time the kernel alone."""
    m, p, r = betas.shape
    ptrs = [t.data_ptr() for t in (Sigmas, betas, cs, etas, lams, out)]
    dev = betas.device
    if r == 1:
        fn = _build.function("fista_step", "ista_step_gemv_f32",
                             _ISTA_GEMV_ARGTYPES)
        _build.call(fn, *ptrs, m, p, dev.index, _build.stream(dev), plan)
        LAUNCHES[counter + "_gemv"] += 1
    else:
        fn = _build.function("fista_step", "ista_step_gemm_f32",
                             _ISTA_GEMM_ARGTYPES)
        _build.call(fn, *ptrs, m, p, r, dev.index, _build.stream(dev), plan)
        LAUNCHES[counter + "_gemm"] += 1
