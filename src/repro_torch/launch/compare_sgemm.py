"""Hold a DSML kernel library against an earlier build of it, on the card:
the same bits (or the fits' tolerance) on the DSML paths, and both times in
one run.

    PYTHONPATH=src python -m repro_torch.launch.compare_sgemm \
        [--library fista_step|rank_update|logistic_grad|group_threshold|
                   flash_attention] \
        --source OLD/<library>.cu [--build-dir DIR]

`--source` is an earlier `kernels/csrc/<library>.cu` (for example the
file from a parent commit). It is built with the flags of
`kernels/_build.py` into `--build-dir` (a new temporary directory by
default) and put in place of the current library, for the runs that need
it only. An earlier source whose launch entries lack the trailing
`int plan` argument is called with it all the same (the callee never
reads an extra trailing argument in the x86-64 calling convention), so
it launches its own rule's plan whatever plan is asked. Every mode runs
at the configuration of `chip_smoke.py` phases 4, 4b and 4c (m = 16,
n = 512, p = 1024, s = 16, seed 0), with the current kernel and with
the earlier one, times both kernels alone in turns (earlier, current,
current, earlier), each turn by CUDA events (mean of 20 launches issued
from Python) and by `graph_ms` (the same 20
captured in a CUDA graph: the device time alone, which is what tells
kernels apart where the host's issue time exceeds them), beside the
PyTorch call that computes the same product, and prints the card's name
and power limit. They exit non-zero if a check fails, and without a CUDA
device.

* `fista_step` (the default), the FISTA/ISTA step's GEMV (r = 1) and
  SGEMM (r > 1): `dsml_fit` (400 r = 1 and 600 r = p launches),
  `dsml_logistic_fit` (600 r = p), `ista_solve` (400 r = 1 steps of one
  task) and phase 4c's `ista_step` and `ista_step_batched`, at r = 1 on
  the fit's beta_local and at r = p, on the fit's statistics, must give
  the same bits. Times of the SGEMM at (16, 1024, 1024) with momentum
  and (1, 1024, 1024) without, and of the GEMV at (16, 1024, 1) with
  momentum and (1, 1024, 1) without, beside `bmm` / `mm`.
* `rank_update`, the rank-n update: `dsml_fit` (one launch) must give
  the same bits, and so must `rank_update` and the unfused pair's
  Sigma and c, unweighted, on the fit's X and y; `dsml_logistic_fit`
  (two weighted launches) beta_u and beta_local within 1e-4 * max|.|
  with the same support (the weighted kernels may differ in the last
  bits of Sigma's lower triangle). Times of the fused kernel at the
  fits' (16, 512, 1024), unweighted and weighted, and at the streaming
  ingest's (8, 1024, 256), beside `bmm(X', X)`.
* `logistic_grad`, the logistic gradient: `dsml_logistic_fit` (600 fused
  launches) must give the same bits where the earlier fused kernel has
  the current plan (its library has `logistic_grad_plan`), else beta_u
  and beta_local within 1e-4 * max|.| with the same support; the fused
  kernel and the unfused pair at (16, 512, 1024) and (4, 256, 8192) must
  be within 1e-5 * max|plain| of the earlier ones and give the same bits
  on a second call. An earlier fused kernel without `logistic_grad_plan`
  staged slabs of rows and took its launch shape from the caller: it
  runs with the shape its rule gives (`_slab_plan`). An earlier source
  with the current unfused entry (`logistic_unfused_f32`) runs through
  `launch_unfused`; one whose first unfused kernel writes z
  (`logistic_z_f32`) runs as that pair was run, with the residual taken
  in PyTorch between the two launches. Times of the fused kernel and of
  both pairs at both shapes, beside the two products `bmm(X, b)` and
  `bmm(X', r)`.
* `group_threshold`, the master step's threshold: the keep column and
  the rows of both kernels must be the same bits, in float32 and
  bfloat16, at the master step's (1024, 16) and at (1001, 5). Times of
  both at (1024, 16) in both types (three rounds of turns), beside the
  PyTorch norm-and-mask, a copy of B (one read and one write, the floor
  of a kernel that moves B) and an empty kernel (the launch floor).
* `flash_attention`, the attention forward, at the shapes of
  `chip_smoke.py` phase 5's flash rows (`FLASH_ROWS`: the prefills of
  granite-3-2b, minitron-4b, deepseek-moe-16b, internvl2-2b,
  recurrentgemma-9b and seamless-m4t-medium's encoder at 4 x 2048
  prompts) in bf16, where both kernels must give the same bits, except
  at H = 256, where either may have its own design and both must hold
  each query row within a relative l2 error of 1e-2 of the plain version
  on the f32 upcast (phase 3's bar); and in f32 at three small shapes
  and at phase 5's four f32 rows (`FLASH_F32_ROWS`, the f32 copies'
  instances), where the earlier file may have another design of the f32
  products: the output and lse of each kernel within phase 3's f32 bars
  of the plain version (2e-5 · max|plain|, 1e-4 a row, lse 1e-5 ·
  max(1, |lse|)), and the current kernel's the same bits twice. Times of
  both at every bf16 row and every f32 row (the training one with its
  lse), beside SDPA (`timing.sdpa_yardstick`: `is_causal`, no window,
  the rows' windows covering their prompts; a gradient for the lse row)
  and the kernels SDPA runs.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import tempfile
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import (
    dsml_fit, dsml_logistic_fit, gen_classification, gen_regression,
)
from repro_torch.core import engine
from repro_torch.core.engine import (
    power_iteration_batched, scaled_identity_m0,
)
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.group_threshold import ops as threshold_ops
from repro_torch.kernels.ista_step import ops as ista_ops
from repro_torch.kernels.ista_step.ops import (
    ista_solve, ista_step, ista_step_batched,
)
from repro_torch.kernels.logistic_grad import ops as logistic_ops
from repro_torch.kernels.group_threshold.ops import group_threshold
from repro_torch.kernels.logistic_grad.ops import (
    logistic_grad, logistic_grad_unfused,
)
from repro_torch.kernels.rank_update import ops as rank_ops
from repro_torch.kernels.rank_update.ops import (
    rank_update, rank_update_unfused,
)
from repro_torch.launch.timing import (
    device_kernel_names, graph_ms, sdpa_yardstick, time_ms,
)

M, N, P, S = 16, 512, 1024, 16            # chip_smoke.py phases 4-4c
INGEST = (8, 1024, 256)                   # benchmarks/stream_bench.py
LARGE_P = (4, 256, 8192)                  # benchmarks/largep_logistic.py
TOL_FIT = 1e-4                            # x max|.|, as chip_smoke.py
TOL_KERNEL = 1e-5                         # x max|plain|, as chip_smoke.py
# per query row (relative l2), as phase 3: bf16, f32
TOL_FLASH_ROW = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
TOL_FLASH = 2e-5                          # x max|plain|, f32, as phase 3
TOL_LSE = 1e-5                            # x max(1, |lse|), f32, as phase 3
# (B, S, N, K, H), causal, window: chip_smoke.py phase 5's flash rows
FLASH_ROWS = {
    "granite-3-2b": ((4, 2048, 32, 8, 64), True, 0),
    "minitron-4b": ((4, 2048, 24, 8, 128), True, 0),
    "deepseek-moe-16b": ((4, 2048, 16, 16, 128), True, 0),
    "internvl2-2b": ((4, 3072, 16, 8, 128), True, 0),
    "recurrentgemma-9b": ((4, 2048, 16, 1, 256), True, 2048),
    "seamless-m4t-medium encoder": ((4, 4096, 16, 16, 64), False, 0),
}
FLASH_F32 = (((2, 256, 8, 2, 64), True, 0), ((1, 200, 4, 1, 128), True, 0),
             ((1, 512, 4, 1, 256), True, 64))
# (B, S, N, K, H), window, lse: chip_smoke.py phase 5's f32 rows, the f32
# copies' instances (`f32_flash_shapes`), causal
FLASH_F32_ROWS = {
    "10b granite-3-2b training": ((4, 2048, 32, 8, 64), 0, True),
    "6 granite-3-2b": ((2, 2048, 32, 8, 64), 0, False),
    "9a deepseek-moe-16b": ((2, 2048, 16, 16, 128), 0, False),
    "13c-rg recurrentgemma-9b rank": ((1, 2048, 8, 1, 256), 2048, False),
}
_HALF_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + \
    [ctypes.c_void_p]
_SLAB_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + \
    [ctypes.c_void_p]


def _times(fn) -> tuple[float, float]:
    """(CUDA-events ms, graph ms) of one call of `fn`."""
    return time_ms(fn), graph_ms(fn)[0]


def _build_earlier(library: str, source: Path,
                   build_dir: Path) -> ctypes.CDLL:
    build_dir.mkdir(parents=True, exist_ok=True)
    out = build_dir / f"lib{library}_earlier.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(source)], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(out))


@contextmanager
def _library(library: str, lib: ctypes.CDLL):
    """`lib` in place of the current library `library`."""
    current = _build._LIBS[library]
    _build._LIBS[library] = lib
    _build._FNS.clear()
    try:
        yield
    finally:
        _build._LIBS[library] = current
        _build._FNS.clear()


def _same(label: str, new, old) -> bool:
    news = new if isinstance(new, tuple) else (new,)
    olds = old if isinstance(old, tuple) else (old,)
    same = all(torch.equal(a, b) for a, b in zip(news, olds))
    print(f"{label}: {'the same bits' if same else 'DIFFERENT BITS'}")
    return same


def _turns(library: str, earlier: ctypes.CDLL, kernel,
           earlier_kernel=None, rounds: int = 1) -> dict:
    """`kernel` timed with the earlier library and the current one in
    turns: earlier, current, current, earlier (`rounds` times); by CUDA
    events and by `graph_ms`. `earlier_kernel` runs in the earlier turns
    where the earlier library is called otherwise."""
    row = {"earlier": [], "current": [], "earlier_graph": [],
           "current_graph": []}
    for lib in (earlier, None, None, earlier) * rounds:
        if lib is None:
            ms, g = _times(kernel)
            row["current"].append(ms)
            row["current_graph"].append(g)
        else:
            with _library(library, lib):
                ms, g = _times(earlier_kernel or kernel)
            row["earlier"].append(ms)
            row["earlier_graph"].append(g)
    return row


def _library_row(fn) -> dict:
    ms, g = _times(fn)
    return {"library": [ms], "library_graph": [g]}


def _fits(dev: torch.device):
    """The data and arguments of `chip_smoke.py` phases 4 and 4b."""
    data = gen_regression(torch.Generator(device=dev).manual_seed(0),
                          m=M, n=N, p=P, s=S, signal_low=0.3, device=dev)
    lam = 4.0 * float(np.sqrt(np.log(P) / N))
    mu = float(np.sqrt(np.log(P) / N))
    cdata = gen_classification(torch.Generator(device=dev).manual_seed(0),
                               m=M, n=N, p=P, s=S, device=dev)
    lam_c = float(np.sqrt(np.log(P) / N))
    return (data, (data.Xs, data.ys, lam, mu, 1.0),
            (cdata.Xs, cdata.ys, lam_c, 2.0 * lam_c, 0.75))


def _compare_sgemm(earlier: ctypes.CDLL, dev: torch.device,
                   times: dict) -> list[bool]:
    data, fit_args, cfit_args = _fits(dev)
    lam, mu = fit_args[2], fit_args[3]
    Sig0, c0 = rank_update(data.Xs, data.ys, use_kernel=False)
    etas0 = 1.0 / torch.clamp_min(power_iteration_batched(Sig0), 1e-12)
    M0 = scaled_identity_m0(Sig0)
    eye = torch.eye(P, device=dev)
    eyes = eye.expand(M, P, P).contiguous()
    beta = dsml_fit(*fit_args, use_kernel=False).beta_local

    def paths():
        return {
            "phase 4 dsml_fit": dsml_fit(*fit_args),
            "phase 4b dsml_logistic_fit": dsml_logistic_fit(*cfit_args),
            "phase 4c ista_solve r=1": ista_solve(Sig0[0], c0[0], 0.5 * lam,
                                                  iters=400),
            "phase 4c ista_step r=1": ista_step(Sig0[0], beta[0], c0[0],
                                                etas0[0], 0.5 * lam),
            "phase 4c ista_step_batched r=1": ista_step_batched(
                Sig0, beta, c0, etas0, 0.5 * lam),
            "phase 4c ista_step r=p": ista_step(Sig0[0], M0[0], eye,
                                                etas0[0], mu),
            "phase 4c ista_step_batched r=p": ista_step_batched(
                Sig0, M0, eyes, etas0, mu),
        }

    new = paths()
    with _library("fista_step", earlier):
        old = paths()
    torch.cuda.synchronize()
    same = [_same(k, tuple(new[k]) if k.endswith("fit") else new[k],
                  tuple(old[k]) if k.endswith("fit") else old[k])
            for k in new]

    g = torch.Generator(device=dev).manual_seed(1)
    z = 0.05 * torch.randn((M, P, P), generator=g, device=dev)
    x = z + 0.01 * torch.randn((M, P, P), generator=g, device=dev)
    lams = torch.full((M,), mu, device=dev)
    xn, zn = torch.empty_like(z), torch.empty_like(z)
    one = [t[:1].contiguous() for t in (Sig0, M0, eyes, etas0, lams)]
    out1 = torch.empty_like(one[1])
    zv, xv = z[..., :1].contiguous(), x[..., :1].contiguous()
    cv = c0[..., None].contiguous()
    xnv, znv = torch.empty_like(zv), torch.empty_like(zv)
    onev = [Sig0[:1], zv[:1], cv[:1], etas0[:1], lams[:1]]
    out1v = torch.empty_like(onev[1])
    calls = {
        "fista_step_gemm (16, 1024, 1024)": (
            lambda: ista_ops.launch(Sig0, z, x, eyes, etas0, lams,
                                    np.float32(0.7), xn, zn),
            lambda: torch.bmm(Sig0, z)),
        "ista_step_gemm (1, 1024, 1024)": (
            lambda: ista_ops.launch_ista(*one, out1, "ista_step"),
            lambda: torch.mm(one[0][0], one[1][0])),
        "fista_step_gemv (16, 1024, 1)": (
            lambda: ista_ops.launch(Sig0, zv, xv, cv, etas0, lams,
                                    np.float32(0.7), xnv, znv),
            lambda: torch.bmm(Sig0, zv)),
        "ista_step_gemv (1, 1024, 1)": (
            lambda: ista_ops.launch_ista(*onev, out1v, "ista_step"),
            lambda: torch.mm(onev[0][0], onev[1][0])),
    }
    for name, (kernel, library) in calls.items():
        times[name] = {**_turns("fista_step", earlier, kernel),
                       **_library_row(library)}
    return same


def _compare_rank(earlier: ctypes.CDLL, dev: torch.device,
                  times: dict) -> list[bool]:
    data, fit_args, cfit_args = _fits(dev)
    Xs, ys = data.Xs, data.ys

    def paths():
        return {"phase 4 dsml_fit": tuple(dsml_fit(*fit_args)),
                "phase 4c rank_update": rank_update(Xs, ys),
                "phase 4c rank_update_unfused": rank_update_unfused(Xs, ys),
                "phase 4b dsml_logistic_fit": dsml_logistic_fit(*cfit_args)}

    new = paths()
    with _library("rank_update", earlier):
        old = paths()
    torch.cuda.synchronize()
    logistic = "phase 4b dsml_logistic_fit"
    same = [_same(k, new[k], old[k]) for k in new if k != logistic]
    got, ref = new[logistic], old[logistic]
    for name in ("beta_u", "beta_local"):
        a, b = getattr(got, name), getattr(ref, name)
        err = torch.max(torch.abs(a - b)).item()
        scale = torch.max(torch.abs(b)).item()
        print(f"{logistic} {name}: max abs err vs earlier {err:.3g} "
              f"(max {scale:.3g}, bar {TOL_FIT} x max)")
        same.append(err <= TOL_FIT * scale)
    same.append(_same(f"{logistic} support", got.support, ref.support))

    g = torch.Generator(device=dev).manual_seed(1)
    for m, n, p in ((M, N, P), INGEST):
        X = torch.randn((m, n, p), generator=g, device=dev)
        y = torch.randn((m, n), generator=g, device=dev)
        w = 0.5 + torch.rand((m, n), generator=g, device=dev)
        Sig, c = torch.empty((m, p, p), device=dev), torch.empty((m, p),
                                                                 device=dev)
        Xt = X.transpose(1, 2)
        for wt in (None, w) if (m, n, p) == (M, N, P) else (None,):
            name = (f"rank_update ({m}, {n}, {p})"
                    + (" weighted" if wt is not None else ""))
            times[name] = {
                **_turns("rank_update", earlier,
                         lambda X=X, y=y, wt=wt, Sig=Sig, c=c:
                         rank_ops.launch(X, y, wt, Sig, c)),
                **_library_row(lambda X=X, Xt=Xt: torch.bmm(Xt, X))}
    return same


def _earlier_unfused(Xs, ys, B, z, G) -> None:
    """The unfused pair of the earlier library in place: through
    `launch_unfused` where it has the current entry, else as its pair ran,
    z = X b by its first kernel, the residual in PyTorch, then its
    back-projection."""
    if hasattr(_build._LIBS["logistic_grad"], "logistic_unfused_f32"):
        logistic_ops.launch_unfused(Xs, ys, B, z, G)
        return
    m, n, p = Xs.shape
    dev, stream = Xs.device.index, _build.stream(Xs.device)
    fn = _build.function("logistic_grad", "logistic_z_f32", _HALF_ARGTYPES)
    _build.call(fn, Xs.data_ptr(), B.data_ptr(), z.data_ptr(), m, n, p,
                dev, stream)
    rs = ys * torch.sigmoid(-ys * z)
    fn = _build.function("logistic_grad", "logistic_backproject_f32",
                         _HALF_ARGTYPES)
    _build.call(fn, Xs.data_ptr(), rs.data_ptr(), G.data_ptr(), m, n, p,
                dev, stream)


def _slab_plan(m: int, n: int, p: int, sms: int,
               optin: int) -> tuple[int, int, int, int]:
    """(chunks, rows a chunk, slab, shared memory) of an earlier fused
    kernel that staged slabs of up to 8 rows, b and its accumulator in
    shared memory, by that kernel's rule: chunks for two blocks an SM, at
    most 512 KB of partial rows a task and no empty chunk; the most rows
    a slab that fit in half an SM's shared memory (in all of it where the
    grid has no more blocks than SMs or a row does not fit in half);
    shared memory 0, X read twice, where one row does not fit at all."""
    slab_max, static, reserved = 8, 512, 1024
    chunks = max(1, min(-(-2 * sms // m), 512 * 1024 // (4 * p), n))
    rows = -(-n // chunks)
    chunks = -(-n // rows)
    row_bytes = 4 * p
    slab = (optin // 2 - reserved - static - 2 * row_bytes) // row_bytes
    if slab < 1 or m * chunks <= sms:
        slab = (optin - static - 2 * row_bytes) // row_bytes
    slab = min(slab, slab_max, rows)
    if slab < 1:
        return chunks, rows, slab_max, 0
    return chunks, rows, slab, (slab + 2) * row_bytes


def _earlier_fused(X, y, B):
    """A call of the earlier library's fused kernel on (X, y, B) into
    buffers made here: through `launch` with the buffers its own
    `logistic_grad_plan` asks for, where it has one, else with
    `_slab_plan`'s shape. Call it with the earlier library in place.
    Returns (call, G)."""
    m, n, p = X.shape
    G = torch.empty((m, p), device=X.device)
    if hasattr(_build._LIBS["logistic_grad"], "logistic_grad_plan"):
        pl, _ = logistic_ops.kernel_plan(m, n, p,
                                         logistic_ops.vectorized(X, B),
                                         X.device)
        work = torch.empty((m, pl.chunks, p), device=X.device)
        cnt = torch.zeros(m * pl.cluster, dtype=torch.int32, device=X.device)
        return (lambda: logistic_ops.launch(X, y, B, G, work, cnt)), G
    chunks, rows, slab, smem = _slab_plan(
        m, n, p, *logistic_ops._device_limits(X.device))
    work = torch.empty((m, chunks, p), device=X.device)
    cnt = torch.zeros(m, dtype=torch.int32, device=X.device)
    fn = _build.function("logistic_grad", "logistic_grad_f32", _SLAB_ARGTYPES)

    def call():
        _build.call(fn, X.data_ptr(), y.data_ptr(), B.data_ptr(),
                    work.data_ptr(), cnt.data_ptr(), G.data_ptr(), m, n, p,
                    chunks, rows, slab, smem, X.device.index,
                    _build.stream(X.device))
    return call, G


@contextmanager
def _earlier_solver_gradient():
    """The logistic solver's gradient through the earlier fused kernel
    (whose entry may take other arguments than the current wrapper
    passes); inside `_library`."""
    def grad(Xs, ys, B, use_kernel=None):
        call, G = _earlier_fused(Xs, ys, B)
        call()
        return G
    current = engine.logistic_grad
    engine.logistic_grad = grad
    try:
        yield
    finally:
        engine.logistic_grad = current


def _compare_logistic(earlier: ctypes.CDLL, dev: torch.device,
                      times: dict) -> list[bool]:
    _, _, cfit_args = _fits(dev)
    new = dsml_logistic_fit(*cfit_args)
    with _library("logistic_grad", earlier), _earlier_solver_gradient():
        old = dsml_logistic_fit(*cfit_args)
    torch.cuda.synchronize()
    fit = "phase 4b dsml_logistic_fit"
    if hasattr(earlier, "logistic_grad_plan"):
        same = [_same(fit, tuple(new), tuple(old))]
    else:
        _same(fit, tuple(new), tuple(old))
        same = []
        for name in ("beta_u", "beta_local"):
            a, b = getattr(new, name), getattr(old, name)
            err = torch.max(torch.abs(a - b)).item()
            scale = torch.max(torch.abs(b)).item()
            print(f"{fit} {name}: max abs err vs earlier {err:.3g} (max "
                  f"{scale:.3g}, bar {TOL_FIT} x max)")
            same.append(err <= TOL_FIT * scale)
        same.append(_same(f"{fit} support", new.support, old.support))

    g = torch.Generator(device=dev).manual_seed(1)
    for m, n, p in ((M, N, P), LARGE_P):
        X = torch.randn((m, n, p), generator=g, device=dev)
        y = torch.where(torch.rand((m, n), generator=g, device=dev) < 0.5,
                        1.0, -1.0)
        B = torch.randn((m, p), generator=g, device=dev) / float(np.sqrt(p))
        z, G = torch.empty((m, n), device=dev), torch.empty((m, p),
                                                            device=dev)
        fused = f"logistic_grad ({m}, {n}, {p})"
        got = logistic_grad(X, y, B)
        again = logistic_grad(X, y, B)
        with _library("logistic_grad", earlier):
            call, ref = _earlier_fused(X, y, B)
            call()
        plain = logistic_grad(X, y, B, use_kernel=False)
        torch.cuda.synchronize()
        err = torch.max(torch.abs(got - ref)).item()
        scale = torch.max(torch.abs(plain)).item()
        print(f"{fused}: max abs err vs earlier {err:.3g} (max|plain| "
              f"{scale:.3g}, bar {TOL_KERNEL} x max|plain|)")
        same.append(err <= TOL_KERNEL * scale)
        same.append(_same(f"{fused} on a second call", got, again))
        Gk = torch.empty_like(got)
        pl, _ = logistic_ops.kernel_plan(m, n, p,
                                         logistic_ops.vectorized(X, B), dev)
        work = torch.empty((m, pl.chunks, p), device=dev)
        cnt = torch.zeros(m * pl.cluster, dtype=torch.int32, device=dev)
        with _library("logistic_grad", earlier):
            earlier_call, _ = _earlier_fused(X, y, B)
        times[fused] = {
            **_turns("logistic_grad", earlier,
                     lambda a=(X, y, B, Gk, work, cnt):
                     logistic_ops.launch(*a),
                     earlier_call),
            **_library_row(lambda X=X, B=B, y=y: (
                torch.bmm(X, B[..., None]),
                torch.bmm(X.transpose(1, 2), y[..., None])))}

        label = f"logistic_grad_unfused ({m}, {n}, {p})"
        got = logistic_grad_unfused(X, y, B)
        again = logistic_grad_unfused(X, y, B)
        with _library("logistic_grad", earlier):
            ref = torch.empty_like(G)
            _earlier_unfused(X, y, B, z, ref)
        plain = logistic_grad_unfused(X, y, B, use_kernel=False)
        torch.cuda.synchronize()
        err = torch.max(torch.abs(got - ref)).item()
        scale = torch.max(torch.abs(plain)).item()
        print(f"{label}: max abs err vs earlier {err:.3g} (max|plain| "
              f"{scale:.3g}, bar {TOL_KERNEL} x max|plain|)")
        same.append(err <= TOL_KERNEL * scale)
        same.append(_same(f"{label} on a second call", got, again))
        Xt = X.transpose(1, 2)
        r = y * torch.sigmoid(-y * torch.bmm(X, B[..., None])[..., 0])
        times[label] = {
            **_turns("logistic_grad", earlier,
                     lambda a=(X, y, B, z, G): logistic_ops.launch_unfused(*a),
                     lambda a=(X, y, B, z, G): _earlier_unfused(*a)),
            **_library_row(lambda X=X, Xt=Xt, B=B, r=r: (
                torch.bmm(X, B[..., None]), torch.bmm(Xt, r[..., None])))}
    return same


def _compare_threshold(earlier: ctypes.CDLL, dev: torch.device,
                       times: dict) -> list[bool]:
    g = torch.Generator(device=dev).manual_seed(1)
    same = []
    for dtype in (torch.float32, torch.bfloat16):
        for p, m in ((P, M), (1001, 5)):
            B = (torch.randn((p, m), generator=g, device=dev)
                 * (0.1 + 2.0 * torch.rand((p, 1), generator=g, device=dev))
                 / float(np.sqrt(m))).to(dtype)
            label = f"group_threshold ({p}, {m}) {str(dtype)[6:]}"
            new = group_threshold(B, 0.8)
            with _library("group_threshold", earlier):
                old = group_threshold(B, 0.8)
            torch.cuda.synchronize()
            same.append(_same(label, new, old))
            if (p, m) != (P, M):
                continue
            out = torch.empty_like(B)
            keep = torch.empty(p, dtype=torch.int8, device=dev)
            times[label] = {
                **_turns("group_threshold", earlier,
                         lambda B=B, out=out, keep=keep:
                         threshold_ops.launch(B, 0.8, out, keep),
                         rounds=3),
                **_library_row(lambda B=B: B * (torch.linalg.vector_norm(
                    B.float(), dim=1, keepdim=True) > 0.8))}
            # the floor of a kernel that reads B once and writes it once
            times[f"copy of B ({p}, {m}) {str(dtype)[6:]}"] = {
                **_library_row(lambda B=B, out=out: out.copy_(B)),
                "earlier": [], "current": [], "earlier_graph": [],
                "current_graph": []}
    times["empty kernel (the launch floor)"] = {
        **_library_row(lambda: threshold_ops.launch_empty(dev)),
        "earlier": [], "current": [], "earlier_graph": [],
        "current_graph": []}
    return same


def _compare_flash(earlier: ctypes.CDLL, dev: torch.device,
                   times: dict) -> list[bool]:
    g = torch.Generator(device=dev).manual_seed(1)

    def inputs(b, s, n, k, h, dtype):
        return tuple(torch.randn(shape, generator=g, device=dev).to(dtype)
                     for shape in ((b, s, n, h), (b, s, k, h), (b, s, k, h)))

    def row_err(got, ref):
        num = torch.linalg.vector_norm(got.float() - ref, dim=-1)
        den = torch.clamp_min(torch.linalg.vector_norm(ref, dim=-1), 1e-30)
        return torch.max(num / den).item()

    def f32_bars(label, got, ref) -> bool:
        """An f32 (out, lse) within phase 3's bars of the plain one."""
        (out, lse), (ref_out, ref_lse) = got, ref
        err = (torch.max(torch.abs(out - ref_out))
               / torch.max(torch.abs(ref_out))).item()
        rows = row_err(out, ref_out)
        lse_err = (torch.abs(lse - ref_lse)
                   / torch.clamp_min(torch.abs(ref_lse), 1.0)).max().item()
        print(f"{label}: max abs err {err:.3g} of max|plain| (bar "
              f"{TOL_FLASH}), worst row {rows:.3g} (bar "
              f"{TOL_FLASH_ROW[torch.float32]}), lse {lse_err:.3g} (bar "
              f"{TOL_LSE})")
        return (err <= TOL_FLASH and rows <= TOL_FLASH_ROW[torch.float32]
                and lse_err <= TOL_LSE)

    same = []
    # (name, shape, causal, window, dtype, timed, with the lse)
    cases = [(name, shape, causal, window, torch.bfloat16, True, False)
             for name, (shape, causal, window) in FLASH_ROWS.items()]
    cases += [(f"f32 {shape}", shape, causal, window, torch.float32, False,
               False) for shape, causal, window in FLASH_F32]
    cases += [(f"f32 {name}", shape, True, window, torch.float32, True, lse)
              for name, (shape, window, lse) in FLASH_F32_ROWS.items()]
    for name, shape, causal, window, dtype, timed, with_lse in cases:
        q, k, v = inputs(*shape, dtype)
        label = f"flash_attention {name} {shape} {str(dtype)[6:]}"
        kw = dict(causal=causal, window=window)
        if dtype == torch.float32:
            # the two designs' f32 products differ (FP32 FMA in the
            # earlier file, three TF32 products now): each within the
            # f32 bars of the plain version, the current twice the same
            new = flash_ops.flash_attention_fwd_lse(q, k, v, **kw)
            again = flash_ops.flash_attention_fwd_lse(q, k, v, **kw)
            with _library("flash_attention", earlier):
                old = flash_ops.flash_attention_fwd_lse(q, k, v, **kw)
            ref = flash_ops.flash_attention_fwd_lse(q, k, v, **kw,
                                                    use_kernel=False)
            torch.cuda.synchronize()
            twice = all(torch.equal(a, b) for a, b in zip(new, again))
            print(f"{label}: the current kernel twice: "
                  + ("the same bits" if twice else "DIFFERENT BITS"))
            same += [twice, f32_bars(f"{label} current", new, ref),
                     f32_bars(f"{label} earlier", old, ref)]
        else:
            new = flash_attention(q, k, v, **kw)
            with _library("flash_attention", earlier):
                old = flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            if shape[4] == 256:
                ref = flash_attention(q.float(), k.float(), v.float(), **kw,
                                      use_kernel=False)
                errs = row_err(new, ref), row_err(old, ref)
                bar = TOL_FLASH_ROW[dtype]
                print(f"{label}: worst row relative error current "
                      f"{errs[0]:.4g}, earlier {errs[1]:.4g} (bar {bar}); "
                      + ("the same bits" if torch.equal(new, old)
                         else "other bits"))
                same.append(max(errs) <= bar)
            else:
                same.append(_same(label, new, old))
        if not timed:
            continue
        out = torch.empty_like(q)
        lse = (torch.empty((shape[0], shape[2], shape[1]), device=dev)
               if with_lse else None)
        lib, note = sdpa_yardstick(q, k, v, causal, grad=with_lse)
        times[label] = {
            **_turns("flash_attention", earlier,
                     lambda q=q, k=k, v=v, out=out, lse=lse, kw=kw:
                     flash_ops.launch(q, k, v, out, lse=lse, **kw)),
            **_library_row(lib), "library_note": note,
            "library_kernels": device_kernel_names(lib)}
    return same


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--library",
                    choices=("fista_step", "rank_update", "logistic_grad",
                             "group_threshold", "flash_attention"),
                    default="fista_step")
    ap.add_argument("--source", type=Path, required=True)
    ap.add_argument("--build-dir", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_sgemm: no CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    _build.build()
    build_dir = args.build_dir or Path(tempfile.mkdtemp(prefix="sgemm_"))
    earlier = _build_earlier(args.library, args.source.resolve(), build_dir)
    times: dict = {}
    compare = {"fista_step": _compare_sgemm, "rank_update": _compare_rank,
               "logistic_grad": _compare_logistic,
               "group_threshold": _compare_threshold,
               "flash_attention": _compare_flash}[args.library]
    same = compare(earlier, dev, times)
    for name, row in times.items():
        library = (f" (SDPA with {row['library_note']}: "
                   f"{row['library_kernels']})" if "library_note" in row
                   else "")
        print(f"time {name}: earlier {row['earlier']} ms, current "
              f"{row['current']} ms, library {row['library']} ms; device "
              f"only (graph): earlier {row['earlier_graph']} ms, current "
              f"{row['current_graph']} ms, library {row['library_graph']} "
              f"ms{library} [{smi}]")
    print(json.dumps({"library": args.library, "same_bits": all(same),
                      "times_ms": times, "card": smi}))
    if not all(same):
        raise SystemExit("compare_sgemm: an output differs")


if __name__ == "__main__":
    main()
