#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout

Phases, each of which raises on failure (exit code != 0):

1. the card: name, count, and `nvidia-smi` name and power limit;
2. build the CUDA kernels from `src/repro_torch/kernels/csrc` (nvcc, with
   `-Xptxas -v`: registers, shared memory and spills per kernel);
3. every kernel against its plain PyTorch version on the card, at the main
   paths' shapes and at ragged ones, max abs error <= 1e-5 * max|plain|
   per output (both accumulate in f32, in another order); the logistic
   gradient also at the large-p point m = 4, n = 256, p = 8192, and twice,
   to show that its sample reduction gives the same bits every run;
4. the regression path at full width: `dsml_fit` (DSML Algorithm 1) on
   m = 16 tasks, n = 512 samples, p = 1024 features, through the kernels
   (launch counts zeroed just before, read just after), then with
   `use_kernel=False` on the card as the reference: beta_u within
   1e-4 * max|beta_u| after 1000 chained FISTA iterations, identical
   support;
4b. the logistic path (paper Section 4) at the same widths:
   `dsml_logistic_fit` on `gen_classification` data, 600 lasso and 600
   debias iterations, launch counts zeroed just before and read just after,
   then the plain path on the card: beta_u and beta_local within
   1e-4 * max|.|, identical support;
5. times: each kernel alone (CUDA events, mean of 20 back-to-back
   launches into preallocated outputs after a warm-up; and again with the
   L2 cache flushed before each launch, since back to back an input of up
   to 50 MB stays in L2, as it does in the solver loops) beside its bound,
   its plain version, the nearest PyTorch call, and the wrapper as the
   main path calls it (checks and allocation included); and each fit's
   wall time on both paths.

It prints one JSON line of kernels and, last, the result line. With no
CUDA device it raises before printing any result.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published H100 SXM peaks (NVIDIA data sheet): f32 FMA outside the tensor
# cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

M, N, P, S = 16, 512, 1024, 16          # the main path's configuration
LARGE_P = (4, 256, 8192)                # benchmarks/largep_logistic.py
TOL_KERNEL = 1e-5                       # x max|plain|, per output
TOL_FIT = 1e-4                          # x max|.|, after chained FISTA steps


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def max_err(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(max |a - b|, max |b|)."""
    return (torch.max(torch.abs(a - b)).item(),
            torch.max(torch.abs(b)).item())


def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Mean device time of `fn` over `reps` calls, by CUDA events."""
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_ms_cold(fn, reps: int = 20, warm: int = 3) -> float:
    """Mean device time of `fn` with the 50 MB L2 cache flushed before
    each call (a 64 MB buffer is overwritten), by one pair of CUDA events
    per call."""
    flush = torch.empty(16 * 2**20, device="cuda")
    for _ in range(warm):
        fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """Least time on the card in ms, and what sets it."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def ptxas_lines(log: str) -> list[str]:
    """One line per compiled kernel from `nvcc -Xptxas -v`."""
    out, fn, spill = [], "?", ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn, spill = m.group(1), ""
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            used = line.split(":", 1)[1].strip()
            out.append(f"  {fn}: {used}; {spill}")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels "
                         "run only on an NVIDIA card")
    from repro_torch.core import (
        dsml_fit, dsml_logistic_fit, gen_classification, gen_regression,
        hamming,
    )
    from repro_torch.core.engine import power_iteration_batched
    from repro_torch.kernels import _build
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.kernels.ista_step import ops as ista_ops
    from repro_torch.kernels.ista_step.ops import fista_step_batched
    from repro_torch.kernels.ista_step.ref import fista_step_batched_ref
    from repro_torch.kernels.logistic_grad import ops as logistic_ops
    from repro_torch.kernels.logistic_grad.ops import (
        logistic_grad, logistic_grad_unfused,
    )
    from repro_torch.kernels.logistic_grad.ref import logistic_grad_ref
    from repro_torch.kernels.rank_update import ops as rank_ops
    from repro_torch.kernels.rank_update.ops import rank_update
    from repro_torch.kernels.rank_update.ref import rank_update_ref

    dev = torch.device("cuda")

    # ---- 1. the card ------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60
    ).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"device: {kind} x{count}; nvidia-smi: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc per source: {_build.BUILD_SECONDS})")
    for src, log in _build.BUILD_LOG.items():
        print(f"ptxas {src}.cu:")
        for line in ptxas_lines(log):
            print(line)

    # ---- 3. kernel vs plain -----------------------------------------------
    g = torch.Generator(device=dev).manual_seed(1)
    errs: dict[str, float] = {}

    def rank_inputs(m, n, p):
        X = torch.randn((m, n, p), generator=g, device=dev)
        y = torch.randn((m, n), generator=g, device=dev)
        w = 0.5 + torch.rand((m, n), generator=g, device=dev)
        return X, y, w

    def check_rank(label, X, y, w):
        got = rank_update(X, y, w, use_kernel=True)
        ref = rank_update(X, y, w, use_kernel=False)
        torch.cuda.synchronize()
        worst = 0.0
        for name, a, b in zip(("Sigma", "c"), got, ref):
            err, scale = max_err(a, b)
            check(err <= TOL_KERNEL * scale,
                  f"rank_update {label} {name}: err {err} > "
                  f"{TOL_KERNEL} * {scale}")
            worst = max(worst, err)
        print(f"check rank_update {label}: max abs err {worst:.3g}")
        return worst

    X, y, w = rank_inputs(M, N, P)
    errs["rank_update"] = check_rank(f"({M},{N},{P})", X, y, None)
    check_rank(f"({M},{N},{P}) weighted", X, y, w)
    Xr, yr, wr = rank_inputs(3, 500, 1000)
    check_rank("(3,500,1000)", Xr, yr, None)
    check_rank("(3,500,1000) weighted", Xr, yr, wr)

    def fista_inputs(Sigmas, r, lam):
        m, p, _ = Sigmas.shape
        etas = 1.0 / torch.clamp_min(power_iteration_batched(Sigmas), 1e-12)
        z = 0.05 * torch.randn((m, p, r), generator=g, device=dev)
        x = z + 0.01 * torch.randn((m, p, r), generator=g, device=dev)
        c = (torch.eye(p, device=dev).expand(m, p, p).contiguous() if r == p
             else 0.1 * torch.randn((m, p, r), generator=g, device=dev))
        lams = torch.full((m,), lam, device=dev)
        return Sigmas, z, x, c, etas, lams, np.float32(0.7)

    def check_fista(label, args):
        got = fista_step_batched(*args, use_kernel=True)
        ref = fista_step_batched(*args, use_kernel=False)
        torch.cuda.synchronize()
        worst = 0.0
        for name, a, b in zip(("x_next", "z_next"), got, ref):
            err, scale = max_err(a, b)
            check(err <= TOL_KERNEL * scale,
                  f"fista_step_batched {label} {name}: err {err} > "
                  f"{TOL_KERNEL} * {scale}")
            worst = max(worst, err)
        print(f"check fista_step_batched {label}: max abs err {worst:.3g}")
        return worst

    Sig, _ = rank_update(X, y, use_kernel=False)
    lam = 4.0 * float(np.sqrt(np.log(P) / N))
    mu = float(np.sqrt(np.log(P) / N))
    gemv_args = fista_inputs(Sig, 1, 0.5 * lam)
    gemm_args = fista_inputs(Sig, P, mu)
    errs["fista_step_gemv"] = check_fista(f"r=1 p={P}", gemv_args)
    errs["fista_step_gemm"] = check_fista(f"r=p={P}", gemm_args)
    Sig_r, _ = rank_update(Xr, yr, use_kernel=False)
    check_fista("r=1 p=1000", fista_inputs(Sig_r, 1, 0.5 * lam))
    check_fista("r=p=1000", fista_inputs(Sig_r, 1000, mu))

    def logistic_inputs(m, n, p):
        X = torch.randn((m, n, p), generator=g, device=dev)
        y = torch.where(torch.rand((m, n), generator=g, device=dev) < 0.5,
                        1.0, -1.0)
        B = torch.randn((m, p), generator=g, device=dev) / float(np.sqrt(p))
        return X, y, B

    def check_logistic(label, args):
        worst = []
        for name, fn in (("logistic_grad", logistic_grad),
                         ("logistic_grad_unfused", logistic_grad_unfused)):
            got = fn(*args, use_kernel=True)
            again = fn(*args, use_kernel=True)
            ref = fn(*args, use_kernel=False)
            torch.cuda.synchronize()
            err, scale = max_err(got, ref)
            check(err <= TOL_KERNEL * scale,
                  f"{name} {label}: err {err} > {TOL_KERNEL} * {scale}")
            check(bool(torch.equal(got, again)),
                  f"{name} {label}: two launches gave different bits")
            print(f"check {name} {label}: max abs err {err:.3g} "
                  f"(max|plain| {scale:.3g}), same bits on a second launch")
            worst.append(err)
        return worst

    lg_args = logistic_inputs(M, N, P)
    lg_large = logistic_inputs(*LARGE_P)
    (errs["logistic_grad"],
     errs["logistic_grad_unfused"]) = check_logistic(f"({M},{N},{P})",
                                                     lg_args)
    (errs["logistic_grad_p8192"],
     errs["logistic_grad_unfused_p8192"]) = check_logistic(
         "({},{},{})".format(*LARGE_P), lg_large)
    check_logistic("(3,500,1000)", logistic_inputs(3, 500, 1000))
    check_logistic("(2,7,129)", logistic_inputs(2, 7, 129))

    # ---- 4. the main path at full width -----------------------------------
    data = gen_regression(torch.Generator(device=dev).manual_seed(0),
                          m=M, n=N, p=P, s=S, signal_low=0.3, device=dev)
    Lam = 1.0
    fit_args = (data.Xs, data.ys, lam, mu, Lam)
    dsml_fit(*fit_args)                                  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = dsml_fit(*fit_args)
    torch.cuda.synchronize()
    fit_kernel_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    print(f"main path launches: {launches}")
    want = dict.fromkeys(LAUNCHES, 0)
    want.update(rank_update=1, fista_step_gemv=400, fista_step_gemm=600)
    check(launches == want,
          f"dsml_fit did not run through the kernels as expected: {launches}")

    t0 = time.perf_counter()
    ref = dsml_fit(*fit_args, use_kernel=False)
    torch.cuda.synchronize()
    fit_plain_s = time.perf_counter() - t0
    check(dict(LAUNCHES) == launches, "the plain path launched a kernel")

    for name, t in zip(res._fields, res):
        check(t.shape == getattr(ref, name).shape, f"{name} shape")
        if t.is_floating_point():
            check(bool(torch.isfinite(t).all()), f"{name} not finite")
    err, scale = max_err(res.beta_u, ref.beta_u)
    check(err <= TOL_FIT * scale,
          f"dsml_fit beta_u: err {err} > {TOL_FIT} * {scale}")
    check(bool(torch.equal(res.support, ref.support)), "supports differ")
    norms = torch.linalg.vector_norm(res.beta_u.T, dim=-1)
    margin = torch.min(torch.abs(norms - Lam)).item()
    ham = int(hamming(res.support, data.support))
    print(f"dsml_fit (m={M}, n={N}, p={P}, s={S}): beta_u max abs err vs "
          f"plain {err:.3g} (max|beta_u| {scale:.3g}); support size "
          f"{int(res.support.sum())}, identical; threshold margin "
          f"{margin:.4g}; hamming to the true support {ham}")
    print(f"dsml_fit wall: kernels {fit_kernel_s * 1e3:.1f} ms, plain "
          f"{fit_plain_s * 1e3:.1f} ms, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB {card}")

    # ---- 4b. the logistic path at full width ------------------------------
    cdata = gen_classification(torch.Generator(device=dev).manual_seed(0),
                               m=M, n=N, p=P, s=S, device=dev)
    lam_c = float(np.sqrt(np.log(P) / N))
    Lam_c = 0.75
    cfit_args = (cdata.Xs, cdata.ys, lam_c, 2.0 * lam_c, Lam_c)
    dsml_logistic_fit(*cfit_args)                        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    cres = dsml_logistic_fit(*cfit_args)
    torch.cuda.synchronize()
    cfit_kernel_s = time.perf_counter() - t0
    claunches = dict(LAUNCHES)
    print(f"logistic path launches: {claunches}")
    want = dict.fromkeys(LAUNCHES, 0)
    want.update(rank_update=2, logistic_grad=600, fista_step_gemm=600)
    check(claunches == want, "dsml_logistic_fit did not run through the "
          f"kernels as expected: {claunches}")

    t0 = time.perf_counter()
    cref = dsml_logistic_fit(*cfit_args, use_kernel=False)
    torch.cuda.synchronize()
    cfit_plain_s = time.perf_counter() - t0
    check(dict(LAUNCHES) == claunches, "the plain path launched a kernel")

    for name, t in zip(cres._fields, cres):
        check(t.shape == getattr(cref, name).shape, f"{name} shape")
        if t.is_floating_point():
            check(bool(torch.isfinite(t).all()), f"{name} not finite")
    for name in ("beta_u", "beta_local"):
        err, scale = max_err(getattr(cres, name), getattr(cref, name))
        check(err <= TOL_FIT * scale,
              f"dsml_logistic_fit {name}: err {err} > {TOL_FIT} * {scale}")
        print(f"dsml_logistic_fit {name}: max abs err vs plain {err:.3g} "
              f"(max|{name}| {scale:.3g})")
    check(bool(torch.equal(cres.support, cref.support)),
          "logistic supports differ")
    norms = torch.linalg.vector_norm(cres.beta_u.T, dim=-1)
    margin = torch.min(torch.abs(norms - Lam_c)).item()
    ham = int(hamming(cres.support, cdata.support))
    print(f"dsml_logistic_fit (m={M}, n={N}, p={P}, s={S}, lam={lam_c:.4g}, "
          f"Lam={Lam_c}): support size {int(cres.support.sum())}, "
          f"identical; threshold margin {margin:.4g}; hamming to the true "
          f"support {ham}")
    print(f"dsml_logistic_fit wall: kernels {cfit_kernel_s * 1e3:.1f} ms, "
          f"plain {cfit_plain_s * 1e3:.1f} ms, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB {card}")

    # ---- 5. times ---------------------------------------------------------
    m, n, p = M, N, P
    # Sigma is symmetric by construction: its least work is the upper
    # triangle (p (p + 1) / 2 dot products of length n per task) plus c;
    # the output bytes are the whole of Sigma
    rank_bound = bound(m * n * p * (p + 1) + 2 * m * n * p,
                       4 * (m * n * p + m * n + m * p * p + m * p))
    gemv_bound = bound(2 * m * p * p,
                       4 * (m * p * p + 3 * m * p + 2 * m + 2 * m * p))
    gemm_bound = bound(2 * m * p * p * p,
                       4 * (m * p * p + 3 * m * p * p + 2 * m + 2 * m * p * p))
    Xt = X.transpose(1, 2)
    S_out, c_out = torch.empty_like(Sig), torch.empty((m, p), device=dev)
    gemv_out = (torch.empty_like(gemv_args[1]), torch.empty_like(gemv_args[1]))
    gemm_out = (torch.empty_like(gemm_args[1]), torch.empty_like(gemm_args[1]))
    rows = [
        ("rank_update", "src/repro_torch/kernels/csrc/rank_update.cu",
         "src/repro/kernels/rank_update/kernel.py:121", rank_bound,
         lambda: rank_ops.launch(X, y, None, S_out, c_out),
         lambda: rank_update(X, y),
         lambda: rank_update_ref(X, y),
         lambda: torch.bmm(Xt, X)),
        ("fista_step_gemv", "src/repro_torch/kernels/csrc/fista_step.cu",
         "src/repro/kernels/ista_step/kernel.py:108", gemv_bound,
         lambda: ista_ops.launch(*gemv_args, *gemv_out),
         lambda: fista_step_batched(*gemv_args),
         lambda: fista_step_batched_ref(*gemv_args),
         lambda: torch.bmm(Sig, gemv_args[1])),
        ("fista_step_gemm", "src/repro_torch/kernels/csrc/fista_step.cu",
         "src/repro/kernels/ista_step/kernel.py:108", gemm_bound,
         lambda: ista_ops.launch(*gemm_args, *gemm_out),
         lambda: fista_step_batched(*gemm_args),
         lambda: fista_step_batched_ref(*gemm_args),
         lambda: torch.bmm(Sig, gemm_args[1])),
    ]
    for suffix, (Xl, yl, Bl) in (("", lg_args), ("_p8192", lg_large)):
        lm, ln, lp = Xl.shape
        pl = logistic_ops.plan(lm, ln, lp,
                               *logistic_ops._device_limits(Xl.device))
        G = torch.empty((lm, lp), device=dev)
        work = torch.empty((lm, pl.chunks, lp), device=dev)
        counters = torch.zeros(lm, dtype=torch.int32, device=dev)
        zbuf = torch.empty((lm, ln), device=dev)
        rl = yl * torch.sigmoid(-yl * torch.bmm(Xl, Bl[..., None])[..., 0])
        Xlt = Xl.transpose(1, 2)
        # no PyTorch call computes this function: the library row is
        # its two products, X b and X' r, timed together
        lib = (lambda Xl=Xl, Bl=Bl, Xlt=Xlt, rl=rl:
               (torch.bmm(Xl, Bl[..., None]), torch.bmm(Xlt, rl[..., None])))
        rows += [
            ("logistic_grad" + suffix,
             "src/repro_torch/kernels/csrc/logistic_grad.cu",
             "src/repro/kernels/logistic_grad/kernel.py:149",
             bound(4 * lm * ln * lp,
                   4 * (lm * ln * lp + lm * ln + 2 * lm * lp)),
             lambda a=(Xl, yl, Bl, G, work, counters, pl):
                 logistic_ops.launch(*a),
             lambda a=(Xl, yl, Bl): logistic_grad(*a),
             lambda a=(Xl, yl, Bl): logistic_grad_ref(*a),
             lib),
            # its own two-dispatch contract: X read twice, z and r through
            # device memory
            ("logistic_grad_unfused" + suffix,
             "src/repro_torch/kernels/csrc/logistic_grad.cu",
             "src/repro/kernels/logistic_grad/kernel.py:198",
             bound(4 * lm * ln * lp,
                   4 * (2 * lm * ln * lp + 2 * lm * lp + 5 * lm * ln)),
             lambda a=(Xl, yl, Bl, zbuf, G): logistic_ops.launch_unfused(*a),
             lambda a=(Xl, yl, Bl): logistic_grad_unfused(*a),
             lambda a=(Xl, yl, Bl): logistic_grad_unfused(*a,
                                                          use_kernel=False),
             lib),
        ]
    # launches per fit: the regression rows from phase 4, the logistic
    # rows from phase 4b (the unfused pair is not on either path)
    fit_launches = {**launches,
                    "logistic_grad": claunches["logistic_grad"],
                    "logistic_grad_p8192": claunches["logistic_grad"],
                    "logistic_grad_unfused": claunches["logistic_z"],
                    "logistic_grad_unfused_p8192": claunches["logistic_z"]}
    shapes = {"rank_update": (m, n, p), "fista_step_gemv": (m, p, 1),
              "fista_step_gemm": (m, p, p),
              "logistic_grad": (M, N, P), "logistic_grad_unfused": (M, N, P),
              "logistic_grad_p8192": LARGE_P,
              "logistic_grad_unfused_p8192": LARGE_P}
    kernels = []
    for (name, source, replaces, (bound_ms, bound_by), kern, wrapper, plain,
         lib) in rows:
        ms, wrap_ms = time_ms(kern), time_ms(wrapper)
        plain_ms, lib_ms = time_ms(plain), time_ms(lib)
        cold_ms = time_ms_cold(kern)
        print(f"time {name}: kernel {ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), plain {plain_ms:.4f} ms, library {lib_ms:.4f} "
              f"ms, wrapper {wrap_ms:.4f} ms, kernel with L2 flushed "
              f"{cold_ms:.4f} ms {card}")
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "shape": list(shapes[name]),
                        "launches": fit_launches[name],
                        "max_abs_err": errs[name], "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": lib_ms,
                        "cold_ms": cold_ms, "wrapper_ms": wrap_ms})

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
