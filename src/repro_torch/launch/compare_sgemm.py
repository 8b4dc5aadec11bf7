"""Hold a DSML kernel library against an earlier build of it, on the card:
the same bits (or the fits' tolerance) on the DSML paths, and both times in
one run.

    PYTHONPATH=src python -m repro_torch.launch.compare_sgemm \
        [--library fista_step|rank_update] --source OLD/<library>.cu \
        [--build-dir DIR]

`--source` is an earlier `kernels/csrc/<library>.cu` with the same C
entries (for example the file from a parent commit). It is built with
the flags of `kernels/_build.py` into `--build-dir` (a new temporary
directory by default) and put in place of the current library, for the
runs that need it only. Both modes run at the configuration of
`chip_smoke.py` phases 4, 4b and 4c (m = 16, n = 512, p = 1024, s = 16,
seed 0), with the current kernel and with the earlier one, time both
kernels alone in turns (earlier, current, current, earlier; CUDA events,
mean of 20 launches) beside the PyTorch call that computes the same
product, and print the card's name and power limit. They exit non-zero
if a check fails, and without a CUDA device.

* `fista_step` (the default), the r > 1 FISTA/ISTA SGEMM: `dsml_fit`
  (600 r = p launches), `dsml_logistic_fit` (600 more), and phase 4c's
  `ista_step` (m = 1) and `ista_step_batched` at r = p on the fit's
  statistics must give the same bits; times at (16, 1024, 1024) with
  momentum and (1, 1024, 1024) without, beside `bmm` / `mm`.
* `rank_update`, the rank-n update: `dsml_fit` (one launch) must give
  the same bits, and so must `rank_update` and the unfused pair's
  Sigma and c, unweighted, on the fit's X and y; `dsml_logistic_fit`
  (two weighted launches) beta_u and beta_local within 1e-4 * max|.|
  with the same support (the weighted kernels may differ in the last
  bits of Sigma's lower triangle). Times of the fused kernel at the
  fits' (16, 512, 1024), unweighted and weighted, and at the streaming
  ingest's (8, 1024, 256), beside `bmm(X', X)`.
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
from repro_torch.core.engine import (
    power_iteration_batched, scaled_identity_m0,
)
from repro_torch.kernels import _build
from repro_torch.kernels.ista_step import ops as ista_ops
from repro_torch.kernels.ista_step.ops import ista_step, ista_step_batched
from repro_torch.kernels.rank_update import ops as rank_ops
from repro_torch.kernels.rank_update.ops import (
    rank_update, rank_update_unfused,
)

M, N, P, S = 16, 512, 1024, 16            # chip_smoke.py phases 4-4c
INGEST = (8, 1024, 256)                   # benchmarks/stream_bench.py
TOL_FIT = 1e-4                            # x max|.|, as chip_smoke.py


def _time_ms(fn, reps: int = 20, warm: int = 3) -> float:
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


def _turns(library: str, earlier: ctypes.CDLL, kernel) -> dict:
    """`kernel` timed with the earlier library and the current one in
    turns: earlier, current, current, earlier."""
    row = {"earlier": [], "current": []}
    for lib in (earlier, None, None, earlier):
        if lib is None:
            row["current"].append(_time_ms(kernel))
        else:
            with _library(library, lib):
                row["earlier"].append(_time_ms(kernel))
    return row


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
    mu = fit_args[3]
    Sig0, c0 = rank_update(data.Xs, data.ys, use_kernel=False)
    etas0 = 1.0 / torch.clamp_min(power_iteration_batched(Sig0), 1e-12)
    M0 = scaled_identity_m0(Sig0)
    eye = torch.eye(P, device=dev)
    eyes = eye.expand(M, P, P).contiguous()

    def paths():
        return {
            "phase 4 dsml_fit": dsml_fit(*fit_args),
            "phase 4b dsml_logistic_fit": dsml_logistic_fit(*cfit_args),
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
    calls = {
        "fista_step_gemm (16, 1024, 1024)": (
            lambda: ista_ops.launch(Sig0, z, x, eyes, etas0, lams,
                                    np.float32(0.7), xn, zn),
            lambda: torch.bmm(Sig0, z)),
        "ista_step_gemm (1, 1024, 1024)": (
            lambda: ista_ops.launch_ista(*one, out1, "ista_step"),
            lambda: torch.mm(one[0][0], one[1][0])),
    }
    for name, (kernel, library) in calls.items():
        times[name] = {**_turns("fista_step", earlier, kernel),
                       "library": [_time_ms(library)]}
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
                "library": [_time_ms(lambda X=X, Xt=Xt: torch.bmm(Xt, X))]}
    return same


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--library", choices=("fista_step", "rank_update"),
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
    compare = _compare_sgemm if args.library == "fista_step" \
        else _compare_rank
    same = compare(earlier, dev, times)
    for name, row in times.items():
        print(f"time {name}: earlier {row['earlier']} ms, current "
              f"{row['current']} ms, library {row['library']} ms [{smi}]")
    print(json.dumps({"library": args.library, "same_bits": all(same),
                      "times_ms": times, "card": smi}))
    if not all(same):
        raise SystemExit("compare_sgemm: an output differs")


if __name__ == "__main__":
    main()
