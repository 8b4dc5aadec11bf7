"""Hold the r > 1 FISTA/ISTA kernel against an earlier build of it, on the
card: the same bits on the DSML paths, and both times in one run.

    PYTHONPATH=src python -m repro_torch.launch.compare_sgemm \
        --source OLD/fista_step.cu [--build-dir DIR]

`--source` is an earlier `kernels/csrc/fista_step.cu` with the same C
entries (for example the file from a parent commit). It is built with
the flags of `kernels/_build.py` into `--build-dir` (a new temporary
directory by default) and put in place of the current library, for the
runs that need it only. At the configuration of `chip_smoke.py` phases
4, 4b and 4c (m = 16, n = 512, p = 1024, s = 16, seed 0) it runs, with
the current kernel and with the earlier one: `dsml_fit` (600 r = p
launches), `dsml_logistic_fit` (600 more), and phase 4c's `ista_step`
(m = 1) and `ista_step_batched` at r = p on the fit's statistics; every
output must be the same bits. Then it times both kernels alone at
(16, 1024, 1024) with momentum and (1, 1024, 1024) without, in turns
(earlier, current, current, earlier; CUDA events, mean of 20 launches),
beside `bmm` / `mm`, and prints the card's name and power limit. It
exits non-zero if any output differs, and without a CUDA device.
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
from repro_torch.kernels.rank_update.ops import rank_update

M, N, P, S = 16, 512, 1024, 16            # chip_smoke.py phases 4-4c


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


def _build_earlier(source: Path, build_dir: Path) -> ctypes.CDLL:
    build_dir.mkdir(parents=True, exist_ok=True)
    out = build_dir / "libfista_step_earlier.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                    str(source)], check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(out))


@contextmanager
def _library(lib: ctypes.CDLL):
    """`lib` in place of the current `fista_step` library."""
    current = _build._LIBS["fista_step"]
    _build._LIBS["fista_step"] = lib
    _build._FNS.clear()
    try:
        yield
    finally:
        _build._LIBS["fista_step"] = current
        _build._FNS.clear()


def _same(label: str, new, old) -> bool:
    news = new if isinstance(new, tuple) else (new,)
    olds = old if isinstance(old, tuple) else (old,)
    same = all(torch.equal(a, b) for a, b in zip(news, olds))
    print(f"{label}: {'the same bits' if same else 'DIFFERENT BITS'}")
    return same


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
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
    earlier = _build_earlier(args.source.resolve(), build_dir)

    data = gen_regression(torch.Generator(device=dev).manual_seed(0),
                          m=M, n=N, p=P, s=S, signal_low=0.3, device=dev)
    lam = 4.0 * float(np.sqrt(np.log(P) / N))
    mu = float(np.sqrt(np.log(P) / N))
    cdata = gen_classification(torch.Generator(device=dev).manual_seed(0),
                               m=M, n=N, p=P, s=S, device=dev)
    lam_c = float(np.sqrt(np.log(P) / N))
    Sig0, c0 = rank_update(data.Xs, data.ys, use_kernel=False)
    etas0 = 1.0 / torch.clamp_min(power_iteration_batched(Sig0), 1e-12)
    M0 = scaled_identity_m0(Sig0)
    eye = torch.eye(P, device=dev)
    eyes = eye.expand(M, P, P).contiguous()

    def paths():
        return {
            "phase 4 dsml_fit": dsml_fit(data.Xs, data.ys, lam, mu, 1.0),
            "phase 4b dsml_logistic_fit": dsml_logistic_fit(
                cdata.Xs, cdata.ys, lam_c, 2.0 * lam_c, 0.75),
            "phase 4c ista_step r=p": ista_step(Sig0[0], M0[0], eye,
                                                etas0[0], mu),
            "phase 4c ista_step_batched r=p": ista_step_batched(
                Sig0, M0, eyes, etas0, mu),
        }

    new = paths()
    with _library(earlier):
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
    times = {}
    for name, (kernel, library) in calls.items():
        row = {"earlier": [], "current": []}
        for lib in (earlier, None, None, earlier):
            if lib is None:
                row["current"].append(_time_ms(kernel))
            else:
                with _library(lib):
                    row["earlier"].append(_time_ms(kernel))
        row["library"] = [_time_ms(library)]
        times[name] = row
        print(f"time {name}: earlier {row['earlier']} ms, current "
              f"{row['current']} ms, library {row['library']} ms [{smi}]")
    print(json.dumps({"same_bits": all(same), "times_ms": times,
                      "card": smi}))
    if not all(same):
        raise SystemExit("compare_sgemm: an output differs")


if __name__ == "__main__":
    main()
