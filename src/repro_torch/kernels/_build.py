"""Build the CUDA sources of `kernels/csrc/` at first use and bind them.

Each `csrc/*.cu` is compiled by its own `nvcc` into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds, not
minutes). All compilers start together, so the build takes as long as
its slowest source however many sources the port gains. Every process
builds anew at its first launch, into `build/repro_torch/` at the root
of the checkout, and loads the libraries with `ctypes`.

Every C entry point takes its pointers and the stream as `void *`,
launches on that stream and returns `cudaGetLastError()`; `call`
raises when that is not 0, since a refused launch never runs and a
later synchronize does not report it.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_FNS: dict[str, ctypes._CFuncPtr] = {}
# what the last build printed per source (`-Xptxas -v`: registers,
# shared memory, spills) and how long it took, for chip_smoke.py
BUILD_LOG: dict[str, str] = {}
BUILD_SECONDS: dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def build() -> dict[str, ctypes.CDLL]:
    """Compile every source in parallel, then load all libraries.
    Returns {source stem: library}."""
    if _LIBS:
        return _LIBS
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = {}
    for src in sorted(CSRC.glob("*.cu")):
        out = BUILD_DIR / f"lib{src.stem}.so"
        # written aside and renamed, so that a process building at the
        # same time never loads a half-written library
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        jobs[src.stem] = (out, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for stem, (out, tmp, proc) in jobs.items():
        log, _ = proc.communicate()
        BUILD_LOG[stem] = log
        BUILD_SECONDS[stem] = time.perf_counter() - t0
        if proc.returncode:
            failed.append(f"{stem}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    for stem, (out, _, _) in jobs.items():
        _LIBS[stem] = ctypes.CDLL(str(out))
    return _LIBS


def function(source: str, name: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry `name` of `csrc/<source>.cu`, with its argument types
    declared (`c_void_p` for every pointer and the stream: an undeclared
    pointer is cut to 32 bits)."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(build()[source], name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def call(fn: ctypes._CFuncPtr, *args) -> None:
    """Launch through `fn` and raise on the launch's CUDA error."""
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA error {err} at launch")


def stream(device: torch.device) -> int:
    """PyTorch's current stream on `device` (the capture stream while a
    CUDA graph is captured), as the handle the C entries take. Read
    straight from PyTorch's C layer, with no Python `Stream` object, since
    each launch asks for it."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)
