"""Build the CUDA sources of `kernels/csrc/` at first use and bind them.

Each `csrc/*.cu` is compiled by its own `nvcc` into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds, not
minutes). All compilers start together, so the build takes as long as
its slowest source however many sources the port gains. The libraries
go to `build/repro_torch/` at the root of the checkout, once per tree:
a process skips a source whose `lib<stem>.so` is newer than the source
and was built with the same `NVCC_FLAGS` (recorded beside it in
`lib<stem>.flags`), so the ranks of a distributed run load what their
parent built. Every library is loaded with `ctypes`.

Every C entry point takes its pointers and the stream as `void *`,
launches on that stream and returns `cudaGetLastError()`; `call`
raises when that is not 0, since a refused launch never runs and a
later synchronize does not report it.
"""
from __future__ import annotations

import ctypes
import json
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
# what this process's build printed per source it compiled (`-Xptxas -v`:
# registers, shared memory, spills) and how long it took, for
# chip_smoke.py; a source that was up to date has no entry
BUILD_LOG: dict[str, str] = {}
BUILD_SECONDS: dict[str, float] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return found


def _flags_text(flags=NVCC_FLAGS) -> str:
    return json.dumps(list(flags))


def up_to_date(src: Path, build_dir: Path = BUILD_DIR,
               flags=NVCC_FLAGS) -> bool:
    """Whether `build_dir/lib<stem>.so` may be loaded for `src` as it
    is: the library is newer than the source and its recorded flags are
    `flags`."""
    out = build_dir / f"lib{src.stem}.so"
    record = out.with_suffix(".flags")
    try:
        fresh = out.stat().st_mtime_ns > src.stat().st_mtime_ns
        return fresh and record.read_text() == _flags_text(flags)
    except FileNotFoundError:
        return False


def build() -> dict[str, ctypes.CDLL]:
    """Compile every source that is not up to date, in parallel, then
    load all libraries. Returns {source stem: library}."""
    if _LIBS:
        return _LIBS
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC.glob("*.cu"))
    stale = [src for src in sources if not up_to_date(src)]
    t0 = time.perf_counter()
    jobs = {}
    if stale:
        nvcc = _nvcc()
    for src in stale:
        out = BUILD_DIR / f"lib{src.stem}.so"
        # written aside and renamed, so that a process building at the
        # same time never loads a half-written library or record
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
            continue
        record = out.with_suffix(f".{os.getpid()}.flags")
        record.write_text(_flags_text())
        os.replace(tmp, out)
        os.replace(record, out.with_suffix(".flags"))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    for src in sources:
        _LIBS[src.stem] = ctypes.CDLL(str(BUILD_DIR / f"lib{src.stem}.so"))
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
