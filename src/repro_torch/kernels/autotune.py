"""Launch-plan autotuning for the port's DSML kernels (the counterpart of
the JAX package's `kernels/autotune.py`).

Three kernels choose their launch plan by a rule on the card's SM count,
and every plan of their tables is legal at every shape:

  * `fista_step` — the fused FISTA step (`kernels/ista_step`), swept over
    GEMV_PLANS, (rows_per_warp, warps), for r = 1 and over GEMM_TILES,
    (bm, bn), for r > 1, for a (m, p, r) solve;
  * `logistic_grad` — the fused logistic gradient, swept over the
    cluster sizes a row of p floats allows (`ops.cluster_max`) for a
    (m, n, p) batch;
  * `rank_update` — the fused rank-n update, swept over RANK_TILES for a
    (m, n, p) chunk (unweighted, the ingest's case).

Each `autotune_*` entry point times the candidates for a problem key once
on the card (`_time_candidate`: a warm-up launch, then the best of `reps`
means of TIMED_LAUNCHES launches issued back to back between CUDA
events), then serves the winner from an
in-process cache backed by a JSON file of the port's own:
`$REPRO_TORCH_CACHE_DIR/repro_torch_autotune.json`, by default under
`<repo>/.cache/` (never `.cache/autotune.json`, whose namespaces belong
to the JAX package). Delete the file, or point `REPRO_TORCH_CACHE_DIR`
elsewhere, to time again. Keys are `"<kernel>/<backend>_<dims>_<dtype>"`,
`<backend>` a slug of the card's name and SM count. A sweep's launches
are not the path's: `LAUNCHES` is restored after it.

The engine (`core/engine.py`) takes these winners as its default plans on
CUDA tensors (`block=None`); an explicit `block=` always wins and never
touches the cache, and the CPU never sweeps. With `torch.distributed`
initialized over more than one rank, and during CUDA graph capture or
while the compiler traces (`compiler.is_compiling()`), the entry
points return the rule's plan (None) untimed: ranks then launch the same
plan, and nothing is timed under a capture or a trace.
"""
from __future__ import annotations

import json
import os
import re
from contextlib import nullcontext
from pathlib import Path
from typing import Callable

import torch
from torch import compiler

from repro_torch import obs
from repro_torch.kernels.common import LAUNCHES
from repro_torch.kernels.ista_step import ops as ista_ops
from repro_torch.kernels.logistic_grad import ops as logistic_ops
from repro_torch.kernels.rank_update import ops as rank_ops

_REPO_ROOT = Path(__file__).resolve().parents[3]
CACHE_FILE = "repro_torch_autotune.json"

# launches a timing spans: one launch between two events times the host's
# issue with the kernel (tens of microseconds at random), which picked a
# tile 1.8 % slower at the debias solve's shape on an H100
TIMED_LAUNCHES = 10

_memory_cache: dict[str, object] = {}


def cache_path() -> Path:
    return Path(os.environ.get("REPRO_TORCH_CACHE_DIR",
                               _REPO_ROOT / ".cache")) / CACHE_FILE


def backend_slug(device: torch.device) -> str:
    """The key's backend: the card's name without "nvidia", letters and
    digits only, and its SM count (`h10080gbhbm3sm132`); "cpu" off
    CUDA."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    props = torch.cuda.get_device_properties(device)
    name = re.sub(r"[^a-z0-9]", "", props.name.lower().replace("nvidia", ""))
    return f"{name}sm{props.multi_processor_count}"


def cache_key(kernel: str, backend: str, dims: dict[str, int],
              dtype) -> str:
    """Per-kernel key "<kernel>/<backend>_m4_p128_r1_float32": kernels
    whose dimensions coincide never share an entry."""
    dim_s = "_".join(f"{k}{v}" for k, v in dims.items())
    return f"{kernel}/{backend}_{dim_s}_{str(dtype).replace('torch.', '')}"


def clear_memory_cache() -> None:
    _memory_cache.clear()


def _load_disk() -> dict:
    try:
        with open(cache_path()) as f:
            entries = json.load(f)
    except (OSError, ValueError):
        return {}
    return entries if isinstance(entries, dict) else {}


def _save_disk(entries: dict) -> None:
    path = cache_path()
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_text(json.dumps(entries, indent=2, sort_keys=True))
        os.replace(tmp, path)
    except OSError:
        pass  # read-only checkout: the in-process cache still serves


def block_candidates(m: int, p: int, r: int) -> list:
    """The FISTA step's plans for a (m, p, r) solve: GEMV_PLANS where
    r == 1, GEMM_TILES where r > 1 (every entry launches at any shape)."""
    return list(ista_ops.GEMV_PLANS if r == 1 else ista_ops.GEMM_TILES)


def logistic_candidates(m: int, n: int, p: int) -> list:
    """The fused logistic gradient's cluster sizes for a (m, n, p) batch:
    1, 2, 4, 8 up to `cluster_max(p)`."""
    return [c for c in (1, 2, 4, 8) if c <= logistic_ops.cluster_max(p)]


def rank_candidates(m: int, n: int, p: int) -> list:
    """The rank-n update's tiles for a (m, n, p) chunk: RANK_TILES."""
    return list(rank_ops.RANK_TILES)


def _time_candidate(fn: Callable[[], None], reps: int) -> float:
    """The time of one `fn()` on the current CUDA stream in microseconds:
    after one warm-up call, the best of `reps` means of TIMED_LAUNCHES
    calls issued back to back between CUDA events. Module level, so that
    tests can count and fake the sweep's timings."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(TIMED_LAUNCHES):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / TIMED_LAUNCHES)
    return best * 1e3


def _multi_rank() -> bool:
    dist = torch.distributed
    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def _capturing() -> bool:
    """Whether the compiler is tracing or a CUDA graph is being captured
    on the current stream."""
    if compiler.is_compiling():
        return True
    return torch.cuda.is_available() \
        and torch.cuda.is_current_stream_capturing()


def _as_block(value):
    """A cache file's entry as a block: a list becomes a tuple."""
    return tuple(value) if isinstance(value, list) else value


def _autotune(kernel: str, dims: dict[str, int], candidates: list,
              make_sweep: Callable, *, device: torch.device, dtype,
              reps: int):
    """The cache-then-sweep policy behind every `autotune_*` entry point.
    Returns the rule's plan, None, across ranks (a timing is not the same
    on every rank, and ranks must launch alike) and under capture or
    compilation (nothing is timed or cached there); else the cached
    winner, or the winner of a sweep, which both caches then keep.
    `make_sweep()` builds the sweep's inputs on `device` and returns a
    `candidate -> thunk` factory; it runs only on a miss. A disk entry
    that is not among `candidates` counts as a miss."""
    if _multi_rank():
        obs.inc("autotune.cache", kernel=kernel, event="default_multiprocess")
        return None
    if _capturing():
        obs.inc("autotune.cache", kernel=kernel, event="deferred_capture")
        return None
    device = torch.device(device)
    key = cache_key(kernel, backend_slug(device), dims, dtype)
    if key in _memory_cache:
        obs.inc("autotune.cache", kernel=kernel, event="hit_memory")
        return _memory_cache[key]
    disk = _load_disk()
    if key in disk and _as_block(disk[key]) in candidates:
        block = _memory_cache[key] = _as_block(disk[key])
        obs.inc("autotune.cache", kernel=kernel, event="hit_disk")
        return block

    obs.inc("autotune.cache", kernel=kernel, event="miss_sweep")
    saved = dict(LAUNCHES)
    best_us, best = float("inf"), None
    on_device = torch.cuda.device(device) if device.type == "cuda" \
        else nullcontext()
    try:
        with on_device, obs.span("autotune.sweep", kernel=kernel):
            fn_for = make_sweep()
            for cand in candidates:
                us = _time_candidate(fn_for(cand), reps)
                obs.observe("autotune.candidate_us", us, kernel=kernel,
                            candidate="x".join(str(b) for b in cand)
                            if isinstance(cand, tuple) else str(cand))
                if us < best_us:
                    best_us, best = us, cand
    finally:
        LAUNCHES.update(saved)
    _memory_cache[key] = best
    disk[key] = list(best) if isinstance(best, tuple) else best
    _save_disk(disk)
    return best


def warmup_cache(m: int, p: int, n: int | None = None, *, device,
                 dtype=torch.float32, reps: int = 2) -> None:
    """Time the plans of the shapes a DSML workload of m tasks in p
    dimensions runs (the r = 1 lasso and the r = p debias solve, and,
    where the chunk's rows `n` are known, the rank-n ingest and the
    logistic gradient), so that later engine calls find them cached.
    `StreamingDsmlService` calls it when it starts. Does nothing off
    CUDA, where the engine runs the plain versions."""
    if torch.device(device).type != "cuda":
        return
    kw = dict(device=device, dtype=dtype, reps=reps)
    autotune_block(m, p, 1, **kw)
    autotune_block(m, p, p, **kw)
    if n is not None:
        autotune_logistic_block(m, n, p, **kw)
        autotune_rank_block(m, n, p, **kw)


def _generator(device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(0)


def autotune_block(m: int, p: int, r: int, *, device, dtype=torch.float32,
                   reps: int = 2):
    """The fastest plan of the FISTA step (momentum on, as the engine's
    loops run it) for a (m, p, r) solve, a `block=` of
    `ista_step.ops.fista_step_batched` (kernel namespace `fista_step`)."""
    def make_sweep():
        g = _generator(device)
        Sigmas = torch.randn((m, p, p), generator=g, device=device,
                             dtype=dtype)
        zs, xs, cs = (torch.randn((m, p, r), generator=g, device=device,
                                  dtype=dtype) for _ in range(3))
        etas = torch.full((m,), 0.01, device=device, dtype=dtype)
        lams = torch.full((m,), 0.1, device=device, dtype=dtype)
        xn, zn = torch.empty_like(zs), torch.empty_like(zs)

        def fn_for(cand):
            plan = ista_ops.check_block("autotune_block", r, cand)
            return lambda: ista_ops.launch(Sigmas, zs, xs, cs, etas, lams,
                                           0.5, xn, zn, plan)
        return fn_for

    return _autotune(
        "fista_step", {"m": m, "p": p, "r": r},
        block_candidates(m, p, r), make_sweep, device=device, dtype=dtype,
        reps=reps)


def autotune_logistic_block(m: int, n: int, p: int, *, device,
                            dtype=torch.float32, reps: int = 2):
    """The fastest cluster size of the fused logistic gradient for a
    (m, n, p) batch, a `block=` of `logistic_grad.ops.logistic_grad`
    (kernel namespace `logistic_grad`)."""
    def make_sweep():
        g = _generator(device)
        Xs = torch.randn((m, n, p), generator=g, device=device, dtype=dtype)
        ys = torch.sign(torch.randn((m, n), generator=g, device=device,
                                    dtype=dtype))
        B = 0.01 * torch.randn((m, p), generator=g, device=device,
                               dtype=dtype)
        G = torch.empty((m, p), device=device, dtype=dtype)
        # room for any plan: a plan has at most n chunks and 8 blocks a
        # cluster, and the kernel leaves its counters at zero
        work = torch.empty((m, n, p), device=device, dtype=dtype)
        counters = torch.zeros(m * logistic_ops.CLUSTER_MAX,
                               dtype=torch.int32, device=device)

        def fn_for(cand):
            cluster = logistic_ops.check_cluster("autotune_logistic_block",
                                                 p, cand)
            return lambda: logistic_ops.launch(Xs, ys, B, G, work, counters,
                                               cluster)
        return fn_for

    return _autotune(
        "logistic_grad", {"m": m, "n": n, "p": p},
        logistic_candidates(m, n, p), make_sweep, device=device, dtype=dtype,
        reps=reps)


def autotune_rank_block(m: int, n: int, p: int, *, device,
                        dtype=torch.float32, reps: int = 2):
    """The fastest tile of the fused rank-n update for a (m, n, p) chunk,
    unweighted, a `block=` of `rank_update.ops.rank_update` (kernel
    namespace `rank_update`)."""
    def make_sweep():
        g = _generator(device)
        Xs = torch.randn((m, n, p), generator=g, device=device, dtype=dtype)
        ys = torch.randn((m, n), generator=g, device=device, dtype=dtype)
        Sigmas = torch.empty((m, p, p), device=device, dtype=dtype)
        cs = torch.empty((m, p), device=device, dtype=dtype)

        def fn_for(cand):
            plan = rank_ops.check_block("autotune_rank_block", cand)
            return lambda: rank_ops.launch(Xs, ys, None, Sigmas, cs, plan)
        return fn_for

    return _autotune(
        "rank_update", {"m": m, "n": n, "p": p},
        rank_candidates(m, n, p), make_sweep, device=device, dtype=dtype,
        reps=reps)
