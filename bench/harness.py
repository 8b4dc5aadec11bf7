"""What every cell's run shares: the spec, the environment, the closed
loop, the checks that decide `correct`, the per-layer readers and the
result line."""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
CACHE = BENCH / ".cache"
# top-level module names that may not be loaded in a run: JAX and the
# JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def prepare_env() -> None:
    """Fixed cache directories inside the checkout, and the port's source
    on the path. Runs before torch or the port is imported."""
    os.environ["REPRO_TORCH_CACHE_DIR"] = str(CACHE / "autotune")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    # one CPU thread for torch's and numpy's host work: the cells' host
    # work is small, and idle pool threads that spin take cores from the
    # stream cell's three threads on a host shared with other machines
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def load_spec(root: Path = ROOT, pending: bool = False) -> dict:
    """`BENCHMARK.json`; with `pending`, also the cells of
    `bench/pending.json`, which the benchmark's runs never run."""
    with open(root / "BENCHMARK.json") as f:
        spec = json.load(f)
    if pending:
        add_pending(spec, _json(BENCH / "pending.json"))
    return spec


def add_pending(spec: dict, extra: dict) -> None:
    """Merge the pending cells, their configurations and metrics into
    `spec`, and name them in the existing metrics they also report."""
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        spec[key] = spec[key] + extra[key]
    for name, metrics in extra["also_reports"].items():
        for m in spec["end_to_end"] + spec["per_layer"]:
            if m["name"] in metrics and "workloads" in m:
                m["workloads"] = m["workloads"] + [name]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict             # the configuration file's contents
    traffic: dict            # the traffic file's contents
    limits: dict             # number compared -> its limit
    end_to_end: list         # the spec's entries this cell reports
    per_layer: list


def reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(spec: dict, workload: str, root: Path = ROOT) -> Cell:
    """The cell named `workload` with its files, found by name."""
    entry = next((w for w in spec["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    e2e = [m for m in spec["end_to_end"] if reports(m, workload)]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if workload in m.get("workloads", ())
             or ("workloads" not in m and m["moves"] in names)]
    return Cell(workload, entry["chips"], _json(root / conf["file"]),
                _json(root / "bench" / "traffic" / f"{entry['traffic']}.json"),
                _json(root / "bench" / "checks" / f"{workload}.json"),
                e2e, layer)


def driver(c: Cell):
    """The module of `bench/drivers/` that the cell's traffic names: its
    `run(ctx)`, `control(ctx, checks, chunks)` and, for a many-card cell,
    `rank_run(ctx, rank, world, init)`."""
    return importlib.import_module(f"bench.drivers.{c.traffic['driver']}")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name, whole, is JAX's or the JAX
    package's (`repro_torch` is not `repro`)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def require_cards(count: int) -> None:
    """The measurement runs on CUDA cards only: it never falls back."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the benchmark measures the card "
                         "and does not fall back to the CPU")
    if torch.cuda.device_count() < count:
        raise SystemExit(f"the cell needs {count} CUDA devices, "
                         f"{torch.cuda.device_count()} found")


class Sample:
    """A sample of at most `size` answers of the window's calls, drawn
    from the seed as the calls come (reservoir sampling): a fixed number
    of answers is held at any time, whatever the count of calls, so the
    check holds no more of the allocator's blocks in a run of many calls
    than in one of few."""

    def __init__(self, seed: int, size: int = 16):
        self.rng = np.random.default_rng(int(seed))
        self.size = size
        self.items: list = []
        self.seen = 0

    def offer(self, item) -> None:
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.items[j] = item
        self.seen += 1


def card_ready() -> None:
    """Make the CUDA context, so set-up's parts can be told apart."""
    import torch
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()


def closed_loop(call, seconds: float) -> tuple[int, float, float]:
    """Run `call()` (which returns when its result is ready) back to back
    until `seconds` have passed; the window closes at the end of the last
    call that started before then. Returns (calls, start, end)."""
    t0 = time.perf_counter()
    calls, t = 0, t0
    while t - t0 < seconds:
        call()
        calls += 1
        t = time.perf_counter()
    return calls, t0, t


@dataclass
class Checks:
    """The numbers that decide `correct`, each with its limit: a run is
    correct when every number is at most its limit."""
    limits: dict
    values: dict = field(default_factory=dict)

    def worst(self, name: str, value: float) -> None:
        """Record `value`, keeping the largest seen under `name`."""
        if name not in self.limits:
            raise KeyError(f"no limit for {name!r}")
        value = float(value)
        old = self.values.get(name)
        if old is None or not value <= old:
            self.values[name] = value

    @property
    def correct(self) -> bool:
        return bool(self.values) and set(self.values) == set(self.limits) \
            and all(v <= self.limits[k] for k, v in self.values.items())

    def table(self) -> dict:
        return {k: {"value": self.values.get(k), "limit": self.limits[k]}
                for k in self.limits}

    def lines(self) -> list[str]:
        return [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
                for k, v in self.table().items()]


def reader(name: str):
    """The `read(window)` function of `bench/metrics/<name>.py`."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def finite(v) -> bool:
    return v is not None and isinstance(v, (int, float)) and math.isfinite(v)


def say(*lines: str) -> None:
    for line in lines:
        print(line, file=sys.stderr, flush=True)


@dataclass
class Window:
    """What the per-layer readers read: the measured window's length and
    calls, the program's launch counts and spans over it, the work the
    calls asked for (`work`, from `roofline.py`), and the device trace of
    a traced run (None otherwise)."""
    seconds: float
    calls: int
    launches: dict
    spans: dict
    work: dict
    trace: object = None


@dataclass
class Outcome:
    """A driver's run: its end-to-end metrics, the window, the checks,
    and the counts of the result line."""
    e2e: dict
    window: Window
    checks: Checks
    attempted: int
    failed: int
    memory_peak_bytes: int
    notes: list = field(default_factory=list)


@dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str              # "cuda" on the card; "cpu" only in tests
    t_start: float           # perf_counter at process start
    argv: list = field(default_factory=list)
    root: Path = ROOT


def launches_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] - before.get(k, 0)}


def span_stats(obs, names) -> dict:
    return {n: obs.hist_stats(n) for n in names if obs.hist_stats(n)}


def sync(device: str) -> None:
    if device == "cuda":
        import torch
        torch.cuda.synchronize()


def memory_peak(device: str) -> int:
    if device != "cuda":
        return 0
    import torch
    return int(torch.cuda.max_memory_allocated())


def release(device: str) -> None:
    """Hand the cached blocks back to the card: before the window, so
    that every run starts it alike (a first run's plan sweep leaves
    blocks behind), and before the reference runs."""
    import gc
    gc.collect()
    if device == "cuda":
        import torch
        torch.cuda.empty_cache()
