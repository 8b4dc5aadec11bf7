"""Run one cell of `BENCHMARK.json` once and print its result line.

    python3 bench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout that holds the port (`src/repro_torch`). The
cell's configuration, traffic and limits are found by its name; the
traffic's `driver` names the module of `bench/drivers/` that runs it.
Set-up is timed from the start of this process to the first timed call.
With `--trace 0` the line carries the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, read from a `torch.profiler` trace of
the window. The numbers that decide `correct` are printed, each beside
its limit, as the last lines of standard error and under `checks`, the
last key of the line. The run exits non-zero, and prints no line, when
the cell's cards are not there or when JAX or the JAX package is loaded.

`--rank`, `--init` and `--device` are for the ranks that a many-card
cell starts itself (the traffic's driver's `rank_run`; a rank exits 3 when
JAX or the JAX package is loaded in it); `--root` reads the spec's files from another
directory (the tests' small cells).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# bench's modules by package name only, never as top-level modules
sys.path[:] = [p for p in sys.path
               if not p or Path(p).resolve() != ROOT / "bench"]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench import harness  # noqa: E402


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--init", help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--root", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=20)
        return "card: " + "; ".join(out.stdout.strip().splitlines())
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"card: nvidia-smi unreadable ({e})"


def device_entry(ctx, out) -> dict:
    import torch
    if ctx.device == "cuda":
        kind = torch.cuda.get_device_name(0)
        platform = "gpu"
    else:
        kind, platform = "cpu", "cpu"
    entry = {"platform": platform, "kind": kind, "count": ctx.cell.chips,
             "memory_peak_bytes": out.memory_peak_bytes}
    if ctx.trace:
        entry["busy_s"] = out.window.trace.busy_s
        entry["window_s"] = out.window.trace.window_s
    return entry


def result(ctx, out) -> dict:
    from bench import devtrace
    metrics = {}
    if ctx.trace:
        for m in ctx.cell.per_layer:
            v = harness.reader(m["name"])(out.window)
            if harness.finite(v):
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in ctx.cell.end_to_end:
            metrics[m["name"]] = {"value": out.e2e[m["name"]],
                                  "unit": m["unit"]}
    line = {"correct": out.checks.correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics,
            "device": device_entry(ctx, out)}
    if ctx.trace:
        line["breakdown"] = devtrace.breakdown(out.window.trace)
    line["checks"] = out.checks.table()
    return line


def no_forbidden_modules() -> int:
    """0, or 3 when JAX or the JAX package is loaded in this process
    (said on standard error): a rank's exit code, which rank 0 checks."""
    found = harness.forbidden_modules()
    if found:
        harness.say(f"modules of JAX or the JAX package were loaded: {found}")
        return 3
    return 0


def main(argv=None, *, device: str | None = None,
         t_start: float = T_START) -> int:
    """One run. `device` other than None (the tests' "cpu") skips the
    look for cards; the command line always measures the card."""
    args = parse(sys.argv[1:] if argv is None else argv)
    harness.prepare_env()
    root = Path(args.root) if args.root else ROOT
    cell = harness.cell(harness.load_spec(root), args.workload, root)
    base = ["--workload", args.workload, "--seed", str(args.seed),
            "--seconds", repr(args.seconds), "--trace", str(args.trace)]
    if args.root:                    # the run's own arguments, for ranks
        base += ["--root", args.root]
    driver = harness.driver(cell)
    if args.rank:
        ctx = harness.Context(cell, args.seed, args.seconds,
                              bool(args.trace), args.device, t_start, base,
                              root)
        driver.rank_run(ctx, args.rank, cell.chips, args.init)
        return no_forbidden_modules()
    if device is None:
        harness.require_cards(cell.chips)
        device = "cuda"
        harness.card_ready()
        harness.say(card_line(), f"set-up: the interpreter, torch and the "
                    f"card {time.perf_counter() - t_start:.3f} s")
    ctx = harness.Context(cell, args.seed, args.seconds, bool(args.trace),
                          device, t_start, base, root)
    out = driver.run(ctx)
    if no_forbidden_modules():
        return 3
    line = result(ctx, out)
    harness.say(*out.notes)
    harness.say(*out.checks.lines())
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
