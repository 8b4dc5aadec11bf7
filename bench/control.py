"""The controls behind the cells' limits: the plain reference computed in
TF32 (the precision below the configurations' full float32), put in the
program's place and judged by the cell's driver's own comparison, with
the run's limits. A sound limit lets no control through.

    python3 bench/control.py --cells dsml-reg.fit,... --seeds 1,2,3 \\
        [--chunks N] [--seconds S]

on the card, from the root of a checkout. Each cell's traffic names its
driver in `bench/drivers/`, whose `control(ctx, checks, chunks)` runs it.
Prints one JSON line a cell and seed: each number the cell compares, the
control's reading, its limit, and whether the control came out correct
(it must not). `--chunks` is how many chunks a stream control ingests,
about as many as a run's set-up and window take, and `--seconds` the
window whose requests it answers. The benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:] = [p for p in sys.path
               if not p or Path(p).resolve() != ROOT / "bench"]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--chunks", type=int, default=None)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    harness.prepare_env()
    harness.require_cards(1)
    spec = harness.load_spec(pending=True)
    for name in args.cells.split(","):
        cell = harness.cell(spec, name)
        for seed in (int(s) for s in args.seeds.split(",")):
            ctx = harness.Context(cell, seed, args.seconds, False, "cuda",
                                  0.0)
            checks = harness.Checks(cell.limits)
            t0 = time.perf_counter()
            harness.driver(cell).control(ctx, checks, args.chunks)
            print(json.dumps({"control": name, "seed": seed,
                              "correct": checks.correct,
                              "seconds": time.perf_counter() - t0,
                              "checks": checks.table()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
