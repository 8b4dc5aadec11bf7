"""The stream cell's load: the front's sustained rate, found once by a
sweep on the card and then fixed as `rate_per_s` in the traffic file.

    python3 bench/sweep.py --workload dsml-stream.ingest-serve \\
        --rates 1000,3000,6000,12000 --seconds 8 --seed 7

runs the cell's window at each rate in one process and prints, a line a
rate, the end-to-end metrics, the mean latency by quarter of the window
and how late the open-loop sender ran. A rate is sustained when the
latency does not rise through the window and the sender keeps to its
schedule (its 99th percentile lateness a few milliseconds, under a
tenth of a warm refit): a sender held back piles requests up in the
process before the front admits them. The benchmark's runs never run this.
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
    ap.add_argument("--workload", default="dsml-stream.ingest-serve")
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    harness.prepare_env()
    harness.require_cards(1)
    from bench.drivers import stream
    cell = harness.cell(harness.load_spec(pending=True), args.workload)
    for rate in (float(r) for r in args.rates.split(",")):
        cell.traffic["rate_per_s"] = rate
        ctx = harness.Context(cell, args.seed, args.seconds, False, "cuda",
                              time.perf_counter())
        out = stream.run(ctx)
        print(json.dumps({"rate_per_s": rate, "e2e": out.e2e,
                          "correct": out.checks.correct,
                          "failed": out.failed, "notes": out.notes}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
