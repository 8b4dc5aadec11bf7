"""Summarize a saved telemetry snapshot:

    python -m repro_torch.obs SNAPSHOT.json [--prometheus] [--top N]
"""
from __future__ import annotations

import argparse

from . import export


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Summarize a repro_torch.obs snapshot JSON file.")
    ap.add_argument("snapshot", help="path written by export.write_snapshot")
    ap.add_argument("--prometheus", action="store_true",
                    help="emit Prometheus text exposition instead of "
                         "the human summary")
    ap.add_argument("--top", type=int, default=20,
                    help="max series per section in the summary")
    args = ap.parse_args(argv)

    snap = export.load_snapshot(args.snapshot)
    if args.prometheus:
        print(export.to_prometheus(snap), end="")
    else:
        print(export.summarize(snap, top=args.top))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
