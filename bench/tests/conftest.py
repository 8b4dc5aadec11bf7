"""Small copies of the benchmark's cells for the CPU: the same spec,
traffic and limits, with each configuration cut to a size the CPU runs
in a second. Run from the repository root:

    python -m pytest bench/tests
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

from bench import harness  # noqa: E402

SMALL = {"m": 4, "n": 48, "p": 16, "s": 3, "Lam": 1.0, "lasso_iters": 30,
         "debias_iters": 40, "warm_lasso_iters": 10, "warm_debias_iters": 12,
         "refit_every": 16, "max_refit_interval": 64}
SMALL_TRAFFIC = {"chunk_rows": 8, "pool_chunks": 8,
                 "setup_chunks": 4, "setup_bursts": [1, 3], "row_pool": 32,
                 "rate_per_s": 200.0, "datasets": 2}
# cells kept under bench/ but not in BENCHMARK.json (the online service,
# the many-card fit): the small copies run them too
PENDING_CELLS = [w["name"] for w in json.loads(
    (ROOT / "bench" / "pending.json").read_text())["workloads"]]


def make_small_root(dest: Path) -> Path:
    """A spec root whose configurations and traffic are cut small. Four
    tasks, so that shared rows clear the master's threshold (Lambda 1)
    and the served models are not all zero; with the pending cells."""
    spec = harness.load_spec(pending=True)
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    for sub in ("configs", "traffic", "checks"):
        shutil.copytree(ROOT / "bench" / sub, dest / "bench" / sub)
    for sub, small in (("configs", SMALL), ("traffic", SMALL_TRAFFIC)):
        for f in (dest / "bench" / sub).glob("*.json"):
            d = json.loads(f.read_text())
            d.update({k: v for k, v in small.items() if k in d})
            f.write_text(json.dumps(d))
    return dest


@pytest.fixture
def small_root(tmp_path) -> Path:
    return make_small_root(tmp_path)
