"""Every cell runs once through the harness on the CPU at a small size,
traced and not, and prints one last line with the contract's keys."""
from __future__ import annotations

import json

import pytest

from bench import harness, run
from conftest import PENDING_CELLS

WORKLOADS = [w["name"] for w in harness.load_spec()["workloads"]] \
    + PENDING_CELLS
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run_cell(root, workload, trace, capsys, seed=1234567891011):
    rc = run.main(["--workload", workload, "--seed", str(seed),
                   "--seconds", "0.5", "--trace", str(trace),
                   "--root", str(root)], device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_runs_and_prints_the_contract_line(small_root, workload, trace,
                                               capsys):
    line = run_cell(small_root, workload, trace, capsys)
    spec = harness.cell(harness.load_spec(small_root), workload, small_root)
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == want
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert line["device"]["count"] == spec.chips
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        names = {m["name"] for m in spec.per_layer}
    else:
        names = {m["name"] for m in spec.end_to_end}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(line["checks"]) == set(spec.limits)
