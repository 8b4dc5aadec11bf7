"""The control of every cell, the plain reference in TF32 in the
program's place, comes out not correct. TF32 exists only on the card,
so this runs there (`python -m pytest -m gpu bench/tests`); the readings
at the cells' own sizes come from `bench/control.py`. Each cell's control
is its driver's, found by the name its traffic gives."""
from __future__ import annotations

import pytest
import torch

from bench import harness
from conftest import PENDING_CELLS, make_small_root

WORKLOADS = [w["name"] for w in harness.load_spec()["workloads"]] \
    + PENDING_CELLS


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("TF32, the control's precision, exists only on a "
                    "CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(card, tmp_path, workload):
    root = make_small_root(tmp_path)
    cell = harness.cell(harness.load_spec(root), workload, root)
    for seed in (11, 12, 13):
        ctx = harness.Context(cell, seed, 1.0, False, "cuda", 0.0)
        checks = harness.Checks(cell.limits)
        harness.driver(cell).control(ctx, checks, 24)
        assert not checks.correct, checks.table()
