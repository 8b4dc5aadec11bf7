"""The operation and byte counts against their closed forms at the
cells' shapes."""
from __future__ import annotations

import json

import pytest

from bench import harness, roofline

CFG = harness.cell(harness.load_spec(), "dsml-reg.fit").config
M, N, P = CFG["m"], CFG["n"], CFG["p"]


def test_debias_step():
    assert roofline.gemm_step_flops(M, P, P) == 2 * 1024 * 200 ** 3
    assert roofline.gemm_step_flops(M, P, P) / 1e9 == pytest.approx(16.384)
    # Sigma, Z, X, C read and X', Z' written: 5 p x p matrices a task, so
    # at p = 200 the step is bound by bandwidth, 0.2445 ms
    assert roofline.gemm_step_bytes(M, P, P) == 4 * 1024 * 5 * 200 ** 2
    assert roofline.bound_s(roofline.gemm_step_flops(M, P, P),
                            roofline.gemm_step_bytes(M, P, P)) == \
        pytest.approx(4 * 1024 * 5 * 200 ** 2 / 3.35e12)


def test_lasso_step_reads_sigma_once():
    assert roofline.gemv_step_bytes(M, P) == 4 * 1024 * (200 ** 2 + 5 * 200)
    assert roofline.bound_s(roofline.gemv_step_flops(M, P),
                            roofline.gemv_step_bytes(M, P)) == \
        pytest.approx(roofline.gemv_step_bytes(M, P) / 3.35e12)


def test_whole_fit():
    want = (1024 * 120 * 200 * 201 + 2 * 1024 * 120 * 200
            + 400 * 2 * 1024 * 200 ** 2 + 600 * 2 * 1024 * 200 ** 3)
    got = roofline.fit_flops(M, N, P, CFG["lasso_iters"], CFG["debias_iters"])
    assert got == want
    assert got / 1e12 == pytest.approx(9.868, abs=5e-4)


def test_grid_reads_the_distinct_sigma():
    k = 8
    assert roofline.grid_step_bytes(M, P, k) == \
        4 * (1024 * 200 ** 2 + 5 * 8192 * 200)
    assert roofline.grid_flops(M, N, P, k, 400) == \
        roofline.rank_update_flops(M, N, P) + 400 * 2 * 8192 * 200 ** 2


def test_refit_counts_the_iterations_run():
    cfg = json.loads((harness.BENCH / "configs" /
                      "dsml-stream-p256.json").read_text())
    m, p = cfg["m"], cfg["p"]
    assert (m, p) == (256, 256)
    assert roofline.refit_flops(m, p, 50, 50) == \
        50 * 2 * 256 * 256 ** 2 + 50 * 2 * 256 * 256 ** 3


def test_peaks():
    assert roofline.F32_ACCURATE == pytest.approx(165e12)
    assert roofline.F32_ACCURATE > roofline.FP32_FMA
    assert roofline.HBM == 3.35e12 and roofline.BF16 == 989e12
