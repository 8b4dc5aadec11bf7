"""The port's regression baselines and grid solvers against the JAX
reference, on the CPU: `group_lasso`, `icap` (`core/solvers.py`),
`dirty_model` (`core/dirty.py`), `solve_lasso_grid` and
`solve_lasso_eq2_grid` (`core/engine.py`).

Inputs come from the reference's `gen_regression` and go to both packages
as the same arrays. Every output agrees within 1e-5 absolute after the
chained FISTA iterations, and the supports (nonzero rows or entries) are
identical.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.core.dirty import dirty_model as jax_dirty_model
from repro.core.engine import (
    solve_lasso_eq2_grid as jax_solve_lasso_eq2_grid,
    solve_lasso_grid as jax_solve_lasso_grid,
    sufficient_stats as jax_sufficient_stats,
)
from repro.core.solvers import group_lasso as jax_group_lasso
from repro.core.solvers import icap as jax_icap
from repro.core.synth import gen_regression as jax_gen_regression
from repro_torch.convert import from_reference
from repro_torch.core import (
    dirty_model, group_lasso, icap, solve_lasso_eq2_grid, solve_lasso_grid,
    sufficient_stats,
)
from repro_torch.kernels.common import LAUNCHES

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def data():
    d = jax_gen_regression(jax.random.PRNGKey(0), m=4, n=50, p=32, s=4)
    return d, from_reference(d, "cpu")


def _close(got: torch.Tensor, want, atol=ATOL):
    want = np.array(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


def _same_support(got: torch.Tensor, want):
    assert np.array_equal(got.numpy() != 0, np.array(want) != 0)


@pytest.mark.parametrize("lam", [0.1, 0.3])
@pytest.mark.parametrize("name", ["group_lasso", "icap"])
def test_multitask_estimators_match_reference(data, name, lam):
    d, td = data
    port, ref = {"group_lasso": (group_lasso, jax_group_lasso),
                 "icap": (icap, jax_icap)}[name]
    got = port(td.Xs, td.ys, lam, iters=300)
    want = ref(d.Xs, d.ys, lam, iters=300)
    assert got.shape == (32, 4)
    _close(got, want)
    _same_support(got, want)
    rows = int((torch.linalg.vector_norm(got, dim=1) > 0).sum())
    assert 0 < rows < 32


@pytest.mark.parametrize("lam_s, lam_e", [(0.1, 0.05), (0.3, 0.1)])
def test_dirty_model_matches_reference(data, lam_s, lam_e):
    d, td = data
    got = dirty_model(td.Xs, td.ys, lam_s, lam_e, iters=300)
    want = jax_dirty_model(d.Xs, d.ys, lam_s, lam_e, iters=300)
    for name, g, w in zip("BSE", got, want):
        assert g.shape == (32, 4), name
        _close(g, w)
        _same_support(g, w)
    B, S, E = got
    assert torch.equal(B, S + E)


def _grid(d, k):
    S, c = jax_sufficient_stats(d.Xs, d.ys)
    lam_max = 2.0 * float(np.max(np.abs(np.array(c))))
    lams = (lam_max * np.geomspace(1.0, 0.01, k)).astype(np.float32)
    return np.array(S), np.array(c), lams


@pytest.mark.parametrize("k", [1, 5])
def test_solve_lasso_grid_matches_reference(data, k):
    d, _ = data
    S, c, lams = _grid(d, k)
    got = solve_lasso_grid(torch.from_numpy(S), torch.from_numpy(c),
                           torch.from_numpy(0.5 * lams), iters=300)
    want = jax_solve_lasso_grid(S, c, 0.5 * lams, iters=300)
    assert got.shape == (k, 4, 32)
    _close(got, want)
    _same_support(got, want)


@pytest.mark.parametrize("k", [1, 5])
def test_solve_lasso_eq2_grid_matches_reference(data, k):
    d, _ = data
    S, c, lams = _grid(d, k)
    got = solve_lasso_eq2_grid(torch.from_numpy(S), torch.from_numpy(c),
                               lams, iters=300)
    want = jax_solve_lasso_eq2_grid(S, c, lams, iters=300)
    assert got.shape == (k, 4, 32)
    _close(got, want)
    _same_support(got, want)
    # the top of the grid, lam_max, zeroes every task
    assert not bool(got[0].any())


def test_grid_rows_are_the_single_lambda_solves(data):
    # the grid is k independent solves batched: row i is the grid of the
    # single value lams[i]
    d, _ = data
    S, c, lams = _grid(d, 3)
    St, ct = torch.from_numpy(S), torch.from_numpy(c)
    got = solve_lasso_eq2_grid(St, ct, lams, iters=200)
    for i in range(len(lams)):
        one = solve_lasso_eq2_grid(St, ct, lams[i:i + 1], iters=200)
        _close(got[i], one[0].numpy())


def test_baselines_on_cpu_launch_nothing_and_take_use_kernel(data):
    _, td = data
    before = dict(LAUNCHES)
    got = group_lasso(td.Xs, td.ys, 0.1, iters=20, use_kernel=False)
    assert torch.equal(got, group_lasso(td.Xs, td.ys, 0.1, iters=20))
    S, c = sufficient_stats(td.Xs, td.ys)
    solve_lasso_grid(S, c, [0.1, 0.01], iters=5, use_kernel=False)
    dirty_model(td.Xs, td.ys, 0.1, 0.05, iters=5, use_kernel=False)
    assert dict(LAUNCHES) == before
    with pytest.raises(ValueError, match="CUDA"):
        icap(td.Xs, td.ys, 0.1, iters=2, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        solve_lasso_eq2_grid(S, c, [0.1], iters=2, use_kernel=True)
