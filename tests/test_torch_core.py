"""The port's core modules (`repro_torch.core`, `repro_torch.convert`)
against the JAX reference, on the CPU.

The same numpy inputs go through the reference function and its
counterpart in the port; outputs agree within 1e-5 absolute (the
reference's own f32 parity bar) and supports agree exactly.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import debias as jdebias
from repro.core import engine as jengine
from repro.core import metrics as jmetrics
from repro.core import prox as jprox
from repro.core import solvers as jsolvers
from repro.core import synth as jsynth
from repro_torch.convert import from_reference
from repro_torch.core import debias, engine, metrics, prox, solvers, synth
from repro_torch.core.dsml import DsmlResult
from repro_torch.kernels.common import LAUNCHES

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got: torch.Tensor, want, atol=ATOL):
    want = np.array(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


@pytest.fixture(scope="module")
def stats():
    """Sufficient statistics of the reference's own synthetic data (the
    statistical tier's design at a small size), as numpy arrays."""
    d = jsynth.gen_regression(jax.random.PRNGKey(3), m=4, n=60, p=32, s=4)
    S, c = jengine.sufficient_stats(d.Xs, d.ys)
    return (np.array(d.Xs), np.array(d.ys), np.array(S), np.array(c))


# ---- prox -------------------------------------------------------------------

@pytest.mark.parametrize("name, tau", [
    ("soft_threshold", 0.3), ("group_soft_threshold", 0.8),
    ("group_hard_threshold", 1.2), ("support_from_rows", 1.2),
    ("project_l1_ball", 1.5), ("prox_linf", 0.7),
])
def test_prox_operators_match_reference(name, tau):
    v = np.random.default_rng(0).standard_normal((20, 6)).astype(np.float32)
    got = getattr(prox, name)(_t(v), tau)
    want = np.array(getattr(jprox, name)(jnp.asarray(v), tau))
    if want.dtype == bool:
        assert np.array_equal(got.numpy(), want)
    else:
        _close(got, want)


def test_project_l1_ball_inside_is_identity_and_outside_on_sphere():
    v = torch.tensor([[0.1, -0.2, 0.3], [3.0, -1.0, 2.0]])
    out = prox.project_l1_ball(v, 1.0)
    assert torch.equal(out[0], v[0])
    assert abs(out[1].abs().sum().item() - 1.0) < 1e-6


# ---- solvers ----------------------------------------------------------------

def test_fista_momentum_schedule_is_the_reference_float32_one():
    t, tj = np.float32(1.0), jnp.array(1.0, jnp.float32)
    for _ in range(1000):
        t_next, theta = solvers.fista_momentum(t)
        tj_next = 0.5 * (1.0 + jnp.sqrt(1.0 + 4.0 * tj * tj))
        assert t_next.dtype == np.float32
        assert float(theta) == float((tj - 1.0) / tj_next)
        t, tj = t_next, tj_next
    assert float(t) == float(tj)


def test_power_iteration_matches_reference(stats):
    _, _, S, _ = stats
    _close(solvers.power_iteration(_t(S[0])),
           jsolvers.power_iteration(jnp.asarray(S[0])), atol=1e-5)
    _close(engine.power_iteration_batched(_t(S)),
           jengine.power_iteration_batched(jnp.asarray(S)), atol=1e-5)
    _close(solvers.lasso_stats_step_scale(_t(S)),
           jax.vmap(jsolvers.lasso_stats_step_scale)(jnp.asarray(S)))


def test_generic_fista_matches_reference(stats):
    _, _, S, c = stats
    S0, c0 = S[0], c[0]
    step = np.float32(0.2)
    got = solvers.fista(lambda b: _t(S0) @ b - _t(c0),
                        lambda v, s: prox.soft_threshold(v, s * 0.05),
                        torch.zeros(S0.shape[0]), float(step), 200)
    want = jsolvers.fista(lambda b: jnp.asarray(S0) @ b - jnp.asarray(c0),
                          lambda v, s: jprox.soft_threshold(v, s * 0.05),
                          jnp.zeros(S0.shape[0]), step, 200)
    _close(got, want)


def test_single_task_lasso_matches_reference(stats):
    X, y, _, _ = stats
    _close(solvers.lasso(_t(X[0]), _t(y[0]), 0.2),
           jsolvers.lasso(jnp.asarray(X[0]), jnp.asarray(y[0]), 0.2))


def test_refit_ols_masked_matches_reference(stats):
    X, y, S, c = stats
    support = np.zeros(S.shape[-1], bool)
    support[[1, 4, 9, 20]] = True
    _close(solvers.refit_ols_masked_stats(_t(S[1]), _t(c[1]), _t(support)),
           jsolvers.refit_ols_masked_stats(S[1], c[1], support))
    _close(solvers.refit_ols_masked(_t(X[1]), _t(y[1]), _t(support)),
           jsolvers.refit_ols_masked(X[1], y[1], support))


# ---- engine -----------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_sufficient_stats_matches_reference(stats, weighted):
    X, y, _, _ = stats
    w = np.random.default_rng(1).uniform(0.5, 2.0, y.shape).astype(
        np.float32) if weighted else None
    S, c = engine.sufficient_stats(_t(X), _t(y),
                                   None if w is None else _t(w))
    S_j, c_j = jengine.sufficient_stats(X, y, w)
    _close(S, S_j)
    _close(c, c_j)


@pytest.mark.parametrize("variant", ["default", "per_task_lam", "beta0",
                                     "multi_rhs"])
def test_solve_lasso_batched_matches_reference(stats, variant):
    _, _, S, c = stats
    m, p = c.shape
    rng = np.random.default_rng(2)
    kw, kw_t, lam, cs = {}, {}, np.float32(0.05), c
    if variant == "per_task_lam":
        lam = rng.uniform(0.02, 0.1, m).astype(np.float32)
        kw["etas"] = rng.uniform(0.1, 0.3, m).astype(np.float32)
        kw_t["etas"] = _t(kw["etas"])
    elif variant == "beta0":
        kw["beta0"] = (0.1 * rng.standard_normal((m, p))).astype(np.float32)
        kw_t["beta0"] = _t(kw["beta0"])
    elif variant == "multi_rhs":
        cs = (0.1 * rng.standard_normal((m, p, 3))).astype(np.float32)
    lam_t = _t(lam) if np.ndim(lam) else float(lam)
    got = engine.solve_lasso_batched(_t(S), _t(cs), lam_t, iters=150,
                                     **kw_t)
    want = jengine.solve_lasso_batched(S, cs, lam, iters=150,
                                       use_kernel=False, **kw)
    _close(got, want)


@pytest.mark.parametrize("start", ["cold", "warm"])
def test_solve_lasso_eq2_matches_reference(stats, start):
    _, _, S, c = stats
    lam = 0.3
    beta0 = None
    if start == "warm":
        beta0 = jengine.solve_lasso_eq2(S, c, 0.25, iters=100)
    got = engine.solve_lasso_eq2(
        _t(S), _t(c), lam, iters=400,
        beta0=None if beta0 is None else from_reference(beta0, "cpu"))
    want = jengine.solve_lasso_eq2(S, c, lam, iters=400, beta0=beta0)
    _close(got, want)


def test_solve_lasso_eq2_tol_counts_iterations_like_reference(stats):
    _, _, S, c = stats
    lam_max = jengine.power_iteration_batched(S)
    got, n_got = engine.solve_lasso_eq2(
        _t(S), _t(c), 0.3, iters=400, lam_max=_t(lam_max), tol=1e-4,
        check_every=25, return_iters=True)
    want, n_want = jengine.solve_lasso_eq2(
        S, c, 0.3, iters=400, lam_max=lam_max, tol=1e-4, check_every=25,
        return_iters=True)
    assert n_got == int(n_want)
    assert n_got < 400
    _close(got, want)


def test_fista_loop_tol_ceiling_is_exact(stats):
    _, _, S, c = stats
    _, n = engine.solve_lasso_eq2(_t(S), _t(c), 0.3, iters=30, tol=0.0,
                                  check_every=25, return_iters=True)
    assert n == 30


@pytest.mark.parametrize("start", ["cold", "warm"])
def test_inverse_hessian_batched_matches_reference(stats, start):
    _, _, S, _ = stats
    mu = 0.15
    M0 = None
    if start == "warm":
        M0 = jengine.inverse_hessian_batched(S, mu, iters=100)
    got = engine.inverse_hessian_batched(
        _t(S), mu, iters=300,
        M0=None if M0 is None else from_reference(M0, "cpu"))
    want = jengine.inverse_hessian_batched(S, mu, iters=300, M0=M0)
    _close(got, want)


def test_debias_batched_and_scaled_identity_match_reference(stats):
    _, _, S, c = stats
    rng = np.random.default_rng(4)
    b = (0.2 * rng.standard_normal(c.shape)).astype(np.float32)
    M = rng.standard_normal(S.shape).astype(np.float32) / S.shape[-1]
    _close(engine.debias_batched(_t(S), _t(c), _t(b), _t(M)),
           jengine.debias_batched(S, c, b, M))
    _close(engine.scaled_identity_m0(_t(S)), jengine.scaled_identity_m0(S))


# ---- debias -----------------------------------------------------------------

def test_debias_module_matches_reference(stats):
    X, y, S, _ = stats
    mu = 0.15
    M = debias.inverse_hessian_m(_t(S[0]), mu, iters=200)
    M_j = jdebias.inverse_hessian_m(S[0], mu, iters=200)
    _close(M, M_j)
    _close(debias.coherence(_t(S[0]), M), jdebias.coherence(S[0], M_j))
    b = np.zeros(S.shape[-1], np.float32)
    b[:3] = 0.5
    _close(debias.debias_lasso(_t(X[0]), _t(y[0]), _t(b), mu, iters=200),
           jdebias.debias_lasso(X[0], y[0], b, mu, iters=200))


# ---- metrics ----------------------------------------------------------------

def test_metrics_match_reference():
    rng = np.random.default_rng(5)
    B = rng.standard_normal((12, 3)).astype(np.float32)
    B[::2] = 0.0
    B_true = rng.standard_normal((12, 3)).astype(np.float32)
    Sig = np.array(jsynth.ar_covariance(12))
    assert np.array_equal(metrics.support_of(_t(B)).numpy(),
                          np.array(jmetrics.support_of(B)))
    s1, s2 = _t(B[:, 0] > 0), _t(B_true[:, 0] > 0)
    assert int(metrics.hamming(s1, s2)) == int(
        jmetrics.hamming(np.array(s1), np.array(s2)))
    _close(metrics.estimation_error(_t(B), _t(B_true)),
           jmetrics.estimation_error(B, B_true))
    _close(metrics.prediction_error(_t(B), _t(B_true), _t(Sig)),
           jmetrics.prediction_error(B, B_true, Sig))


# ---- synth ------------------------------------------------------------------

def test_ar_covariance_matches_reference():
    _close(synth.ar_covariance(9, 0.5, device="cpu"),
           jsynth.ar_covariance(9, 0.5), atol=1e-7)


def test_gen_regression_shapes_seeded_and_shared_support():
    a = synth.gen_regression(7, m=3, n=20, p=30, s=5, signal_low=0.3,
                             device="cpu")
    b = synth.gen_regression(torch.Generator().manual_seed(7), m=3, n=20,
                             p=30, s=5, signal_low=0.3, device="cpu")
    assert a.Xs.shape == (3, 20, 30) and a.ys.shape == (3, 20)
    assert a.B.shape == (30, 3) and a.Sigma.shape == (30, 30)
    assert a.Xs.dtype == torch.float32 and a.support.dtype == torch.bool
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert int(a.support.sum()) == 5
    assert torch.equal(metrics.support_of(a.B), a.support)
    assert float(a.B[a.support].min()) >= 0.3
    noise = a.ys - torch.einsum("tnp,pt->tn", a.Xs, a.B)
    assert 0.3 < float(noise.std()) < 3.0


# ---- convert ----------------------------------------------------------------

def test_from_reference_carries_data_and_results():
    d = jsynth.gen_regression(jax.random.PRNGKey(0), m=2, n=8, p=6, s=2)
    td = from_reference(d, "cpu")
    assert isinstance(td, synth.MultiTaskData)
    for a, t in zip(d, td):
        assert np.array_equal(np.array(a), t.numpy())
        assert t.numpy().flags.writeable
    assert td.support.dtype == torch.bool
    res = DsmlResult(*(np.zeros((2, 6), np.float32) for _ in range(4)))
    tr = from_reference(res, "cpu")
    assert isinstance(tr, DsmlResult) and tr.beta_u.shape == (2, 6)
    beta0 = jnp.ones((2, 6))
    assert torch.equal(from_reference(beta0, "cpu"), torch.ones(2, 6))


def test_from_reference_rejects_unknown_tuples():
    with pytest.raises(TypeError, match="no port counterpart"):
        from_reference(jsolvers.FistaResult(1.0, 2.0, 3.0), "cpu")


def test_core_on_cpu_launches_no_kernel(stats):
    _, _, S, c = stats
    before = dict(LAUNCHES)
    engine.solve_lasso_eq2(_t(S), _t(c), 0.3, iters=5)
    engine.inverse_hessian_batched(_t(S), 0.1, iters=5)
    assert dict(LAUNCHES) == before
