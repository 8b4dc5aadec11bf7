"""The port's streaming DSML (`repro_torch.stream`) against the JAX
reference's `repro.stream`, on the CPU.

Case for case the reference's `tests/test_stream.py` (its sharded
cases run on gloo ranks in `tests/test_torch_substrate.py`) and the guard and rollback cases
of `tests/test_chaos.py`, run on the port; and each port function held
against its reference counterpart on the same state: `ingest` (plain,
decayed, weighted), `merge`, `window_stats`, `refit` (cold, warm and
with `tol=`), `refit_logistic`, `refit_health`, `IngestGuard`'s verdicts
and quarantine ledger, and a whole service run with the guard, a forced
divergence and the adaptive cadence.

Inputs come from the reference (`gen_regression`, `gen_classification`,
`repro.testing.make_clean_batch`, `apply_batch_fault`), copied with
`np.array`. States agree within 1e-5 absolute, refits within 1e-5 as
`tests/test_torch_dsml.py` holds `dsml_fit`; supports, generations,
rollbacks and refit intervals are identical.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.stream as jstream
from repro.core import gen_classification as jax_gen_classification
from repro.core import gen_regression as jax_gen_regression
from repro.stream.guard import IngestGuard as JaxIngestGuard
from repro.testing import DivergenceInjector as JaxDivergenceInjector
from repro.testing import apply_batch_fault as jax_apply_batch_fault
from repro.testing import make_clean_batch as jax_make_clean_batch
from repro_torch.convert import from_reference
from repro_torch.core import dsml_fit, sufficient_stats
from repro_torch.stream import (
    IngestGuard, StreamingDsmlService, ingest, init_stream_state,
    init_window, merge, refit, refit_health, refit_logistic, window_ingest,
    window_stats,
)
from repro_torch.testing import (
    DivergenceInjector, apply_batch_fault, make_clean_batch,
)

LAM, MU, THR = 0.4, 0.2, 1.0
ITERS = dict(lasso_iters=200, debias_iters=200)
ATOL = 1e-5
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _data(m=4, n=120, p=48, s=5, seed=0):
    """The reference's data as numpy arrays (Xs, ys)."""
    d = jax_gen_regression(jax.random.PRNGKey(seed), m=m, n=n, p=p, s=s)
    return np.array(d.Xs), np.array(d.ys)


def _chunks(Xs, ys, k):
    return list(zip(np.split(Xs, k, axis=1), np.split(ys, k, axis=1)))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _ingest_all(Xs, ys, k, **kw):
    """(port state, reference state) after the same k chunks."""
    m, _, p = Xs.shape
    st = init_stream_state(m, p, device=CPU)
    ref = jstream.init_stream_state(m, p)
    for Xc, yc in _chunks(Xs, ys, k):
        st = ingest(st, _t(Xc), _t(yc), **kw)
        ref = jstream.ingest(ref, jnp.asarray(Xc), jnp.asarray(yc), **kw)
    return st, ref


def _close(got: torch.Tensor, want, atol=ATOL, msg=""):
    np.testing.assert_allclose(got.numpy(), np.array(want), rtol=0,
                               atol=atol, err_msg=msg)


def _same_state(got, want, fields=None):
    for name in fields or got._fields:
        a, b = getattr(got, name), np.array(getattr(want, name))
        if a.dtype in (torch.bool, torch.int32):
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
        else:
            _close(a, b, msg=name)


# ---------------------------------------------------------------------------
# additivity: chunked ingest == one-shot statistics == dsml_fit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3, 8])
def test_chunked_ingest_matches_one_shot_stats(k):
    Xs, ys = _data()
    state, ref = _ingest_all(Xs, ys, k)
    S, c = sufficient_stats(_t(Xs), _t(ys))
    _close(state.Sigmas, S)
    _close(state.cs, c)
    assert float(state.counts[0]) == Xs.shape[1]
    _same_state(state, ref, ("Sigmas", "cs", "counts"))


@pytest.mark.parametrize("k", [1, 3, 8])
def test_stream_refit_reproduces_dsml_fit(k):
    """Ingest in k chunks, refit once: the port's `dsml_fit` on the
    concatenated data and the reference's refit of the same chunks, to
    1e-5."""
    Xs, ys = _data()
    st, ref_st = _ingest_all(Xs, ys, k)
    state, info = refit(st, LAM, MU, THR, **ITERS)
    fit = dsml_fit(_t(Xs), _t(ys), LAM, MU, THR, **ITERS)
    _close(state.beta_tilde, fit.beta_tilde)
    _close(state.beta_u, fit.beta_u)
    assert torch.equal(state.support, fit.support)
    assert int(info.generation) == 1
    assert state.generation.device == CPU
    want, want_info = jstream.refit(ref_st, LAM, MU, THR, **ITERS)
    _same_state(state, want)
    assert float(info.jaccard) == float(want_info.jaccard)
    assert int(info.support_size) == int(want_info.support_size)
    assert (info.lasso_iters_run, info.debias_iters_run) == (200, 200)


def test_warm_refit_on_unchanged_stats_is_fixed_point():
    Xs, ys = _data()
    st, ref_st = _ingest_all(Xs, ys, 3)
    state, _ = refit(st, LAM, MU, THR, **ITERS)
    again, info = refit(state, LAM, MU, THR, **ITERS)
    _close(again.beta_tilde, state.beta_tilde.numpy())
    assert torch.equal(again.support, state.support)
    assert float(info.jaccard) == 1.0
    assert int(again.generation) == 2
    # the warm refit of generation 1 starts from its Ms, as the
    # reference's does: both packages' generation-2 states agree
    ref1, _ = jstream.refit(ref_st, LAM, MU, THR, **ITERS)
    ref2, _ = jstream.refit(ref1, LAM, MU, THR, **ITERS)
    _same_state(again, ref2)


def test_refit_with_tol_runs_the_reference_iterations():
    """`tol=` makes the budgets ceilings: cold and warm, the port stops
    after the iterations the reference runs, at the same answer."""
    Xs, ys = _data()
    st, ref_st = _ingest_all(Xs, ys, 2)
    got, want = st, ref_st
    for _ in range(2):
        got, info = refit(got, LAM, MU, THR, tol=1e-5, **ITERS)
        want, want_info = jstream.refit(want, LAM, MU, THR, tol=1e-5,
                                        **ITERS)
        assert info.lasso_iters_run == int(want_info.lasso_iters_run)
        assert info.debias_iters_run == int(want_info.debias_iters_run)
        _same_state(got, want)
    assert info.lasso_iters_run < 200          # the warm refit stopped early


def test_merge_matches_single_stream():
    Xs, ys = _data()
    (Xa, ya), (Xb, yb) = _chunks(Xs, ys, 2)
    m, p = Xs.shape[0], Xs.shape[2]
    a = ingest(init_stream_state(m, p, device=CPU), _t(Xa), _t(ya))
    b = ingest(init_stream_state(m, p, device=CPU), _t(Xb), _t(yb))
    both = merge(a, b)
    S, c = sufficient_stats(_t(Xs), _t(ys))
    _close(both.Sigmas, S)
    _close(both.cs, c)
    ja = jstream.ingest(jstream.init_stream_state(m, p), Xa, ya)
    jb = jstream.ingest(jstream.init_stream_state(m, p), Xb, yb)
    _same_state(both, jstream.merge(ja, jb), ("Sigmas", "cs", "counts"))


def test_from_reference_carries_a_stream_state():
    Xs, ys = _data()
    _, ref = _ingest_all(Xs, ys, 2)
    ref, _ = jstream.refit(ref, LAM, MU, THR, **ITERS)
    st = from_reference(ref, CPU)
    for name, a in zip(st._fields, st):
        b = np.array(getattr(ref, name))
        assert a.dtype == torch.from_numpy(b).dtype, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    assert st.generation.device == CPU and int(st.generation) == 1


# ---------------------------------------------------------------------------
# non-stationary variants
# ---------------------------------------------------------------------------

def test_decayed_ingest_matches_closed_form():
    """With per-chunk decay d, the state must equal the weighted average
    sum_k d^{K-k} n_k stats_k / sum_k d^{K-k} n_k."""
    Xs, ys = _data()
    d, k = 0.5, 4
    state, ref = _ingest_all(Xs, ys, k, decay=d)
    chunks = _chunks(Xs, ys, k)
    w = [d ** (k - 1 - i) for i in range(k)]
    num_S, num_c, den = 0.0, 0.0, 0.0
    for wi, (Xc, yc) in zip(w, chunks):
        S, c = sufficient_stats(_t(Xc), _t(yc))
        n = Xc.shape[1]
        num_S, num_c, den = num_S + wi * n * S, num_c + wi * n * c, \
            den + wi * n
    _close(state.Sigmas, num_S / den)
    _close(state.cs, num_c / den)
    np.testing.assert_allclose(float(state.counts[0]), den, rtol=1e-6)
    _same_state(state, ref, ("Sigmas", "cs", "counts"))


def test_weighted_ingest_matches_manual_weighting():
    Xs, ys = _data(m=2, n=40, p=16, s=3)
    w = np.array(jax.random.uniform(jax.random.PRNGKey(3), ys.shape,
                                    minval=0.2, maxval=1.0))
    state = ingest(init_stream_state(2, 16, device=CPU), _t(Xs), _t(ys),
                   weights=_t(w))
    Xw = Xs * w[..., None]
    S = np.einsum("tni,tnj->tij", Xw, Xs) / np.sum(w, 1)[:, None, None]
    _close(state.Sigmas, S)
    np.testing.assert_allclose(state.counts.numpy(), np.sum(w, 1),
                               rtol=1e-5)
    ref = jstream.ingest(jstream.init_stream_state(2, 16), Xs, ys,
                         weights=jnp.asarray(w))
    _same_state(state, ref, ("Sigmas", "cs", "counts"))


def test_window_stats_cover_exactly_last_w_chunks():
    Xs, ys = _data()
    k, w = 6, 3
    m, p = Xs.shape[0], Xs.shape[2]
    win = init_window(w, m, p, device=CPU)
    jwin = jstream.init_window(w, m, p)
    chunks = _chunks(Xs, ys, k)
    for Xc, yc in chunks:
        win = window_ingest(win, _t(Xc), _t(yc))
        jwin = jstream.window_ingest(jwin, Xc, yc)
    X_tail = np.concatenate([Xc for Xc, _ in chunks[-w:]], axis=1)
    y_tail = np.concatenate([yc for _, yc in chunks[-w:]], axis=1)
    S, c, counts = window_stats(win)
    S_ref, c_ref = sufficient_stats(_t(X_tail), _t(y_tail))
    _close(S, S_ref)
    _close(c, c_ref)
    assert float(counts[0]) == X_tail.shape[1]
    assert int(win.seen) == k and win.head.device == CPU
    for got, want in zip((S, c, counts), jstream.window_stats(jwin)):
        _close(got, want)
    _same_state(win, jwin)


# ---------------------------------------------------------------------------
# the Section-4 refit and the health check
# ---------------------------------------------------------------------------

def test_refit_logistic_matches_reference_cold_then_warm():
    d = jax_gen_classification(jax.random.PRNGKey(1), m=3, n=80, p=24, s=3)
    Xs, ys = np.array(d.Xs), np.array(d.ys)
    lam = float(np.sqrt(np.log(24) / 80))
    st = init_stream_state(3, 24, device=CPU)
    ref = jstream.init_stream_state(3, 24)
    for _ in range(2):                          # generation 0, then 1
        st, info = refit_logistic(st, _t(Xs), _t(ys), lam, 2 * lam, 0.5,
                                  lasso_iters=150, debias_iters=150)
        ref, want = jstream.refit_logistic(ref, Xs, ys, lam, 2 * lam, 0.5,
                                           lasso_iters=150,
                                           debias_iters=150)
        _same_state(st, ref, ("beta_local", "Ms", "beta_u", "beta_tilde",
                              "support", "generation"))
        assert int(info.support_size) == int(want.support_size)
        assert float(info.jaccard) == pytest.approx(float(want.jaccard))
    assert int(st.generation) == 2 and 0 < int(st.support.sum()) < 24


def test_refit_health_matches_reference_verdicts():
    Xs, ys = _data()
    st, ref_st = _ingest_all(Xs, ys, 2)
    cand, _ = refit(st, LAM, MU, THR, **ITERS)
    jcand, _ = jstream.refit(ref_st, LAM, MU, THR, **ITERS)
    nan = float("nan")
    cases = [
        (cand, jcand, {}),                              # healthy
        (cand, jcand, dict(kkt_ceiling=0.0)),           # residual > 0
        (cand, jcand, dict(max_support=0)),             # support ceiling
        (cand._replace(beta_tilde=torch.full_like(cand.beta_tilde, nan)),
         jcand._replace(beta_tilde=jnp.full_like(jcand.beta_tilde, nan)),
         {}),
    ]
    reasons = []
    for got_c, want_c, kw in cases:
        got = refit_health(got_c, LAM, **kw)
        want = jstream.refit_health(want_c, LAM, **kw)
        assert (got.healthy, got.reason, got.support_size) == \
            (want.healthy, want.reason, want.support_size)
        assert got.kkt_residual == pytest.approx(want.kkt_residual,
                                                 abs=ATOL)
        reasons.append(got.reason)
    assert reasons == [None, "kkt_residual", "support_size",
                       "nonfinite_model"]


# ---------------------------------------------------------------------------
# the guard
# ---------------------------------------------------------------------------

def _poisoned_sequence(seed=11, m=2, n=32, p=16):
    """Chunks from the reference's fault builders, as numpy arrays:
    clean traffic, then every fault kind, then a clean chunk."""
    rng = np.random.default_rng(seed)
    out = []
    for kind in (None, None, None, "nan", None, "inf", "outlier", None):
        X, y = jax_make_clean_batch(rng, m, n, p)
        if kind is not None:
            X, y = jax_apply_batch_fault(X, y, kind, rng)
        out.append((np.array(X), np.array(y)))
    return out


def _same_ledger(got, want):
    assert len(got.ledger) == len(want.ledger)
    for a, b in zip(got.ledger, want.ledger):
        assert (a.seq, a.reason, a.shape) == (b.seq, b.reason, b.shape)
        for x, y in ((a.stat, b.stat), (a.threshold, b.threshold)):
            assert x == pytest.approx(y, rel=1e-5, nan_ok=True)
    assert got.summary()["by_reason_in_ledger"] == \
        want.summary()["by_reason_in_ledger"]
    assert (got.accepted, got.total_quarantined) == \
        (want.accepted, want.total_quarantined)
    assert got.reference_rms == pytest.approx(want.reference_rms, rel=1e-5)


@pytest.mark.parametrize("max_abs", [None, 50.0])
def test_guard_verdicts_and_ledger_match_reference(max_abs):
    """The standalone `admit` probe of both packages on the same chunks:
    the same verdicts, ledger records and reference scale."""
    got = IngestGuard(warmup_chunks=1, max_abs=max_abs)
    want = JaxIngestGuard(warmup_chunks=1, max_abs=max_abs)
    verdicts = []
    for X, y in _poisoned_sequence():
        v = got.admit(_t(X), _t(y))
        assert v == want.admit(jnp.asarray(X), jnp.asarray(y))
        verdicts.append(v[1])
    big = "outlier" if max_abs is None else "magnitude"
    assert verdicts == [None, None, None, "nonfinite", None, "nonfinite",
                        big, None]
    _same_ledger(got, want)


@pytest.mark.parametrize("kind", ["nan", "inf", "outlier"])
def test_poisoned_batch_is_quarantined_bitwise(kind):
    rng = np.random.default_rng(3)
    svc = StreamingDsmlService(2, 16, lam=LAM, mu=MU, Lam=THR, device=CPU,
                               refit_every=10**9,
                               guard=IngestGuard(warmup_chunks=1))
    for _ in range(3):          # healthy traffic arms the outlier gate
        svc.ingest(*make_clean_batch(rng, 2, 32, 16, device=CPU))
    before = [t.clone() for t in (svc.state.Sigmas, svc.state.cs,
                                  svc.state.counts)]
    X, y = apply_batch_fault(*make_clean_batch(rng, 2, 32, 16, device=CPU),
                             kind, rng)
    assert svc.ingest(X, y) is None
    for b, a in zip(before, (svc.state.Sigmas, svc.state.cs,
                             svc.state.counts)):
        assert torch.equal(b, a)           # bitwise: reject = no fold
    assert svc.guard.total_quarantined == 1
    want_reason = "outlier" if kind == "outlier" else "nonfinite"
    assert svc.guard.ledger[-1].reason == want_reason
    assert svc.ingest(*make_clean_batch(rng, 2, 32, 16,
                                        device=CPU)) is None
    assert svc.guard.accepted == 4


def test_guard_magnitude_ceiling_routes_standalone():
    rng = np.random.default_rng(4)
    svc = StreamingDsmlService(2, 16, lam=LAM, mu=MU, Lam=THR, device=CPU,
                               guard=IngestGuard(max_abs=50.0),
                               refit_every=10**9)
    svc.ingest(*make_clean_batch(rng, 2, 32, 16, device=CPU))
    X, y = make_clean_batch(rng, 2, 32, 16, device=CPU)
    X[0, 0, 0] = 1e3
    assert svc.ingest(X, y) is None
    assert svc.guard.ledger[-1].reason == "magnitude"
    assert svc.guard.accepted == 1


def test_quarantine_ledger_is_bounded():
    g = IngestGuard(ledger_capacity=4)
    rng = np.random.default_rng(5)
    X, y = apply_batch_fault(*make_clean_batch(rng, 1, 8, 8, device=CPU),
                             "nan", rng)
    for _ in range(7):
        assert g.admit(X, y) == (False, "nonfinite")
    assert len(g.ledger) == 4
    assert g.dropped_records == 3
    assert g.total_quarantined == 7


def test_fault_builders_give_the_reference_chunks():
    """A seed gives both packages' fault builders the same chunks."""
    for kind in ("nan", "inf", "outlier"):
        r1, r2 = np.random.default_rng(9), np.random.default_rng(9)
        X, y = apply_batch_fault(*make_clean_batch(r1, 2, 8, 16, device=CPU),
                                 kind, r1)
        jX, jy = jax_apply_batch_fault(*jax_make_clean_batch(r2, 2, 8, 16),
                                       kind, r2)
        np.testing.assert_array_equal(X.numpy(), np.array(jX))
        np.testing.assert_array_equal(y.numpy(), np.array(jy))


# ---------------------------------------------------------------------------
# rollback
# ---------------------------------------------------------------------------

def test_forced_divergent_refit_rolls_back_and_recovers():
    rng = np.random.default_rng(6)
    svc = StreamingDsmlService(2, 16, lam=LAM, mu=MU, Lam=THR, device=CPU,
                               refit_every=64, guard=False)
    svc.ingest(*make_clean_batch(rng, 2, 64, 16, device=CPU))
    assert svc.generation == 1
    Xp = torch.as_tensor(rng.standard_normal((8, 16)), dtype=torch.float32)
    good_pred = svc.predict(Xp)

    inj = DivergenceInjector(svc)
    inj.arm(1)
    info = svc.refit()
    assert inj.injected == 1
    assert svc.generation == 1                 # rollback kept last good
    assert int(info.generation) == 1
    assert svc.rollbacks == 1
    assert svc.last_health is not None and not svc.last_health.healthy
    assert svc.last_health.reason == "nonfinite_model"
    assert svc._interval == 2 * 64             # capped exponential backoff
    assert torch.equal(svc.predict(Xp), good_pred)

    svc.refit()                                # escalated retry, healthy
    inj.uninstall()
    assert svc.generation == 2
    assert svc._refit_failures == 0
    assert svc._interval == 64                 # cadence back to base
    assert torch.isfinite(svc.predict(Xp)).all()


def test_backoff_caps_at_max_refit_interval():
    svc = StreamingDsmlService(2, 16, lam=LAM, mu=MU, Lam=THR, device=CPU,
                               refit_every=64, max_refit_interval=256,
                               guard=False)
    rng = np.random.default_rng(7)
    svc.ingest(*make_clean_batch(rng, 2, 64, 16, device=CPU))
    inj = DivergenceInjector(svc)
    inj.arm(5)
    for want in (128, 256, 256, 256, 256):     # 64*2^k capped at 256
        svc.refit()
        assert svc._interval == want
    assert svc.generation == 1
    assert svc.rollbacks == 5
    inj.uninstall()


# ---------------------------------------------------------------------------
# service driver
# ---------------------------------------------------------------------------

def _service(cls, **kw):
    kw.setdefault("lasso_iters", 200)
    kw.setdefault("debias_iters", 200)
    return cls(4, 48, lam=LAM, mu=MU, Lam=THR, **kw)


def test_service_ingest_refit_predict_roundtrip(tmp_path):
    Xs, ys = _data()
    svc = _service(StreamingDsmlService, refit_every=60, device=CPU)
    ref = _service(jstream.StreamingDsmlService, refit_every=60)
    infos = []
    for Xc, yc in _chunks(Xs, ys, 4):
        infos.append(svc.ingest(Xc, yc))
        want = ref.ingest(jnp.asarray(Xc), jnp.asarray(yc))
        assert (infos[-1] is None) == (want is None)
        assert svc.generation == ref.generation
    assert svc.generation >= 1                     # cadence fired
    assert svc.samples_seen == Xs.shape[1]
    pred = svc.predict(Xs)
    assert pred.shape == ys.shape
    assert torch.isfinite(pred).all()
    _close(pred, ref.predict(jnp.asarray(Xs)))
    shared = svc.predict(Xs[0])                    # shared-design scoring
    assert shared.shape == (4, Xs.shape[1])
    _same_state(svc.state, ref.state)

    path = str(tmp_path / "stream_state")
    svc.save(path)
    fresh = _service(StreamingDsmlService, device=CPU)
    fresh.load(path)
    assert fresh.generation == svc.generation
    assert torch.equal(fresh.predict(Xs), pred)


def test_service_window_mode_survives_save_load(tmp_path):
    """A restored window-mode service must keep serving the same model:
    the ring buffer round-trips with the state, and a refit right after
    restore must NOT wipe the statistics."""
    Xs, ys = _data()
    kw = dict(window=3, refit_every=60, device=CPU)
    svc = _service(StreamingDsmlService, **kw)
    ref = _service(jstream.StreamingDsmlService, window=3, refit_every=60)
    for Xc, yc in _chunks(Xs, ys, 4):
        svc.ingest(Xc, yc)
        ref.ingest(jnp.asarray(Xc), jnp.asarray(yc))
    assert svc.generation == ref.generation >= 1
    _same_state(svc.state, ref.state)
    _same_state(svc.window, ref.window)
    assert svc.state.beta_tilde.abs().max() > 0

    path = str(tmp_path / "win_state")
    svc.save(path)
    fresh = _service(StreamingDsmlService, **kw)
    fresh.load(path)
    assert int(fresh.window.seen) == int(svc.window.seen)
    fresh.refit()
    assert fresh.state.beta_tilde.abs().max() > 0
    assert fresh.state.Sigmas.abs().max() > 0

    # a refit on a NEVER-fed window service must not zero the stats
    empty = _service(StreamingDsmlService, window=3, device=CPU)
    empty.state = svc.state
    empty.refit()
    assert empty.state.Sigmas.abs().max() > 0


def test_service_rejects_decay_with_window():
    with pytest.raises(ValueError):
        StreamingDsmlService(2, 8, lam=LAM, mu=MU, Lam=THR, device=CPU,
                             window=2, decay=0.9)


def test_service_mesh_waits_for_the_sharded_paths():
    """The sharded branch is host-only for the window, as the
    reference's; it runs on gloo ranks in `test_torch_substrate.py`."""
    with pytest.raises(ValueError, match="sliding-window ingestion is "
                                         "host-only"):
        StreamingDsmlService(2, 8, lam=LAM, mu=MU, Lam=THR, device=CPU,
                             window=2, mesh=object())


def test_service_rejects_window_ckpt_in_plain_service(tmp_path):
    """A window-mode checkpoint must not silently load as cumulative."""
    svc = StreamingDsmlService(2, 8, lam=LAM, mu=MU, Lam=THR, device=CPU,
                               window=2)
    path = str(tmp_path / "win_ckpt")
    svc.save(path)
    plain = StreamingDsmlService(2, 8, lam=LAM, mu=MU, Lam=THR, device=CPU)
    with pytest.raises(ValueError):
        plain.load(path)


def test_service_widens_refit_interval_when_support_stable():
    Xs, ys = _data(n=240)
    kw = dict(refit_every=40, drift_threshold=0.05, warm_lasso_iters=200)
    svc = _service(StreamingDsmlService, device=CPU, **kw)
    ref = _service(jstream.StreamingDsmlService, **kw)
    for Xc, yc in _chunks(Xs, ys, 6):
        svc.ingest(Xc, yc)
        ref.ingest(jnp.asarray(Xc), jnp.asarray(yc))
        assert (svc.generation, svc._interval) == \
            (ref.generation, ref._interval)
    # identical-distribution traffic: once warm, supports stop moving and
    # the adaptive cadence must have backed off from the base interval.
    assert svc.generation >= 2
    assert svc._interval > svc.refit_every
    assert float(svc.last_info.jaccard) == 1.0
    _same_state(svc.state, ref.state)


def _scenario():
    """One chunk sequence through a port and a reference service, both
    guarded, with poisoned chunks, a forced divergence and `refit_tol`:
    yields (step, port info, reference info, port svc, reference svc)."""
    rng = np.random.default_rng(21)
    kinds = {3: "nan", 6: "outlier", 9: "inf"}
    kw = dict(refit_every=80, max_refit_interval=320, refit_tol=1e-5)
    svc = _service(StreamingDsmlService, device=CPU,
                   guard=IngestGuard(warmup_chunks=1), **kw)
    ref = _service(jstream.StreamingDsmlService,
                   guard=JaxIngestGuard(warmup_chunks=1), **kw)
    inj, jinj = DivergenceInjector(svc), JaxDivergenceInjector(ref)
    for step in range(18):
        X, y = jax_make_clean_batch(rng, 4, 40, 48)
        if step in kinds:
            X, y = jax_apply_batch_fault(X, y, kinds[step], rng)
        if step == 7:
            inj.arm(1)
            jinj.arm(1)
        X, y = np.array(X), np.array(y)
        got = svc.ingest(X, y)
        want = ref.ingest(jnp.asarray(X), jnp.asarray(y))
        yield step, got, want, svc, ref


def test_service_run_matches_reference():
    """A guarded run with quarantines, a rollback and the adaptive
    cadence: the same verdicts, generations, rollbacks, intervals and
    iterations run at every step, and states within 1e-5."""
    refits = 0
    for step, got, want, svc, ref in _scenario():
        assert (got is None) == (want is None), step
        assert (svc.generation, svc.rollbacks, svc._interval,
                svc._since_refit) == (ref.generation, ref.rollbacks,
                                      ref._interval, ref._since_refit), step
        if got is not None:
            refits += 1
            assert int(got.generation) == int(want.generation)
            assert got.lasso_iters_run == (
                None if want.lasso_iters_run is None
                else int(want.lasso_iters_run))
        _same_state(svc.state, ref.state)
    assert svc.rollbacks == 1 and refits >= 4
    assert svc.guard.total_quarantined == 3
    _same_ledger(svc.guard, ref.guard)


def test_service_telemetry_matches_reference():
    """The same chunk sequence through both services records the same
    `stream.*` counter totals, gauge values and histogram counts in the
    two packages' registries."""
    from repro import obs as jobs
    from repro_torch import obs

    def stream_series(snap, kind):
        return {(e["name"], tuple(sorted(e["labels"].items()))):
                e.get("value", e.get("count"))
                for e in snap[kind] if e["name"].startswith("stream.")}

    obs.reset()
    jobs.reset()
    for _ in _scenario():
        pass
    got, want = obs.get_registry().snapshot(), jobs.get_registry().snapshot()
    for kind in ("counters", "gauges", "histograms"):
        assert stream_series(got, kind) == stream_series(want, kind), kind
    assert obs.counter_total("stream.quarantine") == 3
    assert obs.counter_total("stream.refit.rejected",
                             reason="nonfinite_model") == 1


# ---------------------------------------------------------------------------
# the seeded chaos schedule (the reference's tools/chaos.py run, on the port)
# ---------------------------------------------------------------------------

def test_schedule_is_deterministic():
    from repro.testing import build_schedule as jax_build_schedule
    from repro_torch.testing import build_schedule
    a = build_schedule(40, 123, per_kind=3, start=2)
    b = build_schedule(40, 123, per_kind=3, start=2)
    assert a == b
    assert all(2 <= ev.step < 40 for ev in a.events)
    assert a.by_kind() == {"nan": 3, "inf": 3, "outlier": 3}
    assert tuple(a.events) == tuple(
        jax_build_schedule(40, 123, per_kind=3, start=2).events)


def test_seeded_schedule_holds_all_invariants(tmp_path):
    """Every scriptable fault class through one guarded service with a
    checkpoint store (seed 7, 24 steps, as the reference's chaos run):
    no non-finite prediction, no generation regress, poisoned chunks
    leave (Sigma, c) bitwise unchanged and are all quarantined, a forced
    divergence rolls back, and a truncated head restores one retained
    generation back."""
    from repro_torch.testing import build_schedule, truncate_file
    m, p, n, steps = 4, 32, 64, 24
    rng = np.random.default_rng(7)
    schedule = build_schedule(steps, 7, per_kind=2, start=2)
    ckpt = tmp_path / "store"
    svc = StreamingDsmlService(m, p, lam=LAM, mu=MU, Lam=THR, device=CPU,
                               refit_every=128,
                               guard=IngestGuard(warmup_chunks=1),
                               ckpt_dir=str(ckpt), ckpt_keep=3)
    inj = DivergenceInjector(svc)
    last_gen, poisoned = 0, 0
    for step in range(steps):
        X, y = make_clean_batch(rng, m, n, p, device=CPU)
        X_clean = X
        kind = schedule.fault_for(step)
        before = None
        if kind is not None:
            X, y = apply_batch_fault(X, y, kind, rng)
            poisoned += 1
            before = (svc.state.Sigmas.clone(), svc.state.cs.clone())
        if step == steps // 2 and inj.injected == 0:
            inj.arm(1)
        svc.ingest(X, y)
        if before is not None:
            assert torch.equal(before[0], svc.state.Sigmas), step
            assert torch.equal(before[1], svc.state.cs), step
        assert svc.generation >= last_gen, step
        last_gen = svc.generation
        assert torch.isfinite(svc.predict(X_clean[:, :4, :])).all(), step
    assert poisoned >= 4 and len(schedule.by_kind()) == 3
    assert svc.guard.total_quarantined == poisoned
    assert inj.injected == 1 and svc.rollbacks >= 1
    inj.uninstall()
    gens = svc.ckpt_store.generations()
    assert len(gens) >= 2
    truncate_file(str(ckpt / f"ckpt_{gens[0]:08d}.npz"), keep_fraction=0.3)
    assert svc.restore() == gens[1]
    assert torch.isfinite(svc.state.beta_tilde).all()
