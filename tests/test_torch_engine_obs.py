"""The DSML engine's telemetry (`repro_torch.core.engine`, `core.dsml`) on
the CPU's plain path: one span a phase under the fit's root span, the
reference package's `engine.solve.*` records for the same calls, one
`dispatch.route` record a solve, and no read of the device added to the
engine's path.
"""
from __future__ import annotations

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro_torch import obs
from repro_torch.core import engine
from repro_torch.core.dsml import dsml_fit

M, N, P = 3, 40, 16
LAM, MU, THR = 0.3, 0.2, 0.5
ITERS = dict(lasso_iters=60, debias_iters=80)
PHASES = ("engine.stats", "engine.power_iteration", "engine.lasso",
          "engine.debias_solve", "engine.debias", "dsml.master")


@pytest.fixture(autouse=True)
def fresh_registry():
    obs.reset()
    yield
    obs.reset()


def _data(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((M, N, P)).astype(np.float32)
    beta = np.zeros((M, P), np.float32)
    beta[:, :3] = 1.0
    y = (np.einsum("tnp,tp->tn", X, beta)
         + 0.5 * rng.standard_normal((M, N))).astype(np.float32)
    return X, y


def _stats(X, y):
    S = np.einsum("tni,tnj->tij", X, X) / N
    c = np.einsum("tni,tn->ti", X, y) / N
    return S.astype(np.float32), c.astype(np.float32)


def _events():
    return obs.get_registry().trace_events()


def _ancestors(ev, by_id):
    out, parent = [], ev["args"]["parent"]
    while parent is not None:
        out.append(by_id[parent]["name"])
        parent = by_id[parent]["args"]["parent"]
    return out


@pytest.mark.parametrize("refit", [False, True])
def test_fit_opens_one_span_a_phase_under_the_fit(refit):
    X, y = _data()
    dsml_fit(torch.from_numpy(X), torch.from_numpy(y), LAM, MU, THR,
             refit=refit, **ITERS)
    events = _events()
    names = Counter(e["name"] for e in events)
    assert names == Counter(("dsml.fit",) + PHASES), names
    by_id = {e["args"]["id"]: e for e in events}
    (root,) = [e for e in events if e["name"] == "dsml.fit"]
    assert root["args"]["parent"] is None
    for e in events:
        if e is not root:
            assert _ancestors(e, by_id)[-1] == "dsml.fit", e["name"]
            a, b = e["ts_ns"], e["ts_ns"] + e["dur_ns"]
            assert root["ts_ns"] <= a <= b <= root["ts_ns"] + root["dur_ns"]
    # one level: every phase is a child of the root
    assert all(e["args"]["parent"] == root["args"]["id"]
               for e in events if e["name"] in PHASES)


def _solve_records(snap):
    """engine.solve.* as {(name, kind): value}: counters' totals and the
    histograms' sums."""
    return {(e["name"], e["labels"]["kind"]): e.get("value", e.get("sum"))
            for e in snap["counters"] + snap["histograms"]
            if e["name"].startswith("engine.solve.")}


def _want(solves):
    """The records the reference package's `_record_solve` makes for
    `solves`, [(kind, iterations used, ceiling)]. Its records are read
    from its code: under this jax its eager check (`_trace_clean`)
    skips every record, so its registry cannot be compared."""
    want = Counter()
    for kind, used, ceiling in solves:
        want[("engine.solve.calls", kind)] += 1
        want[("engine.solve.iters_used", kind)] += used
        want[("engine.solve.iters_ceiling", kind)] += ceiling
        if used < ceiling:
            want[("engine.solve.early_exit", kind)] += 1
    return dict(want)


def _calls():
    """name -> (the port's call, the reference's call returning its
    [(kind, iterations used, ceiling)]) on the same data."""
    X, y = _data(1)
    S, c = _stats(X, y)
    lams = np.array([0.1, 0.3, 0.9], np.float32)
    ylab = np.sign(y).astype(np.float32)
    t = torch.from_numpy
    j = jnp.asarray

    def tol_solve(kind, fn, *args, iters):
        _, used = fn(*args, iters=iters, tol=1e-3, return_iters=True)
        return [(kind, int(used), iters)]

    return {
        "dsml_fit": (
            lambda: dsml_fit(t(X), t(y), LAM, MU, THR, **ITERS),
            lambda: [("lasso_eq2", 60, 60), ("debias", 80, 80)]),
        "lasso": (
            lambda: engine.solve_lasso_batched(t(S), t(c), 0.1, iters=50),
            lambda: [("lasso", 50, 50)]),
        "lasso_tol": (
            lambda: engine.solve_lasso_batched(t(S), t(c), 0.1, iters=400,
                                               tol=1e-3),
            lambda: tol_solve("lasso", jengine.solve_lasso_batched, j(S),
                              j(c), 0.1, iters=400)),
        "lasso_eq2_tol": (
            lambda: engine.solve_lasso_eq2(t(S), t(c), LAM, iters=400,
                                           tol=1e-3),
            lambda: tol_solve("lasso_eq2", jengine.solve_lasso_eq2, j(S),
                              j(c), LAM, iters=400)),
        "lasso_grid": (
            lambda: engine.solve_lasso_grid(t(S), t(c), t(lams), iters=30),
            lambda: [("lasso_grid", 30, 30)]),
        "lasso_eq2_grid": (
            lambda: engine.solve_lasso_eq2_grid(t(S), t(c), t(lams),
                                                iters=30),
            lambda: [("lasso_eq2_grid", 30, 30)]),
        "debias_tol": (
            lambda: engine.inverse_hessian_batched(t(S), MU, iters=300,
                                                   tol=1e-3),
            lambda: tol_solve("debias", jengine.inverse_hessian_batched,
                              j(S), MU, iters=300)),
        "logistic_tol": (
            lambda: engine.solve_logistic_lasso_batched(
                t(X), t(ylab), 0.05, iters=300, tol=1e-3),
            lambda: tol_solve("logistic",
                              jengine.solve_logistic_lasso_batched, j(X),
                              j(ylab), 0.05, iters=300)),
    }


CALLS = list(_calls())


@pytest.mark.parametrize("name", CALLS)
def test_solve_records_match_the_reference(name):
    """Each entry point records one solve under the reference's `kind`,
    with the iterations the reference's own call runs on the same
    data."""
    mine, theirs = _calls()[name]
    mine()
    assert _solve_records(obs.get_registry().snapshot()) == _want(theirs())


def test_early_exit_is_recorded():
    X, y = _data(1)
    S, c = _stats(X, y)
    _, used = engine.solve_lasso_batched(
        torch.from_numpy(S), torch.from_numpy(c), 0.1, iters=400, tol=1e-3,
        return_iters=True)
    assert used < 400
    assert obs.counter_total("engine.solve.early_exit", kind="lasso") == 1
    assert obs.hist_stats("engine.solve.iters_used",
                          kind="lasso")["sum"] == used


def _routes():
    return {(c["labels"]["kernel"], c["labels"]["outcome"],
             c["labels"]["reason"], c["labels"]["blocks"]): c["value"]
            for c in obs.get_registry().snapshot()["counters"]
            if c["name"] == "dispatch.route"}


@pytest.mark.parametrize("use_kernel, reason", [(None, "backend"),
                                                (False, "use_kernel")])
def test_route_recorded_once_a_solve(use_kernel, reason):
    """The fit's three solves (the statistics, the lasso, the debias
    solve) each record the plan they settled on once, however many
    steps they launch."""
    X, y = _data()
    dsml_fit(torch.from_numpy(X), torch.from_numpy(y), LAM, MU, THR,
             use_kernel=use_kernel, **ITERS)
    assert _routes() == {
        ("rank_update", "plain", reason, "none"): 1,
        ("fista_step_batched", "plain", reason, "none"): 2}


def test_explicit_plan_is_the_recorded_plan():
    X, y = _data()
    S, c = _stats(X, y)
    engine.solve_lasso_batched(torch.from_numpy(S), torch.from_numpy(c),
                               0.1, iters=5, block=(2, 8))
    assert _routes() == {("fista_step_batched", "plain", "backend",
                          "2x8"): 1}


def test_eq2_grid_is_one_lasso_span():
    """`solve_lasso_eq2_grid` runs `solve_lasso_grid` under its own
    kind: one `engine.lasso` span (labelled with the grid's size) after
    the step-size power iteration's span, one route and one solve
    record."""
    X, y = _data()
    S, c = _stats(X, y)
    engine.solve_lasso_eq2_grid(torch.from_numpy(S), torch.from_numpy(c),
                                torch.tensor([0.1, 0.2, 0.4, 0.8]), iters=20)
    events = _events()
    (lasso,) = [e for e in events if e["name"] == "engine.lasso"]
    assert lasso["args"]["lams"] == 4 and lasso["args"]["parent"] is None
    (power,) = [e for e in events if e["name"] == "engine.power_iteration"]
    assert power["args"]["parent"] is None
    assert power["ts_ns"] + power["dur_ns"] <= lasso["ts_ns"]
    assert len(events) == 2
    assert _routes() == {("fista_step_batched", "plain", "backend",
                          "none"): 1}
    assert obs.counter_total("engine.solve.calls") == 1
    assert obs.counter_total("engine.solve.calls",
                             kind="lasso_eq2_grid") == 1


def _grid_shared():
    return {(c["labels"]["lams"], c["labels"]["passes"],
             c["labels"]["outcome"]): c["value"]
            for c in obs.get_registry().snapshot()["counters"]
            if c["name"] == "engine.grid.shared"}


@pytest.mark.parametrize("eq2", [False, True])
@pytest.mark.parametrize("k", [1, 4, 11])
def test_grid_records_its_shared_reads_once_a_solve(k, eq2):
    """A lambda grid counts `engine.grid.shared` once, with its lambdas,
    the times a step reads each Sigma (one on the plain path, whatever
    k) and the path it took; the other solves count nothing there."""
    X, y = _data()
    S, c = _stats(X, y)
    solve = engine.solve_lasso_eq2_grid if eq2 else engine.solve_lasso_grid
    solve(torch.from_numpy(S), torch.from_numpy(c),
          torch.linspace(0.05, 0.5, k), iters=5)
    assert _grid_shared() == {(k, 1, "plain"): 1}
    dsml_fit(torch.from_numpy(X), torch.from_numpy(y), LAM, MU, THR,
             **ITERS)
    assert _grid_shared() == {(k, 1, "plain"): 1}


def test_engine_adds_no_host_read(monkeypatch):
    """Without `tol=`, a fit reads nothing back from its tensors: no
    `.item()`, `.tolist()` or synchronisation, with telemetry on."""
    reads = Counter()
    for name in ("item", "tolist"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, _name=name, **k):
            reads[_name] += 1
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, counted)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a, **k: reads.update(["synchronize"]))
    X, y = _data()
    dsml_fit(torch.from_numpy(X), torch.from_numpy(y), LAM, MU, THR,
             **ITERS)
    assert obs.enabled() and _events()
    assert reads == Counter()
