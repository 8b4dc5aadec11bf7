"""The port's sharded DSML fit (`repro_torch.core.dsml_fit_sharded`) on
`torch.distributed` against the JAX reference, on the CPU.

Each world size runs as that many gloo ranks (`repro_torch.substrate.
run_probe`, one thread each, a 120 s limit and a 60 s process-group
timeout), on the reference's `tests/test_distributed.py` data (m = 8,
n = 60, p = 100, s = 5, 200 + 200 iterations) built by the reference
and handed over as numpy arrays. Every rank's rows and the replicated
support are held against the reference's `dsml_fit` and its
`dsml_fit_sharded` on a 1-device mesh: within 1e-5, identical supports.

The paper's one round is counted two ways on every rank, standing in
for the reference's HLO probe (`benchmarks/communication.py::
verify_one_round`, a benchmark folder not ported): the byte ledger
(`collective.calls`, `collective.bytes`) and a wrap of
`torch.distributed`'s own functions (`repro_torch.testing.
count_collectives`). Both must show exactly one all-gather, and the
ledger's bytes the reference's model: participants x local nbytes.
"""
from __future__ import annotations

import json

import jax
import numpy as np
import pytest

from repro.core import dsml_fit as jax_dsml_fit
from repro.core import dsml_fit_sharded as jax_dsml_fit_sharded
from repro.core import gen_regression as jax_gen_regression
from repro_torch.substrate import run_probe

M, N, P, S = 8, 60, 100, 5
LAM, MU, THR = 0.4, 0.2, 1.0
ITERS = dict(lasso_iters=200, debias_iters=200)
ATOL = 1e-5

_PAYLOAD = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch import obs
from repro_torch.core import dsml_fit_sharded
from repro_torch.substrate import init_from_env, task_mesh
from repro_torch.testing import count_collectives

rank, world = init_from_env()
mesh = task_mesh()
d = np.load(sys.argv[1] if len(sys.argv) > 1 else {path!r})
ml = d["Xs"].shape[0] // world
rows = slice(rank * ml, (rank + 1) * ml)
X = torch.from_numpy(d["Xs"][rows].copy())
y = torch.from_numpy(d["ys"][rows].copy())
obs.reset()
with count_collectives() as calls:
    res = dsml_fit_sharded(X, y, {lam}, {mu}, {thr}, mesh,
                           lasso_iters={li}, debias_iters={di})
np.savez({out!r} + f"/rank{{rank}}.npz",
         **{{k: v.numpy() for k, v in res._asdict().items()}})
events = obs.get_registry().trace_events()
names = {{e["args"]["id"]: e["name"] for e in events}}
spans = {{}}
for e in events:
    spans[e["name"]] = spans.get(e["name"], 0) + 1
print("RESULT " + json.dumps({{
    "spans": spans,
    "span_parents": sorted({{(e["name"], names.get(e["args"]["parent"]))
                            for e in events}}),
    "rank": rank, "world": world, "calls": dict(calls),
    "ledger_calls": obs.counter_total("collective.calls"),
    "gather_calls": obs.counter_total("collective.calls",
                                      op="all_gather_tasks", axis="task"),
    "gather_bytes": obs.counter_total("collective.bytes",
                                      op="all_gather_tasks", axis="task"),
    "local_nbytes": res.beta_u.numel() * res.beta_u.element_size()}}))
"""


def _reference():
    data = jax_gen_regression(jax.random.PRNGKey(1), m=M, n=N, p=P, s=S)
    ref = jax_dsml_fit(data.Xs, data.ys, LAM, MU, THR, **ITERS)
    mesh = jax.make_mesh((1,), ("task",))
    shd = jax_dsml_fit_sharded(data.Xs, data.ys, LAM, MU, THR, mesh,
                               **ITERS)
    return data, ref, shd


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    data, ref, shd = _reference()
    path = tmp_path_factory.mktemp("sharded") / "data.npz"
    np.savez(path, Xs=np.array(data.Xs), ys=np.array(data.ys))
    return str(path), ref, shd


@pytest.fixture(scope="module", params=[1, 2, 4, 8])
def world_run(request, reference, tmp_path_factory):
    """Run the sharded fit as `world` gloo ranks; returns (world, each
    rank's JSON line, each rank's arrays)."""
    world = request.param
    path, _, _ = reference
    out = tmp_path_factory.mktemp(f"world{world}")
    payload = _PAYLOAD.format(path=path, out=str(out), lam=LAM, mu=MU,
                              thr=THR, li=ITERS["lasso_iters"],
                              di=ITERS["debias_iters"])
    run = run_probe(payload, world=world, timeout=120, pg_timeout=60)
    assert run.ok, run.report()
    lines = []
    for r in run.ranks:
        line = [s for s in r.stdout.splitlines() if s.startswith("RESULT ")]
        assert len(line) == 1, r.stdout
        lines.append(json.loads(line[0][len("RESULT "):]))
    arrays = [dict(np.load(out / f"rank{i}.npz")) for i in range(world)]
    return world, lines, arrays


def test_sharded_fit_matches_reference(world_run, reference):
    world, _, arrays = world_run
    _, ref, shd = reference
    ml = M // world
    for rank, got in enumerate(arrays):
        rows = slice(rank * ml, (rank + 1) * ml)
        for want in (ref, shd):
            for name in ("beta_tilde", "beta_u", "beta_local"):
                np.testing.assert_allclose(
                    got[name], np.array(getattr(want, name))[rows], rtol=0,
                    atol=ATOL, err_msg=f"rank {rank} {name}")
            np.testing.assert_array_equal(got["support"],
                                          np.array(want.support))
            np.testing.assert_allclose(got["beta_u_all"],
                                       np.array(want.beta_u), rtol=0,
                                       atol=ATOL)


def test_sharded_fit_ranks_agree_on_the_gathered_rows(world_run):
    _, _, arrays = world_run
    for got in arrays[1:]:
        np.testing.assert_array_equal(got["support"], arrays[0]["support"])
        np.testing.assert_array_equal(got["beta_u_all"],
                                      arrays[0]["beta_u_all"])


def test_sharded_fit_is_one_collective_per_rank(world_run):
    """One all-gather a fit on every rank, by the ledger and by the
    wrapped `torch.distributed` functions."""
    _, lines, _ = world_run
    for line in lines:
        assert sum(line["calls"].values()) == 1, line
        assert set(line["calls"]) <= {"all_gather_single",
                                      "all_gather_into_tensor"}, line
        assert line["ledger_calls"] == 1, line
        assert line["gather_calls"] == 1, line


def test_sharded_fit_spans_one_allgather_per_rank(world_run):
    """Every rank's fit is one `dsml.fit_sharded` span holding one
    `dsml.allgather` (the round) and one `dsml.master` span."""
    _, lines, _ = world_run
    for line in lines:
        spans = line["spans"]
        assert spans["dsml.fit_sharded"] == spans["dsml.allgather"] \
            == spans["dsml.master"] == 1, line
        parents = {tuple(p) for p in line["span_parents"]}
        assert ("dsml.allgather", "dsml.fit_sharded") in parents, line
        assert ("dsml.master", "dsml.fit_sharded") in parents, line
        assert ("dsml.fit_sharded", None) in parents, line


def test_sharded_fit_ledger_bytes_follow_reference_model(world_run):
    """bytes = participants x local nbytes, (m_local, p) f32 a rank."""
    world, lines, _ = world_run
    for line in lines:
        assert line["local_nbytes"] == (M // world) * P * 4
        assert line["gather_bytes"] == world * line["local_nbytes"]
