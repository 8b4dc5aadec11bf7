"""The port's multi-task sparse probe (`repro_torch.multitask`) against
the JAX reference's `repro.multitask`, on the CPU.

The backbone is the reference example's: granite-3-2b reduced by
`smoke` (2 layers, d_model 256) in float32, its parameters made by the
reference from PRNGKey(0) and carried across with
`params_from_reference`. The probing problem is the reference's
`synthetic_probe_tasks` (m 4, n 96, seq 16, 6 active dims) from
PRNGKey(1), copied with `np.array`. Held against the reference:
`pool_features` within 1e-4 · max|.|; `sparse_probe_fit` with its
default Λ (the largest gap in the row norms) and with a given Λ,
`probe_predict` and `lasso_probe_sweep` within 1e-5 with identical
supports; the sharded branch on 2 and 4 gloo ranks (`run_probe`, one
thread a rank), whose default Λ reads the fit's one all-gather (one
collective a rank). The reference `tests/test_multitask.py`'s three
dense-backbone assertions hold on the port's outputs. Its fourth case,
the mamba2 backbone (SSD layers), runs on the reference's mamba2
parameters and tasks: the port's features within 1e-4 · max|.|, its fit
within 1e-5 with the reference's support, and the reference's recovery
assertion.
"""
from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke as jax_smoke
from repro.models import init_params as jax_init_params
from repro.multitask import pool_features as jax_pool_features
from repro.multitask import probe_predict as jax_probe_predict
from repro.multitask import sparse_probe_fit as jax_sparse_probe_fit
from repro.multitask import synthetic_probe_tasks as jax_synthetic_tasks
from repro.multitask.sparse_probe import (
    lasso_probe_sweep as jax_lasso_probe_sweep,
)
from repro_torch.configs import get_config, smoke
from repro_torch.convert import from_reference, params_from_reference
from repro_torch.core import hamming, support_of
from repro_torch.models import init_params
from repro_torch.multitask import (
    ProbeData, lasso_probe_sweep, pool_features, probe_predict,
    sparse_probe_fit, synthetic_probe_tasks,
)
from repro_torch.substrate import run_probe

ATOL = 1e-5
CPU = torch.device("cpu")
F32 = dict(compute_dtype="float32", param_dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def setup():
    """(reference cfg, params, data, support, port cfg, params, data)."""
    jcfg = jax_smoke(jax_get_config("granite-3-2b")).replace(**F32)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    jdata, jsupport = jax_synthetic_tasks(jax.random.PRNGKey(1), jparams,
                                          jcfg, m=4, n=96, s_active=6)
    cfg = smoke(get_config("granite-3-2b")).replace(**F32)
    params = params_from_reference(jparams, cfg, device=CPU)
    return jcfg, jparams, jdata, jsupport, cfg, params, \
        from_reference(jdata, CPU)


@pytest.fixture(scope="module")
def fits(setup):
    """The reference's and the port's fits, default and given Λ."""
    jdata, data = setup[2], setup[6]
    return {Lam: (jax_sparse_probe_fit(jdata, Lam=Lam),
                  sparse_probe_fit(data, Lam=Lam)) for Lam in (None, 1.0)}


def _close(got: torch.Tensor, want, atol=ATOL, msg=""):
    np.testing.assert_allclose(got.numpy(), np.array(want), rtol=0,
                               atol=atol, err_msg=msg)


def test_from_reference_carries_probe_data(setup):
    jdata, data = setup[2], setup[6]
    assert isinstance(data, ProbeData)
    np.testing.assert_array_equal(data.features.numpy(),
                                  np.array(jdata.features))
    np.testing.assert_array_equal(data.targets.numpy(),
                                  np.array(jdata.targets))


def test_pool_features_matches_reference(setup):
    jcfg, jparams, _, _, cfg, params, _ = setup
    tokens = jax.random.randint(jax.random.PRNGKey(5), (8, 16), 0,
                                jcfg.vocab)
    want = np.array(jax_pool_features(jparams, jcfg, tokens))
    got = pool_features(params, cfg, torch.from_numpy(np.array(tokens)))
    assert got.dtype == torch.float32 and got.shape == (8, cfg.d_model)
    _close(got, want, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("Lam", [None, 1.0])
def test_sparse_probe_fit_matches_reference(fits, Lam):
    want, got = fits[Lam]
    for name in ("beta_tilde", "beta_u", "beta_local"):
        _close(getattr(got, name), getattr(want, name), msg=name)
    np.testing.assert_array_equal(got.support.numpy(),
                                  np.array(want.support))


def test_probe_predict_matches_reference(setup, fits):
    jdata, data = setup[2], setup[6]
    want, got = fits[None]
    _close(probe_predict(got, data.features),
           jax_probe_predict(want, jdata.features))


def test_lasso_probe_sweep_matches_reference(setup):
    jdata, data = setup[2], setup[6]
    lams = np.array([0.05, 0.1, 0.2], np.float32)
    want = jax_lasso_probe_sweep(jdata, jax.numpy.asarray(lams), iters=200)
    got = lasso_probe_sweep(data, torch.from_numpy(lams), iters=200)
    assert got.shape == (3, 4, 256)
    _close(got, want)


# ---- the reference tests/test_multitask.py's dense cases, on the port ----

def test_probe_recovers_active_features(setup, fits):
    cfg, support = setup[4], from_reference(setup[3], CPU)
    res = fits[None][1]
    assert int(torch.sum(res.support & support)) == int(support.sum())
    assert int(res.support.sum()) < cfg.d_model // 4


def test_probe_predictions_fit(setup, fits):
    data = setup[6]
    pred = probe_predict(fits[None][1], data.features)
    r2 = 1 - float(torch.var(pred - data.targets, correction=0)
                   / torch.var(data.targets, correction=0))
    assert r2 > 0.8


def test_probe_beats_dense_local_ridge_on_support(setup, fits):
    support = from_reference(setup[3], CPU)
    res = fits[None][1]
    local_sup = support_of(res.beta_local.T, 1e-3)
    assert int(hamming(res.support, support)) <= \
        int(hamming(local_sup, support))


def test_probe_on_ssm_backbone():
    """The reference's `test_probe_works_on_ssm_backbone`, against the
    reference: mamba2's smoke backbone in f32, the same tokens."""
    jcfg = jax_smoke(jax_get_config("mamba2-1.3b")).replace(**F32)
    jparams = jax_init_params(jax.random.PRNGKey(0), jcfg)
    key = jax.random.PRNGKey(1)
    jdata, jsupport = jax_synthetic_tasks(key, jparams, jcfg, m=4, n=96,
                                          s_active=6)
    # the tokens `synthetic_probe_tasks` drew (its first key)
    tokens = np.array(jax.random.randint(jax.random.split(key, 4)[0],
                                         (4, 96, 16), 0, jcfg.vocab))
    cfg = smoke(get_config("mamba2-1.3b")).replace(**F32)
    params = params_from_reference(jparams, cfg, device=CPU)
    feats = torch.stack([pool_features(params, cfg, torch.from_numpy(t))
                         for t in tokens])
    want = np.array(jdata.features)
    assert float(np.max(np.abs(feats.numpy() - want))) <= \
        1e-4 * float(np.max(np.abs(want)))
    res = sparse_probe_fit(from_reference(jdata, CPU))
    jres = jax_sparse_probe_fit(jdata)
    assert torch.equal(res.support, torch.from_numpy(np.array(jres.support)))
    _close(res.beta_tilde, jres.beta_tilde)
    support = from_reference(jsupport, CPU)
    assert int((res.support & support).sum()) >= int(support.sum()) - 1


def test_synthetic_probe_tasks_draws_from_its_generator(setup):
    """The port's own `synthetic_probe_tasks`: shapes, the active count,
    and the same draws from the same seed."""
    cfg, params = setup[4], setup[5]

    def draw():
        return synthetic_probe_tasks(torch.Generator().manual_seed(1),
                                     params, cfg, m=2, n=8, s_active=6)

    (data, support), (again, support2) = draw(), draw()
    assert data.features.shape == (2, 8, cfg.d_model)
    assert data.features.dtype == torch.float32
    assert data.targets.shape == (2, 8)
    assert int(support.sum()) == 6
    assert torch.equal(data.features, again.features)
    assert torch.equal(data.targets, again.targets)
    assert torch.equal(support, support2)


def test_multitask_probes_launcher_runs_on_cpu(capsys):
    from repro_torch.launch.multitask_probes import main
    res, r2 = main(["--device", "cpu"])
    assert torch.isfinite(res.beta_tilde).all() and 0 < r2 <= 1
    assert "recovered support:" in capsys.readouterr().out


def test_probe_fit_on_port_backbone_params(setup):
    """End to end in the port: its own parameters (seeded generator),
    features and fit, finite, with a sparse support."""
    cfg = setup[4]
    params = init_params(torch.Generator().manual_seed(0), cfg)
    data, _ = synthetic_probe_tasks(torch.Generator().manual_seed(1),
                                    params, cfg, m=4, n=96, s_active=6)
    res = sparse_probe_fit(data, lasso_iters=100, debias_iters=100)
    assert torch.isfinite(res.beta_tilde).all()
    assert 0 < int(res.support.sum()) < cfg.d_model // 4


# ---- the sharded branch on gloo ranks ----------------------------------

_SHARDED = r"""
import json
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.multitask import ProbeData, sparse_probe_fit
from repro_torch.substrate import init_from_env, task_mesh
from repro_torch.testing import count_collectives

rank, world = init_from_env()
d = np.load({path!r})
ml = d["features"].shape[0] // world
rows = slice(rank * ml, (rank + 1) * ml)
data = ProbeData(torch.from_numpy(d["features"][rows].copy()),
                 torch.from_numpy(d["targets"][rows].copy()))
mesh = task_mesh()
with count_collectives() as calls:
    res = sparse_probe_fit(data, mesh=mesh)
np.savez({out!r} + f"/rank{{rank}}.npz",
         **{{k: v.numpy() for k, v in res._asdict().items()}})
print("RESULT " + json.dumps({{"calls": dict(calls)}}))
"""


@pytest.mark.parametrize("world", [2, 4])
def test_sparse_probe_fit_sharded_matches_reference(setup, fits, world,
                                                    tmp_path):
    """Every rank's rows and the support (default Λ from the gathered
    rows) against the reference's fit; one collective a rank."""
    jdata = setup[2]
    np.savez(tmp_path / "probe.npz", features=np.array(jdata.features),
             targets=np.array(jdata.targets))
    run = run_probe(_SHARDED.format(path=str(tmp_path / "probe.npz"),
                                    out=str(tmp_path)),
                    world=world, timeout=120, pg_timeout=60)
    assert run.ok, run.report()
    want = fits[None][0]
    ml = 4 // world
    for rank, r in enumerate(run.ranks):
        line = [s for s in r.stdout.splitlines() if s.startswith("RESULT ")]
        assert sum(json.loads(line[0][7:])["calls"].values()) == 1
        got = np.load(tmp_path / f"rank{rank}.npz")
        rows = slice(rank * ml, (rank + 1) * ml)
        for name in ("beta_tilde", "beta_u", "beta_local"):
            np.testing.assert_allclose(got[name],
                                       np.array(getattr(want, name))[rows],
                                       rtol=0, atol=ATOL, err_msg=name)
        np.testing.assert_array_equal(got["support"], np.array(want.support))
