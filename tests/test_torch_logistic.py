"""The port's Section-4 logistic path against the JAX reference, on the CPU.

The same numpy inputs go through the reference function and its
counterpart in the port:

* the plain logistic-gradient functions (`repro_torch/kernels/
  logistic_grad/ref.py`) against the reference's jnp oracle and against
  its Pallas kernels in interpret mode, in both layouts (resident bp = p
  and feature-tiled bp < p), within 1e-5 * max|reference| per output;
* every solver and entry point of `repro_torch/core/logistic.py` and
  `solve_logistic_lasso_batched` within 1e-5 absolute;
* `dsml_logistic_fit` at the statistical tier's regime (m=10, n=350,
  p=200, s=10, 400/400 iterations) and at a small ragged shape, with
  identical supports. Outputs are compared with the reference's outputs,
  never with its golden bands.

The wrappers' dispatch rules and the fused kernel's launch plan (plain
Python) are checked too; the CUDA kernels themselves run only on the card
(`tests/test_torch_gpu.py`, `chip_smoke.py`).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import logistic as jlogistic
from repro.core import metrics as jmetrics
from repro.core import prox as jprox
from repro.core import synth as jsynth
from repro.kernels.logistic_grad.kernel import (
    logistic_grad_pallas, logistic_grad_unfused_pallas,
)
from repro.kernels.logistic_grad.ref import (
    logistic_grad_ref as jax_logistic_grad_ref,
)
from repro_torch.convert import from_reference
from repro_torch.core import engine, logistic, metrics, prox, synth
from repro_torch.kernels.common import LAUNCHES
from repro_torch.kernels.logistic_grad import ops
from repro_torch.kernels.logistic_grad.ref import (
    logistic_backproject_ref, logistic_grad_ref, logistic_residual_ref,
    logistic_z_ref,
)

ATOL = 1e-5
H100 = dict(sms=132, smem_optin=232448)    # the card's SMs and opt-in bytes


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


def _close_rel(got: torch.Tensor, want):
    """max |got - want| <= 1e-5 * max |want|, the kernel bar."""
    want = np.array(want)
    assert tuple(got.shape) == want.shape
    err = np.max(np.abs(got.numpy() - want))
    assert err <= ATOL * np.max(np.abs(want)), err


def _grad_inputs(m, n, p, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((m, n, p)).astype(np.float32)
    y = np.where(rng.uniform(size=(m, n)) < 0.5, 1.0, -1.0).astype(np.float32)
    B = (0.2 * rng.standard_normal((m, p))).astype(np.float32)
    return X, y, B


@pytest.fixture(scope="module")
def data():
    """The reference's own classification data at a small size, as numpy
    arrays."""
    d = jsynth.gen_classification(jax.random.PRNGKey(1), m=4, n=60, p=32,
                                  s=4)
    return np.array(d.Xs), np.array(d.ys)


# ---- kernel functions -------------------------------------------------------

@pytest.mark.parametrize("m, n, p", [(3, 40, 24), (1, 7, 13)])
def test_logistic_grad_ref_matches_jax_ref(m, n, p):
    X, y, B = _grad_inputs(m, n, p)
    _close_rel(logistic_grad_ref(_t(X), _t(y), _t(B)),
               jax_logistic_grad_ref(X, y, B))


@pytest.mark.parametrize("bp", [None, 16], ids=["resident", "tiled"])
def test_logistic_grad_ref_matches_pallas_interpret(bp):
    X, y, B = _grad_inputs(3, 64, 64, seed=1)
    want = logistic_grad_pallas(jnp.asarray(X), jnp.asarray(y),
                                jnp.asarray(B), bn=16, bp=bp,
                                interpret=True)
    _close_rel(logistic_grad_ref(_t(X), _t(y), _t(B)), want)


@pytest.mark.parametrize("bp", [None, 16], ids=["resident", "tiled"])
def test_unfused_plain_versions_match_pallas_interpret(bp):
    X, y, B = _grad_inputs(3, 64, 64, seed=2)
    want = logistic_grad_unfused_pallas(jnp.asarray(X), jnp.asarray(y),
                                        jnp.asarray(B), bn=16, bp=bp,
                                        interpret=True)
    _close_rel(ops.logistic_grad_unfused(_t(X), _t(y), _t(B)), want)
    z = logistic_z_ref(_t(X), _t(B))
    _close_rel(z, jnp.einsum("tnp,tp->tn", X, B))
    r = _t(y) * torch.sigmoid(-_t(y) * z)
    _close_rel(logistic_backproject_ref(_t(X), r), want)


@pytest.mark.parametrize("m, n, p", [(3, 40, 24), (2, 64, 64), (1, 7, 13)])
def test_unfused_first_half_matches_jax(m, n, p):
    """The plain version of the first unfused kernel: z = X b and the
    residual it returns, against the same two steps in JAX on the same
    numpy inputs."""
    X, y, B = _grad_inputs(m, n, p, seed=3)
    z_want = jnp.matmul(jnp.asarray(X), jnp.asarray(B)[..., None])[..., 0]
    r_want = y * jax.nn.sigmoid(-y * z_want)
    _close_rel(logistic_z_ref(_t(X), _t(B)), z_want)
    _close(logistic_residual_ref(_t(X), _t(y), _t(B)), r_want)
    # and the back-projection of that residual is the whole gradient
    _close_rel(logistic_backproject_ref(
        _t(X), logistic_residual_ref(_t(X), _t(y), _t(B))),
        jax_logistic_grad_ref(X, y, B))


# ---- the unfused pair's launch plan -----------------------------------------

def _unfused_counts(m: int, n: int, p: int, pl) -> tuple[np.ndarray,
                                                         np.ndarray]:
    """How often the two kernels of one task read each (row, vector) of X
    (p / 4 float4 per row where p % 4 == 0, else p floats), as their
    index maps take them: (forward, back-projection), each (n, width)."""
    width = p // 4 if p % 4 == 0 else p
    fwd = np.zeros((n, width), dtype=np.int64)
    wpr = pl.warps_per_row
    for b in range(pl.z_blocks // m):
        for w in range(ops.UNFUSED_WARPS):
            row0 = (b * (ops.UNFUSED_WARPS // wpr) + w // wpr) \
                * pl.rows_per_warp
            for row in range(row0, min(n, row0 + pl.rows_per_warp)):
                for lane in range(32):
                    fwd[row, 32 * (w % wpr) + lane::32 * wpr] += 1
    back = np.zeros((n, width), dtype=np.int64)
    cv = pl.cols // 4 if p % 4 == 0 else pl.cols
    groups = 256 // cv
    for b in range(pl.bp_blocks // m):
        for tid in range(256):
            q = b * cv + tid % cv
            if q < width:
                back[tid // cv::groups, q] += 1
    return fwd, back


@pytest.mark.parametrize("m, n, p", [
    (16, 512, 1024), (4, 256, 8192), (3, 500, 1000), (2, 7, 129),
    (1, 1, 1), (10, 350, 200),
])
def test_unfused_plan_covers_every_sample_and_column_once(m, n, p):
    pl = ops.unfused_plan(m, n, p, H100["sms"])
    assert (pl.rows_per_warp, pl.warps_per_row) in ops.UNFUSED_Z_PLANS
    assert pl.rows_per_block * pl.warps_per_row == \
        ops.UNFUSED_WARPS * pl.rows_per_warp
    assert pl.z_blocks == m * -(-n // pl.rows_per_block)
    assert pl.cols in ops.UNFUSED_COLS
    assert pl.bp_blocks == m * -(-p // pl.cols)
    fwd, back = _unfused_counts(m, n, p, pl)
    assert np.all(fwd == 1) and np.all(back == 1)


def test_unfused_plan_fills_the_card_at_both_shapes():
    """One warp a row gives 128 blocks at (4, 256, 8192), and 128-float
    column slices 128 blocks at (16, 512, 1024): the plan gives both
    kernels at least two blocks an SM at both shapes."""
    want = ops.UNFUSED_BLOCKS_PER_SM * H100["sms"]
    main = ops.unfused_plan(16, 512, 1024, H100["sms"])
    assert main == ops.UnfusedPlan(rows_per_warp=2, warps_per_row=1,
                                   rows_per_block=16, z_blocks=512, cols=32,
                                   bp_blocks=512)
    largep = ops.unfused_plan(4, 256, 8192, H100["sms"])
    assert largep == ops.UnfusedPlan(rows_per_warp=1, warps_per_row=4,
                                     rows_per_block=2, z_blocks=512, cols=64,
                                     bp_blocks=512)
    for pl in (main, largep):
        assert pl.z_blocks >= want and pl.bp_blocks >= want


# ---- the fused kernel's launch plan -------------------------------------------

@pytest.mark.parametrize("m, n, p", [
    (16, 512, 1024), (4, 256, 8192), (3, 500, 1000), (2, 7, 129),
    (1, 1, 1), (4, 256, 19328), (4, 256, 19329), (10, 350, 200),
])
def test_plan_covers_every_sample_and_fits_the_card(m, n, p):
    pl = ops.plan(m, n, p, **H100)
    assert pl.chunks >= 1 and pl.rows_per_chunk >= 1
    # every sample in exactly one chunk, no chunk empty
    assert pl.chunks * pl.rows_per_chunk >= n
    assert (pl.chunks - 1) * pl.rows_per_chunk < n
    assert 1 <= pl.slab <= ops.SLAB_MAX
    assert pl.chunks * 4 * p <= max(ops.TAIL_BYTES, 4 * p)
    if pl.smem_bytes:
        assert pl.slab <= pl.rows_per_chunk
        assert pl.smem_bytes == (pl.slab + 2) * 4 * p
        assert pl.smem_bytes + 512 <= H100["smem_optin"]


def test_plan_main_path_shapes_and_where_x_is_read_twice():
    main = ops.plan(16, 512, 1024, **H100)
    assert main == ops.Plan(chunks=17, rows_per_chunk=31, slab=8,
                            smem_bytes=40960)
    largep = ops.plan(4, 256, 8192, **H100)
    assert largep == ops.Plan(chunks=16, rows_per_chunk=16, slab=5,
                              smem_bytes=229376)
    # one row, b and the accumulator fit up to p = 19,328 on the H100
    assert ops.plan(4, 256, 19328, **H100).smem_bytes > 0
    assert ops.plan(4, 256, 19329, **H100).smem_bytes == 0


# ---- the solver ---------------------------------------------------------------

@pytest.mark.parametrize("variant", ["default", "per_task_lam", "beta0",
                                     "mask_no_momentum", "group_grad_scale"])
def test_solve_logistic_lasso_batched_matches_reference(data, variant):
    X, y = data
    m, n, p = X.shape
    rng = np.random.default_rng(3)
    lam = np.float32(0.05)
    kw, kw_t = {}, {}
    if variant == "per_task_lam":
        lam = rng.uniform(0.02, 0.1, m).astype(np.float32)
    elif variant == "beta0":
        kw["beta0"] = (0.1 * rng.standard_normal((m, p))).astype(np.float32)
        kw_t["beta0"] = _t(kw["beta0"])
    elif variant == "mask_no_momentum":
        d = (rng.uniform(size=p) < 0.5).astype(np.float32)
        kw.update(momentum=False, prox=lambda V, _: V * d[None, :])
        kw_t.update(momentum=False, prox=lambda V, _: V * _t(d)[None, :])
    elif variant == "group_grad_scale":
        etas = np.full(m, 0.8, np.float32)
        kw.update(etas=etas, grad_scale=1.0 / m, prox=lambda V, s:
                  jprox.group_soft_threshold(V.T, s[0, 0] * 0.05).T)
        kw_t.update(etas=_t(etas), grad_scale=1.0 / m, prox=lambda V, s:
                    prox.group_soft_threshold(V.T, s[0, 0] * 0.05).T)
    lam_t = _t(lam) if np.ndim(lam) else float(lam)
    got = engine.solve_logistic_lasso_batched(_t(X), _t(y), lam_t,
                                              iters=150, **kw_t)
    want = jengine.solve_logistic_lasso_batched(X, y, lam, iters=150, **kw)
    _close(got, want)


def test_solve_logistic_lasso_tol_counts_iterations_like_reference(data):
    X, y = data
    got, n_got = engine.solve_logistic_lasso_batched(
        _t(X), _t(y), 0.05, iters=600, tol=1e-4, check_every=25,
        return_iters=True)
    want, n_want = jengine.solve_logistic_lasso_batched(
        X, y, 0.05, iters=600, tol=1e-4, check_every=25, return_iters=True)
    assert n_got == int(n_want)
    assert n_got < 600
    _close(got, want)


# ---- core/logistic.py -------------------------------------------------------

def test_logistic_lasso_and_debias_logistic_match_reference(data):
    X, y = data
    b = logistic.logistic_lasso(_t(X[0]), _t(y[0]), 0.05, iters=300)
    b_j = jlogistic.logistic_lasso(X[0], y[0], 0.05, iters=300)
    _close(b, b_j)
    _close(logistic.debias_logistic(_t(X[0]), _t(y[0]), b, 0.2, iters=300),
           jlogistic.debias_logistic(X[0], y[0], b_j, 0.2, iters=300))


@pytest.mark.parametrize("start", ["cold", "warm", "warm_valid",
                                   "warm_invalid"])
def test_debias_logistic_batched_matches_reference(data, start):
    X, y = data
    beta = np.array(jengine.solve_logistic_lasso_batched(X, y, 0.05,
                                                         iters=200))
    kw, kw_t = {}, {}
    if start != "cold":
        _, M0 = jlogistic.debias_logistic_batched(X, y, beta, 0.2, iters=50)
        kw["M0"] = M0
        kw_t["M0"] = from_reference(M0, "cpu")
    if start in ("warm_valid", "warm_invalid"):
        valid = start == "warm_valid"
        kw["M0_valid"] = jnp.asarray(valid)
        kw_t["M0_valid"] = torch.tensor(valid)
    bu, Ms = logistic.debias_logistic_batched(_t(X), _t(y), _t(beta), 0.2,
                                              iters=300, **kw_t)
    bu_j, Ms_j = jlogistic.debias_logistic_batched(X, y, beta, 0.2,
                                                   iters=300, **kw)
    _close(bu, bu_j)
    # the M entries reach about 7 here (the inverse of a Hessian whose
    # weights are at most 1/4), so they are held to 1e-5 of their scale:
    # measured 1.3e-5 absolute, 1.7e-6 relative
    _close_rel(Ms, Ms_j)


@pytest.mark.parametrize("name", ["group_logistic_lasso", "icap_logistic"])
def test_multitask_baselines_match_reference(data, name):
    X, y = data
    got = getattr(logistic, name)(_t(X), _t(y), 0.05, iters=300)
    want = getattr(jlogistic, name)(X, y, 0.05, iters=300)
    _close(got, want)


def test_refit_logistic_masked_matches_reference(data):
    X, y = data
    support = np.zeros(X.shape[-1], bool)
    support[[0, 3, 7, 20]] = True
    _close(logistic.refit_logistic_masked(_t(X[2]), _t(y[2]),
                                          _t(support), steps=150),
           jlogistic.refit_logistic_masked(X[2], y[2], support, steps=150))


@pytest.mark.parametrize("m, n, p, s, Lam", [(10, 350, 200, 10, 0.75),
                                             (3, 40, 44, 4, 0.3)])
def test_dsml_logistic_fit_matches_reference(m, n, p, s, Lam):
    # measured on a CPU: beta_local 2.7e-7 and beta_u 6.0e-7 at the
    # statistical regime, both under the 1e-5 bar
    d = jsynth.gen_classification(jax.random.PRNGKey(0), m=m, n=n, p=p, s=s)
    lam = float(np.sqrt(np.log(p) / n))
    mu = 2.0 * lam
    want = jlogistic.dsml_logistic_fit(d.Xs, d.ys, lam, mu, Lam,
                                       lasso_iters=400, debias_iters=400)
    td = from_reference(d, "cpu")
    got = logistic.dsml_logistic_fit(td.Xs, td.ys, lam, mu, Lam, 400, 400)
    assert isinstance(got, logistic.DsmlLogisticResult)
    assert np.array_equal(got.support.numpy(), np.array(want.support))
    assert 0 < int(got.support.sum()) < p
    for name in ("beta_tilde", "beta_u", "beta_local"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.array(getattr(want, name)),
                                   rtol=0, atol=ATOL, err_msg=name)


# ---- synth and metrics ------------------------------------------------------

def test_gen_classification_shapes_labels_and_support():
    a = synth.gen_classification(5, m=3, n=50, p=30, s=6, device="cpu")
    b = synth.gen_classification(torch.Generator().manual_seed(5), m=3,
                                 n=50, p=30, s=6, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a.Xs.shape == (3, 50, 30) and a.ys.shape == (3, 50)
    assert a.B.shape == (30, 3) and a.Sigma.shape == (30, 30)
    assert a.Xs.dtype == torch.float32 and a.ys.dtype == torch.float32
    assert set(torch.unique(a.ys).tolist()) <= {-1.0, 1.0}
    assert int(a.support.sum()) == 6
    assert torch.equal(metrics.support_of(a.B), a.support)
    assert 0.0 <= float(a.B.min()) and float(a.B.max()) <= 2.0
    # labels follow the logits: most agree in sign where |logit| is large
    logits = torch.einsum("tnp,pt->tn", a.Xs, a.B)
    big = torch.abs(logits) > 2.0
    agree = (torch.sign(logits) == a.ys)[big].float().mean()
    assert float(agree) > 0.8


def test_classification_error_matches_reference():
    rng = np.random.default_rng(6)
    X = rng.standard_normal((3, 40, 12)).astype(np.float32)
    y = np.where(rng.uniform(size=(3, 40)) < 0.5, 1.0, -1.0).astype(
        np.float32)
    B = rng.standard_normal((12, 3)).astype(np.float32)
    got = metrics.classification_error(_t(B), _t(X), _t(y))
    assert got.dtype == torch.float32
    _close(got, jmetrics.classification_error(B, X, y))


# ---- dispatch and conversion ------------------------------------------------

def test_cpu_tensors_run_plain_versions_and_launch_nothing(data):
    X, y = data
    before = dict(LAUNCHES)
    B = torch.zeros(X.shape[0], X.shape[2])
    assert torch.equal(ops.logistic_grad(_t(X), _t(y), B),
                       logistic_grad_ref(_t(X), _t(y), B))
    ops.logistic_grad_unfused(_t(X), _t(y), B)
    logistic.dsml_logistic_fit(_t(X), _t(y), 0.05, 0.2, 0.5, 5, 5)
    assert dict(LAUNCHES) == before


@pytest.mark.parametrize("fn", [ops.logistic_grad, ops.logistic_grad_unfused])
def test_logistic_wrappers_reject_bad_calls(fn):
    X, y, B = (_t(a) for a in _grad_inputs(2, 16, 8))
    with pytest.raises(ValueError, match="CUDA"):
        fn(X, y, B, use_kernel=True)
    with pytest.raises(TypeError, match="float32"):
        fn(X.double(), y, B)
    with pytest.raises(TypeError, match="float32"):
        fn(X, y, B.double())
    with pytest.raises(ValueError, match="ys"):
        fn(X, y[:, :5], B)
    with pytest.raises(ValueError, match="B"):
        fn(X, y, B[:, :5])
    with pytest.raises(ValueError, match="Xs"):
        fn(X[0], y, B)


def test_from_reference_carries_a_logistic_result():
    res = jlogistic.DsmlLogisticResult(
        *(jnp.ones((2, 6)) for _ in range(2)), jnp.array([True] * 6),
        jnp.zeros((2, 6)))
    got = from_reference(res, "cpu")
    assert isinstance(got, logistic.DsmlLogisticResult)
    assert got.support.dtype == torch.bool
    assert torch.equal(got.beta_u, torch.ones(2, 6))
