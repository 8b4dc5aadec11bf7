"""The port's kernel modules against the JAX reference, on the CPU.

Each plain PyTorch version (`repro_torch/kernels/*/ref.py`) is held to the
reference's jnp oracle and to the Pallas kernel itself in interpret mode,
on the same numpy inputs, within 1e-5 absolute (the reference's own f32
parity bar). The wrappers' dispatch rules are checked too: on CPU tensors
they run the plain version and launch nothing. The CUDA kernels
themselves run only on the card (`tests/test_torch_gpu.py`,
`chip_smoke.py`).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ista_step.kernel import fista_step_batched_pallas
from repro.kernels.ista_step.ref import (
    fista_step_batched_ref as jax_fista_step_batched_ref,
    ista_step_batched_ref as jax_ista_step_batched_ref,
    ista_step_ref as jax_ista_step_ref,
)
from repro.kernels.rank_update.kernel import (
    rank_update_pallas, rank_update_unfused_pallas,
)
from repro.kernels.rank_update.ops import (
    rank_update_unfused as jax_rank_update_unfused,
)
from repro.kernels.rank_update.ref import rank_update_ref as jax_rank_update_ref
from repro_torch.kernels.common import LAUNCHES
from repro_torch.kernels.ista_step.ops import fista_step_batched
from repro_torch.kernels.ista_step.ref import (
    fista_step_batched_ref, ista_step_batched_ref, ista_step_ref,
)
from repro_torch.kernels.rank_update.ops import (
    rank_update, rank_update_unfused,
)
from repro_torch.kernels.rank_update.ref import (
    rank_c_ref, rank_sigma_ref, rank_update_ref,
)

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
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


def _rank_inputs(m, n, p, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((m, n, p)).astype(np.float32)
    y = rng.standard_normal((m, n)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (m, n)).astype(np.float32)
    return X, y, w


def _fista_inputs(m, p, r, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, 2 * p, p)).astype(np.float32)
    Sig = (np.einsum("tni,tnj->tij", A, A) / (2 * p)).astype(np.float32)
    z = (0.3 * rng.standard_normal((m, p, r))).astype(np.float32)
    x = (z + 0.1 * rng.standard_normal((m, p, r))).astype(np.float32)
    c = (0.5 * rng.standard_normal((m, p, r))).astype(np.float32)
    etas = rng.uniform(0.2, 0.4, m).astype(np.float32)
    lams = rng.uniform(0.05, 0.2, m).astype(np.float32)
    return Sig, z, x, c, etas, lams, np.float32(0.6)


# ---- rank_update ------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_rank_update_ref_matches_jax_ref(weighted):
    X, y, w = _rank_inputs(3, 40, 24)
    w_ = w if weighted else None
    S, c = rank_update_ref(_t(X), _t(y), None if w_ is None else _t(w_))
    S_j, c_j = jax_rank_update_ref(X, y, w_)
    _close(S, S_j)
    _close(c, c_j)


@pytest.mark.parametrize("weighted", [False, True])
def test_rank_update_ref_matches_pallas_interpret(weighted):
    X, y, w = _rank_inputs(2, 32, 16, seed=1)
    w_ = w if weighted else None
    S, c = rank_update_ref(_t(X), _t(y), None if w_ is None else _t(w_))
    S_k, c_k = rank_update_pallas(jnp.asarray(X), jnp.asarray(y),
                                  None if w_ is None else jnp.asarray(w_),
                                  bp=8, bn=8, interpret=True)
    _close(S, S_k)
    _close(c, c_k)


@pytest.mark.parametrize("weighted", [False, True])
def test_rank_update_unfused_matches_pallas_interpret(weighted):
    X, y, w = _rank_inputs(2, 32, 16, seed=5)
    w_ = w if weighted else None
    S, c = rank_update_unfused(_t(X), _t(y), None if w_ is None else _t(w_))
    S_k, c_k = rank_update_unfused_pallas(
        jnp.asarray(X), jnp.asarray(y),
        None if w_ is None else jnp.asarray(w_), bp=8, bn=8, interpret=True)
    _close(S, S_k)
    _close(c, c_k)


# (16, 24) routes the reference's wrapper to its two Pallas dispatches in
# interpret mode, (7, 13) is ragged and takes its oracle
@pytest.mark.parametrize("n, p", [(16, 24), (7, 13)])
def test_rank_update_unfused_matches_reference_wrapper(n, p):
    X, y, w = _rank_inputs(2, n, p, seed=6)
    for w_ in (None, w):
        S, c = rank_update_unfused(_t(X), _t(y),
                                   None if w_ is None else _t(w_))
        S_j, c_j = jax_rank_update_unfused(X, y, w_)
        _close(S, S_j)
        _close(c, c_j)


def test_rank_update_halves_are_the_fused_plain_version():
    X, y, w = _rank_inputs(2, 12, 10, seed=7)
    S, c = rank_update_ref(_t(X), _t(y), _t(w))
    assert torch.equal(rank_sigma_ref(_t(X), _t(w)), S)
    assert torch.equal(rank_c_ref(_t(X), _t(y), _t(w)), c)
    S, c = rank_update_unfused(_t(X), _t(y), _t(w), use_kernel=False)
    assert torch.equal(rank_sigma_ref(_t(X), _t(w)), S)
    assert torch.equal(rank_c_ref(_t(X), _t(y), _t(w)), c)


# ---- ista_step --------------------------------------------------------------

@pytest.mark.parametrize("r", [1, 12])
def test_fista_step_ref_matches_jax_ref(r):
    Sig, z, x, c, etas, lams, theta = _fista_inputs(3, 12, r)
    xn, zn = fista_step_batched_ref(_t(Sig), _t(z), _t(x), _t(c), _t(etas),
                                    _t(lams), theta)
    xn_j, zn_j = jax_fista_step_batched_ref(Sig, z, x, c, etas, lams, theta)
    _close(xn, xn_j)
    _close(zn, zn_j)


@pytest.mark.parametrize("r", [1, 16])
def test_fista_step_ref_matches_pallas_interpret(r):
    Sig, z, x, c, etas, lams, theta = _fista_inputs(2, 16, r, seed=2)
    xn, zn = fista_step_batched_ref(_t(Sig), _t(z), _t(x), _t(c), _t(etas),
                                    _t(lams), theta)
    xn_k, zn_k = fista_step_batched_pallas(
        jnp.asarray(Sig), jnp.asarray(z), jnp.asarray(x), jnp.asarray(c),
        jnp.asarray(etas), jnp.asarray(lams), theta, bp=8, br=8, bk=8,
        interpret=True)
    _close(xn, xn_k)
    _close(zn, zn_k)


@pytest.mark.parametrize("lam_kind", ["scalar", "per_task"])
def test_ista_step_refs_match_jax_ref(lam_kind):
    Sig, z, _, c, etas, lams, _ = _fista_inputs(3, 10, 4, seed=3)
    lam = np.float32(0.1) if lam_kind == "scalar" else lams
    lam_t = float(lam) if lam_kind == "scalar" else _t(lam)
    _close(ista_step_batched_ref(_t(Sig), _t(z), _t(c), _t(etas), lam_t),
           jax_ista_step_batched_ref(Sig, z, c, etas, lam))
    _close(ista_step_ref(_t(Sig[0]), _t(z[0]), _t(c[0]), float(etas[0]),
                         0.1),
           jax_ista_step_ref(Sig[0], z[0], c[0], etas[0], np.float32(0.1)))


# ---- dispatch ---------------------------------------------------------------

def test_cpu_tensors_run_plain_versions_and_launch_nothing():
    before = dict(LAUNCHES)
    X, y, w = _rank_inputs(2, 16, 8)
    S, c = rank_update(_t(X), _t(y), _t(w))
    S_r, c_r = rank_update_ref(_t(X), _t(y), _t(w))
    assert torch.equal(S, S_r) and torch.equal(c, c_r)
    S, c = rank_update_unfused(_t(X), _t(y), _t(w))
    assert torch.equal(S, S_r) and torch.equal(c, c_r)
    Sig, z, x, c2, etas, lams, theta = _fista_inputs(2, 8, 1)
    args = (_t(Sig), _t(z), _t(x), _t(c2), _t(etas), _t(lams), theta)
    got = fista_step_batched(*args)
    want = fista_step_batched_ref(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert dict(LAUNCHES) == before


def test_use_kernel_true_on_cpu_raises():
    X, y, _ = _rank_inputs(2, 16, 8)
    with pytest.raises(ValueError, match="CUDA"):
        rank_update(_t(X), _t(y), use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        rank_update_unfused(_t(X), _t(y), use_kernel=True)
    Sig, z, x, c, etas, lams, theta = _fista_inputs(2, 8, 1)
    with pytest.raises(ValueError, match="CUDA"):
        fista_step_batched(_t(Sig), _t(z), _t(x), _t(c), _t(etas), 0.1,
                           theta, use_kernel=True)


def test_float64_raises():
    X, y, _ = _rank_inputs(2, 16, 8)
    with pytest.raises(TypeError, match="float32"):
        rank_update(_t(X).double(), _t(y))
    with pytest.raises(TypeError, match="float32"):
        rank_update_unfused(_t(X), _t(y).double())
    Sig, z, x, c, etas, lams, theta = _fista_inputs(2, 8, 1)
    with pytest.raises(TypeError, match="float32"):
        fista_step_batched(_t(Sig).double(), _t(z), _t(x), _t(c), _t(etas),
                           0.1, theta)
    with pytest.raises(TypeError, match="float32"):
        fista_step_batched(_t(Sig), _t(z), _t(x), _t(c), _t(etas),
                           _t(lams).double(), theta)


def test_fista_step_squeezes_single_rhs_and_broadcasts_lam():
    Sig, z, x, c, etas, _, theta = _fista_inputs(3, 8, 1, seed=4)
    xn, zn = fista_step_batched(_t(Sig), _t(z[..., 0]), _t(x[..., 0]),
                                _t(c[..., 0]), _t(etas), 0.1, theta)
    xn_j, zn_j = jax_fista_step_batched_ref(Sig, z, x, c, etas,
                                            np.float32(0.1), theta)
    _close(xn, np.array(xn_j)[..., 0])
    _close(zn, np.array(zn_j)[..., 0])


def test_wrappers_reject_mismatched_shapes():
    X, y, _ = _rank_inputs(2, 16, 8)
    with pytest.raises(ValueError, match="ys"):
        rank_update(_t(X), _t(y[:, :5]))
    with pytest.raises(ValueError, match="weights"):
        rank_update_unfused(_t(X), _t(y), _t(y[:1]))
    with pytest.raises(ValueError, match=r"\(m, n, p\)"):
        rank_update_unfused(_t(X[0]), _t(y))
    Sig, z, x, c, etas, _, theta = _fista_inputs(2, 8, 3)
    with pytest.raises(ValueError, match="do not fit"):
        fista_step_batched(_t(Sig), _t(z), _t(x[:, :4]), _t(c), _t(etas),
                           0.1, theta)
