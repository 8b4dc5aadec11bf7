"""The port's group hard threshold (`repro_torch.kernels.group_threshold`)
against the JAX reference, on the CPU, and as the master step of a small
`dsml_fit`.

The reference's wrapper runs its Pallas body in interpret mode where p is
a multiple of 8 and its oracle elsewhere. The port's plain version takes
the Pallas body's comparison, sum of squares > Lambda^2; on these inputs
no row norm lies within rounding of Lambda, so the keep masks are
identical and the filtered rows equal. bf16 is held to the reference
within bf16's rounding (the kept entries are copied, so in fact exactly).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.synth import gen_regression as jax_gen_regression
from repro.kernels.group_threshold.ops import (
    group_threshold as jax_group_threshold,
)
from repro_torch.convert import from_reference
from repro_torch.core.dsml import dsml_fit
from repro_torch.kernels.common import LAUNCHES
from repro_torch.kernels.group_threshold.ops import (
    VECTOR, group_threshold, row_lanes, row_vectors,
)
from repro_torch.kernels.group_threshold.ref import group_threshold_ref


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _rows(p, m, seed=0):
    """Rows whose norms spread around 1, none within 1e-5 (about a
    hundred ulps) of the thresholds used below."""
    rng = np.random.default_rng(seed)
    B = rng.standard_normal((p, m)).astype(np.float32)
    B *= rng.uniform(0.1, 2.0, (p, 1)).astype(np.float32) / np.sqrt(m)
    norms = np.linalg.norm(B, axis=1)
    for Lam in (0.5, 0.8):
        assert np.min(np.abs(norms - Lam)) > 1e-5
    return B


# (64, 4) and (256, 16) take the reference's Pallas body in interpret
# mode; (61, 3) is ragged and takes its oracle
@pytest.mark.parametrize("p, m", [(64, 4), (256, 16), (61, 3)])
@pytest.mark.parametrize("Lam", [0.5, 0.8])
def test_group_threshold_matches_reference(p, m, Lam):
    B = _rows(p, m, seed=p + m)
    out, keep = group_threshold(torch.from_numpy(B), Lam)
    out_j, keep_j = jax_group_threshold(B, Lam)
    assert keep.dtype == torch.bool and keep.shape == (p,)
    assert np.array_equal(keep.numpy(), np.array(keep_j))
    assert 0 < int(keep.sum()) < p
    assert out.dtype == torch.float32 and out.shape == (p, m)
    np.testing.assert_array_equal(out.numpy(), np.array(out_j))


@pytest.mark.parametrize("p, m", [(64, 4), (61, 3)])
def test_group_threshold_bf16_matches_reference(p, m):
    B = _rows(p, m, seed=7)
    Bb = torch.from_numpy(B).to(torch.bfloat16)
    out, keep = group_threshold(Bb, 0.5)
    out_j, keep_j = jax_group_threshold(jnp.asarray(B, jnp.bfloat16), 0.5)
    assert out.dtype == torch.bfloat16
    assert np.array_equal(keep.numpy(), np.array(keep_j))
    # kept entries are copied, dropped ones are zero: within bf16's
    # rounding, and here exact
    np.testing.assert_allclose(out.float().numpy(),
                               np.array(out_j, np.float32), rtol=2 ** -8,
                               atol=0)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("m", [1, 3, 4, 5, 16, 40, 64, 129, 1000])
def test_row_lanes_take_each_vector_of_a_row_once(m, aligned):
    """The kernel's lane mapping: a row's vectors are float4 (or four
    bf16) only where m % 4 == 0 and the pointers are aligned; the row
    takes the least power of two of lanes that covers them, at most 32,
    so whole rows share a warp, and lane s takes vectors s, s + lanes,
    ..."""
    vecs = row_vectors(m, aligned)
    width = VECTOR if aligned and m % VECTOR == 0 else 1
    assert vecs * width == m
    lanes = row_lanes(vecs)
    assert 32 % lanes == 0 and 1 <= lanes <= 32
    assert lanes >= min(vecs, 32) and (lanes == 1 or lanes // 2 < vecs)
    counts = np.zeros(vecs, dtype=int)
    for s in range(lanes):
        counts[s::lanes] += 1
    assert np.all(counts == 1)


def test_row_lanes_at_the_master_steps_width():
    """At m = 16 tasks a row is four float4 on four lanes: eight rows a
    warp, where one warp a row left half its lanes idle."""
    assert row_vectors(16) == 4 and row_lanes(4) == 4
    assert row_lanes(row_vectors(5)) == 8


def test_comparison_is_squared_sum_against_lambda_squared():
    # row sums of squares 0, 0.25 and 25
    B = torch.tensor([[0.0, 0.0], [0.3, 0.4], [3.0, 4.0]])
    out, keep = group_threshold(B, 0.45)
    assert keep.tolist() == [False, True, True]
    assert torch.equal(out, B * torch.tensor([[0.0], [1.0], [1.0]]))
    # Lam < 0: every norm exceeds Lam, but the Pallas body's comparison
    # keeps only the rows whose sum of squares exceeds Lam^2 = 0.36; the
    # port follows the body
    out, keep = group_threshold(B, -0.6)
    assert keep.tolist() == [False, False, True]
    assert torch.equal(out, torch.tensor([[0.0, 0.0], [0.0, 0.0],
                                          [3.0, 4.0]]))


def test_master_step_of_dsml_fit():
    # paper eq. 5-6: the threshold of beta_u' is the fit's support, and
    # the filtered rows are beta_tilde (refit=False)
    data = jax_gen_regression(jax.random.PRNGKey(0), m=4, n=60, p=48, s=4)
    td = from_reference(data, "cpu")
    lam = 2.0 * float(np.sqrt(np.log(48) / 60))
    mu = float(np.sqrt(np.log(48) / 60))
    res = dsml_fit(td.Xs, td.ys, lam, mu, 0.5, lasso_iters=200,
                   debias_iters=200)
    out, keep = group_threshold(res.beta_u.T, 0.5)
    assert torch.equal(keep, res.support)
    assert 0 < int(keep.sum()) < 48
    assert torch.equal(out.T, res.beta_tilde)
    out_j, keep_j = jax_group_threshold(np.array(res.beta_u.T), 0.5)
    assert np.array_equal(keep.numpy(), np.array(keep_j))


def test_cpu_tensors_run_plain_version_and_launch_nothing():
    before = dict(LAUNCHES)
    B = torch.from_numpy(_rows(16, 3, seed=1))
    got = group_threshold(B, 0.5)
    want = group_threshold_ref(B, 0.5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = group_threshold(B, torch.tensor(0.5), use_kernel=False)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert dict(LAUNCHES) == before


def test_use_kernel_true_on_cpu_raises():
    with pytest.raises(ValueError, match="CUDA"):
        group_threshold(torch.ones(8, 2), 0.5, use_kernel=True)


def test_bad_shapes_and_dtypes_raise():
    with pytest.raises(ValueError, match=r"\(p, m\)"):
        group_threshold(torch.ones(8), 0.5)
    with pytest.raises(ValueError, match=r"\(p, m\)"):
        group_threshold(torch.ones(2, 8, 2), 0.5)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        group_threshold(torch.ones(8, 2, dtype=torch.float64), 0.5)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        group_threshold(torch.ones(8, 2, dtype=torch.float16), 0.5)
