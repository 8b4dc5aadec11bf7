"""The port's ISTA entry points (`repro_torch.kernels.ista_step.ops`:
`ista_step_batched`, `ista_step`, `ista_solve`) against the JAX reference,
on the CPU.

The reference's own wrappers run here as its tests run them: the Pallas
body in interpret mode on tile-able shapes, its jnp oracle on ragged ones.
The port runs its plain version on CPU tensors. Same numpy inputs; within
1e-5 absolute (the reference's f32 parity bar), identical supports after
a solve. The CUDA kernels themselves run only on the card
(`tests/test_torch_gpu.py`, `chip_smoke.py`).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.kernels.ista_step.ops import (
    ista_solve as jax_ista_solve,
    ista_step as jax_ista_step,
    ista_step_batched as jax_ista_step_batched,
)
from repro_torch.kernels.common import LAUNCHES
from repro_torch.kernels.ista_step.ops import (
    GEMM_TILES, GEMV_BLOCKS_PER_SM, GEMV_PLANS, gemm_plan, gemv_plan,
    ista_solve, ista_step, ista_step_batched,
)
from repro_torch.kernels.ista_step.ref import (
    ista_step_batched_ref, ista_step_ref,
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
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


def _inputs(m, p, r, seed=0):
    """Sigmas (m, p, p) PSD; betas, cs (m, p, r); etas, lams (m,)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, 2 * p, p)).astype(np.float32)
    Sig = (np.einsum("tni,tnj->tij", A, A) / (2 * p)).astype(np.float32)
    b = (0.3 * rng.standard_normal((m, p, r))).astype(np.float32)
    c = (0.5 * rng.standard_normal((m, p, r))).astype(np.float32)
    etas = rng.uniform(0.2, 0.4, m).astype(np.float32)
    lams = rng.uniform(0.05, 0.2, m).astype(np.float32)
    return Sig, b, c, etas, lams


# ---- ista_step_batched ------------------------------------------------------

# (16, 1) and (16, 8) take the reference's Pallas body in interpret mode;
# (13, 3) is ragged and takes its oracle
@pytest.mark.parametrize("p, r", [(16, 1), (16, 8), (13, 3)])
@pytest.mark.parametrize("lam_kind", ["scalar", "per_task"])
def test_ista_step_batched_matches_reference(p, r, lam_kind):
    Sig, b, c, etas, lams = _inputs(3, p, r)
    lam = np.float32(0.1) if lam_kind == "scalar" else lams
    lam_t = float(lam) if lam_kind == "scalar" else _t(lam)
    got = ista_step_batched(_t(Sig), _t(b), _t(c), _t(etas), lam_t)
    _close(got, jax_ista_step_batched(Sig, b, c, etas, lam))


def test_ista_step_batched_squeezes_single_rhs():
    Sig, b, c, etas, lams = _inputs(2, 16, 1, seed=1)
    got = ista_step_batched(_t(Sig), _t(b[..., 0]), _t(c[..., 0]), _t(etas),
                            _t(lams))
    want = jax_ista_step_batched(Sig, b[..., 0], c[..., 0], etas, lams)
    assert got.shape == (2, 16)
    _close(got, want)


# ---- ista_step --------------------------------------------------------------

@pytest.mark.parametrize("p, r", [(16, 1), (16, 8), (13, 3)])
def test_ista_step_matches_reference(p, r):
    Sig, b, c, etas, lams = _inputs(1, p, r, seed=2)
    eta, lam = etas[0], lams[0]
    got = ista_step(_t(Sig[0]), _t(b[0]), _t(c[0]), float(eta), float(lam))
    _close(got, jax_ista_step(Sig[0], b[0], c[0], eta, lam))


def test_ista_step_squeezes_vector_and_takes_tensor_scalars():
    Sig, b, c, etas, lams = _inputs(1, 16, 1, seed=3)
    got = ista_step(_t(Sig[0]), _t(b[0, :, 0]), _t(c[0, :, 0]),
                    _t(etas[0]), _t(lams[:1]))
    assert got.shape == (16,)
    _close(got, jax_ista_step(Sig[0], b[0, :, 0], c[0, :, 0], etas[0],
                              lams[0]))


# ---- ista_solve -------------------------------------------------------------

@pytest.mark.parametrize("p, r, lam", [(16, 1, 0.1), (24, 4, 0.05)])
def test_ista_solve_matches_reference(p, r, lam):
    Sig, _, c, _, _ = _inputs(1, p, r, seed=4)
    got = ista_solve(_t(Sig[0]), _t(c[0]), lam, iters=120)
    want = np.array(jax_ista_solve(Sig[0], c[0], np.float32(lam),
                                   iters=120))
    _close(got, want)
    assert np.array_equal(got.numpy() != 0, want != 0)
    assert 0 < int((got != 0).sum()) < got.numel()


def test_ista_solve_squeezed_rhs_is_the_lasso_fixed_point():
    # 600 proximal steps on a well-conditioned problem reach the lasso
    # optimum: one more step leaves it in place
    Sig, _, c, _, _ = _inputs(1, 12, 1, seed=5)
    S, cv = _t(Sig[0]), _t(c[0, :, 0])
    got = ista_solve(S, cv, 0.1, iters=600)
    assert got.shape == (12,)
    want = np.array(jax_ista_solve(Sig[0], c[0, :, 0], np.float32(0.1),
                                   iters=600))
    _close(got, want)
    eta = 1.0 / float(torch.linalg.eigvalsh(S.double()).max())
    again = ista_step_ref(S, got, cv, eta, 0.1)
    _close(again, got.numpy(), atol=1e-5)


# ---- dispatch and checks ----------------------------------------------------

def test_cpu_tensors_run_plain_versions_and_launch_nothing():
    before = dict(LAUNCHES)
    Sig, b, c, etas, lams = _inputs(2, 8, 3, seed=6)
    args = (_t(Sig), _t(b), _t(c), _t(etas), _t(lams))
    assert torch.equal(ista_step_batched(*args), ista_step_batched_ref(*args))
    assert torch.equal(ista_step(args[0][0], args[1][0], args[2][0], 0.3, 0.1),
                       ista_step_ref(args[0][0], args[1][0], args[2][0],
                                     torch.tensor(0.3), torch.tensor(0.1)))
    ista_solve(args[0][0], args[2][0], 0.1, iters=3)
    assert dict(LAUNCHES) == before


def test_use_kernel_true_on_cpu_raises():
    Sig, b, c, etas, lams = _inputs(2, 8, 1, seed=7)
    with pytest.raises(ValueError, match="CUDA"):
        ista_step_batched(_t(Sig), _t(b), _t(c), _t(etas), 0.1,
                          use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        ista_step(_t(Sig[0]), _t(b[0]), _t(c[0]), 0.3, 0.1, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        ista_solve(_t(Sig[0]), _t(c[0]), 0.1, iters=2, use_kernel=True)


def test_use_kernel_false_runs_the_plain_version():
    Sig, b, c, etas, lams = _inputs(2, 8, 2, seed=8)
    args = (_t(Sig), _t(b), _t(c), _t(etas), _t(lams))
    assert torch.equal(ista_step_batched(*args, use_kernel=False),
                       ista_step_batched_ref(*args))


def test_bad_shapes_raise():
    Sig, b, c, etas, lams = _inputs(2, 8, 3, seed=9)
    with pytest.raises(ValueError, match="do not fit"):
        ista_step_batched(_t(Sig), _t(b), _t(c[:, :5]), _t(etas), 0.1)
    with pytest.raises(ValueError, match="do not fit"):
        ista_step_batched(_t(Sig), _t(b), _t(c), _t(etas[:1]), 0.1)
    with pytest.raises(ValueError, match="lam"):
        ista_step_batched(_t(Sig), _t(b), _t(c), _t(etas),
                          torch.ones(3))
    with pytest.raises(ValueError, match="expected"):
        ista_step_batched(_t(Sig[0]), _t(b[0]), _t(c[0]), _t(etas), 0.1)
    with pytest.raises(ValueError, match="do not fit"):
        ista_step(_t(Sig[0]), _t(b[0]), _t(c[0, :4]), 0.3, 0.1)
    with pytest.raises(ValueError, match="expected"):
        ista_step(_t(Sig), _t(b[0]), _t(c[0]), 0.3, 0.1)
    with pytest.raises(ValueError, match="eta"):
        ista_step(_t(Sig[0]), _t(b[0]), _t(c[0]), _t(etas), 0.1)


def test_float64_raises():
    Sig, b, c, etas, lams = _inputs(2, 8, 1, seed=10)
    with pytest.raises(TypeError, match="float32"):
        ista_step_batched(_t(Sig).double(), _t(b), _t(c), _t(etas), 0.1)
    with pytest.raises(TypeError, match="float32"):
        ista_step_batched(_t(Sig), _t(b), _t(c), _t(etas),
                          _t(lams).double())
    with pytest.raises(TypeError, match="float32"):
        ista_step(_t(Sig[0]), _t(b[0]).double(), _t(c[0]), 0.3, 0.1)
    with pytest.raises(TypeError, match="float32"):
        ista_step(_t(Sig[0]), _t(b[0]), _t(c[0]),
                  torch.tensor(0.3, dtype=torch.float64), 0.1)


# ---- the r > 1 kernel's tile plan (the card tests run the kernel) -----------

H100_SMS = 132
SMEM_PER_BLOCK = 232448        # 227 KB, the opt-in limit of one block


@pytest.mark.parametrize("m, p, r", [(1, 1024, 1024), (16, 1024, 1024),
                                     (3, 129, 7), (2, 1001, 1001),
                                     (1, 64, 5000), (128, 1024, 1024)])
def test_gemm_plan_covers_the_output_and_fits_a_block(m, p, r):
    pl = gemm_plan(m, p, r, H100_SMS)
    assert (pl.bm, pl.bn) in GEMM_TILES
    rows, cols = -(-p // pl.bm), -(-r // pl.bn)
    assert rows * pl.bm >= p and cols * pl.bn >= r
    assert (rows - 1) * pl.bm < p and (cols - 1) * pl.bn < r
    assert pl.blocks == m * rows * cols
    assert pl.threads == pl.bm * pl.bn // 64 and pl.threads % 32 == 0
    assert pl.smem_bytes <= SMEM_PER_BLOCK
    # the larger tile where it gives every SM a block, else the smaller
    larger = GEMM_TILES[:GEMM_TILES.index((pl.bm, pl.bn))]
    assert all(m * -(-p // bm) * -(-r // bn) < H100_SMS
               for bm, bn in larger)
    assert pl.blocks >= H100_SMS or (pl.bm, pl.bn) == GEMM_TILES[-1]


def test_gemm_plan_fills_the_card_at_one_task():
    """At m = 1, p = r = 1024 a 128 x 128 tile gives 64 blocks for 132
    SMs; the plan takes a tile that gives at least one block per SM, and
    the larger tile at the debias solve's m = 16."""
    one = gemm_plan(1, 1024, 1024, H100_SMS)
    assert one.blocks >= H100_SMS and (one.bm, one.bn) == (64, 64)
    many = gemm_plan(16, 1024, 1024, H100_SMS)
    assert (many.bm, many.bn) == (128, 64) and many.blocks == 2048
    # the four card-test shapes reach every tile
    shapes = [(1, 1024, 1024), (16, 1024, 1024), (3, 129, 7), (2, 1001, 1001)]
    assert {gemm_plan(*s, H100_SMS)[:2] for s in shapes} == set(GEMM_TILES)


# ---- the r == 1 kernel's launch plan (the card tests run the kernel) --------

def _gemv_rows(m: int, p: int, plan) -> np.ndarray:
    """How often the kernel's warps take each row of each task: warp w of
    block (b, t) owns rows (b * warps + w) * rows_per_warp onwards, those
    below p."""
    count = np.zeros((m, p), dtype=np.int64)
    per_task = plan.blocks // m
    for t in range(m):
        for b in range(per_task):
            for w in range(plan.warps):
                row0 = (b * plan.warps + w) * plan.rows_per_warp
                count[t, row0:min(p, row0 + plan.rows_per_warp)] += 1
    return count


@pytest.mark.parametrize("m, p", [(1, 1024), (16, 1024), (128, 1024),
                                  (1, 1023), (3, 129), (2, 7)])
def test_gemv_plan_covers_every_row_once(m, p):
    pl = gemv_plan(m, p, H100_SMS)
    assert (pl.rows_per_warp, pl.warps) in GEMV_PLANS
    rows_per_block = pl.rows_per_warp * pl.warps
    assert pl.blocks == m * -(-p // rows_per_block)
    assert pl.threads == 32 * pl.warps <= 256
    assert np.all(_gemv_rows(m, p, pl) == 1)
    # a lane reads k (or float4 q) = lane, lane + 32, ...: every column
    # of a row once, whatever the plan
    width = p // 4 if p % 4 == 0 else p
    cols = np.concatenate([np.arange(lane, width, 32) for lane in range(32)])
    assert np.array_equal(np.sort(cols), np.arange(width))
    # the first plan that gives every SM GEMV_BLOCKS_PER_SM blocks, else
    # the last
    want = GEMV_BLOCKS_PER_SM * H100_SMS
    earlier = GEMV_PLANS[:GEMV_PLANS.index((pl.rows_per_warp, pl.warps))]
    assert all(m * -(-p // (r * w)) < want for r, w in earlier)
    assert pl.blocks >= want or \
        (pl.rows_per_warp, pl.warps) == GEMV_PLANS[-1]


def test_gemv_plan_fills_the_card_at_one_and_sixteen_tasks():
    """At m = 1, p = 1024 four rows a warp and eight warps a block give 32
    blocks for 132 SMs; the plan gives at least two blocks an SM at one
    task and at the lasso's m = 16 (two rows a warp there, four from
    m = 17)."""
    one = gemv_plan(1, 1024, H100_SMS)
    assert one.blocks >= 2 * H100_SMS
    assert (one.rows_per_warp, one.warps, one.blocks) == (1, 2, 512)
    many = gemv_plan(16, 1024, H100_SMS)
    assert many.blocks >= 2 * H100_SMS
    assert (many.rows_per_warp, many.warps, many.blocks) == (2, 8, 1024)
    grid = gemv_plan(128, 1024, H100_SMS)
    assert (grid.rows_per_warp, grid.warps, grid.blocks) == (4, 8, 4096)
    # the card tests' shapes take a plan of one row a warp and of four
    shapes = [(1, 1024), (1, 1023), (128, 1024)]
    assert {gemv_plan(*s, H100_SMS).rows_per_warp for s in shapes} == {1, 4}
