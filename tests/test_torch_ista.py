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
    GEMM_TILES, GEMV_BLOCKS_PER_SM, GEMV_PLANS, GRID_LAMS, check_block,
    fista_step_grid, gemm_plan, gemv_plan, grid_passes, ista_solve,
    ista_step, ista_step_batched, padded_area,
)
from repro_torch.kernels.ista_step.ref import (
    fista_step_batched_ref, fista_step_grid_ref, ista_step_batched_ref,
    ista_step_ref,
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


# ---- the lambda grid's step: Sigma shared by k problems a task ---------------

def _grid_inputs(m, p, k, seed=0):
    """Sigmas (m, p, p), zs, xs (k, m, p), cs (m, p), etas (m,), lams
    (k,) as float32 tensors."""
    Sig, b, c, etas, _ = _inputs(m, p, 1, seed)
    rng = np.random.default_rng(seed + 100)
    z = (0.3 * rng.standard_normal((k, m, p))).astype(np.float32)
    x = (z + 0.05 * rng.standard_normal((k, m, p))).astype(np.float32)
    lams = rng.uniform(0.02, 0.3, k).astype(np.float32)
    return tuple(_t(a) for a in (Sig, z, x, c[..., 0], etas, lams))


@pytest.mark.parametrize("theta", [0.6, 0.0])
@pytest.mark.parametrize("m, p, k", [(4, 20, 5), (3, 13, 11), (2, 16, 1)])
def test_fista_step_grid_plain_is_the_tiled_step(m, p, k, theta):
    """The plain grid step (one batched product of each Sigma against its
    task's k iterates) against `fista_step_batched_ref` on Sigma, c and
    eta tiled k times and each lambda repeated over the tasks, the
    engine's earlier layout: within float32 rounding of the products."""
    Sig, z, x, c, etas, lams = _grid_inputs(m, p, k)
    got = fista_step_grid(Sig, z, x, c, etas, lams, np.float32(theta))
    tiled = fista_step_batched_ref(
        Sig.repeat(k, 1, 1), z.reshape(k * m, p, 1), x.reshape(k * m, p, 1),
        c.repeat(k, 1)[..., None], etas.repeat(k),
        lams.repeat_interleave(m), np.float32(theta))
    for a, b in zip(got, tiled):
        assert a.shape == (k, m, p)
        np.testing.assert_allclose(a.numpy(), b.reshape(k, m, p).numpy(),
                                   rtol=0, atol=1e-6)
    assert all(torch.equal(a, b) for a, b in zip(
        got, fista_step_grid_ref(Sig, z, x, c, etas, lams, theta)))


def test_fista_step_grid_checks_its_operands():
    Sig, z, x, c, etas, lams = _grid_inputs(2, 8, 3, seed=3)
    with pytest.raises(ValueError, match="do not fit"):
        fista_step_grid(Sig, z, x, c, etas, lams[:2], 0.5)
    with pytest.raises(ValueError, match="do not fit"):
        fista_step_grid(Sig, z, x[:, :1], c, etas, lams, 0.5)
    with pytest.raises(ValueError, match="do not fit"):
        fista_step_grid(Sig, z, x, c[None], etas, lams, 0.5)
    with pytest.raises(ValueError, match="expected"):
        fista_step_grid(Sig, z[0], x[0], c, etas, lams, 0.5)
    with pytest.raises(TypeError, match="float32"):
        fista_step_grid(Sig, z, x, c, etas, lams.double(), 0.5)
    with pytest.raises(ValueError, match="GEMV_PLANS"):
        fista_step_grid(Sig, z, x, c, etas, lams, 0.5, block=(128, 64))
    with pytest.raises(ValueError, match="CUDA"):
        fista_step_grid(Sig, z, x, c, etas, lams, 0.5, use_kernel=True)
    before = dict(LAUNCHES)
    for block in GEMV_PLANS:
        fista_step_grid(Sig, z, x, c, etas, lams, 0.5, block=block)
    assert dict(LAUNCHES) == before


def test_grid_passes():
    """The grid's step reads each Sigma once for every 8 lambdas."""
    assert GRID_LAMS == 8
    assert [grid_passes(k) for k in (1, 5, 8, 9, 11, 16, 17)] == \
        [1, 1, 1, 2, 2, 2, 3]


def _xor_tree(a: np.ndarray) -> np.ndarray:
    """The r == 1 kernel's shuffle tree on (32 lanes, sums) in float32:
    at each offset every lane adds its partner's value."""
    a = a.copy()
    for off in (16, 8, 4, 2, 1):
        a = a + a[np.arange(32) ^ off]
    return a


def _tree_scatter(a: np.ndarray) -> np.ndarray:
    """`tree_scatter` in fista_step.cu, lane by lane in float32: each
    step keeps half of a lane's sums (the upper half where the lane's
    offset bit is set), adds its partner's copy of them, and the last
    sum finishes the tree. Returns each lane's sum."""
    nv = a.shape[1]
    lanes = np.arange(32)
    v = a.copy()
    h, off = nv // 2, 16
    while h >= 1:
        up = (lanes & off) != 0
        send = np.where(up[:, None], v[:, :h], v[:, h:2 * h])
        keep = np.where(up[:, None], v[:, h:2 * h], v[:, :h])
        v = keep + send[lanes ^ off]
        h, off = h // 2, off // 2
    s = v[:, 0]
    off = 16 // nv
    while off > 0:
        s = s + s[lanes ^ off]
        off //= 2
    return s


@pytest.mark.parametrize("nv", [1, 2, 4, 8, 16, 32])
def test_tree_scatter_adds_in_the_trees_order(nv):
    """Lane l ends with sum l / (32 / nv), with the bits the xor tree gives
    that sum on every lane (lanes past a row's end hold 0, as the kernel's
    lanes past p do)."""
    rng = np.random.default_rng(nv)
    a = (rng.standard_normal((32, nv)) * 10.0 ** rng.integers(
        -3, 4, (32, nv))).astype(np.float32)
    a[25:, : nv // 2] = 0.0
    want = _xor_tree(a)
    got = _tree_scatter(a)
    idx = np.arange(32) // (32 // nv)
    assert np.array_equal(got, want[np.arange(32), idx])
    assert all(np.array_equal(want[l], want[0]) for l in range(32))


# ---- the r > 1 kernel's tile plan (the card tests run the kernel) -----------

H100_SMS = 132
SMEM_PER_BLOCK = 232448        # 227 KB, the opt-in limit of one block


@pytest.mark.parametrize("m, p, r", [(1, 1024, 1024), (16, 1024, 1024),
                                     (3, 129, 7), (2, 1001, 1001),
                                     (1, 64, 5000), (128, 1024, 1024),
                                     (1024, 200, 200), (64, 197, 197),
                                     (256, 256, 256), (26, 200, 200),
                                     (16, 1000, 1000), (128, 400, 400)])
def test_gemm_plan_covers_the_output_and_fits_a_block(m, p, r):
    pl = gemm_plan(m, p, r, H100_SMS)
    blocks = [t[:2] for t in GEMM_TILES]
    assert (pl.bm, pl.bn) in blocks
    rows, cols = -(-p // pl.bm), -(-r // pl.bn)
    assert rows * pl.bm >= p and cols * pl.bn >= r
    assert (rows - 1) * pl.bm < p and (cols - 1) * pl.bn < r
    assert pl.blocks == m * rows * cols
    assert pl.threads == pl.bm * pl.bn // 64 and pl.threads <= 1024
    _, _, bk, stages = GEMM_TILES[blocks.index((pl.bm, pl.bn))]
    assert pl.smem_bytes == 4 * stages * bk * (pl.bm + pl.bn)
    assert pl.smem_bytes <= SMEM_PER_BLOCK
    # of the tiles whose grid gives every SM a block (a short-row one,
    # wider than tall, only where r fits in one of its blocks), the least
    # padded area, the first on a tie; where none does, the last
    filling = [t for t in blocks
               if m * -(-p // t[0]) * -(-r // t[1]) >= H100_SMS
               and (t[1] <= t[0] or r <= t[1])]
    if not filling:
        assert (pl.bm, pl.bn) == blocks[-1]
        return
    assert pl.blocks >= H100_SMS
    area = padded_area(p, r, pl.bm, pl.bn)
    before = filling[:filling.index((pl.bm, pl.bn))]
    assert all(padded_area(p, r, *t) > area for t in before)
    assert all(padded_area(p, r, *t) >= area for t in filling)


# (m, p, r), the tile the rule takes there, and why
RULE_CASES = {
    "#3 at m = 1: 128 x 64 gives 128 blocks for 132 SMs":
        ((1, 1024, 1024), (64, 64)),
    "row 1b, chip_smoke.py's phases, the logistic fit's debias":
        ((16, 1024, 1024), (128, 64)),
    "the stream service's refits: 128 x 64 covers p = 256 exactly":
        ((256, 256, 256), (128, 64)),
    "no tile gives every SM a block: the smallest":
        ((3, 129, 7), (64, 64)),
    "too few tasks at p = 200 for the short-row tile to fill the card":
        ((26, 200, 200), (128, 64)),
    "long rows: the short-row tile pads less but is slower, not taken":
        ((16, 1000, 1000), (128, 64)),
    "chip_smoke.py phase 3's long rows":
        ((3, 1000, 1000), (128, 64)),
    "rows past one short-row block: 64 x 64 pads least":
        ((128, 400, 400), (64, 64)),
}


@pytest.mark.parametrize("case", list(RULE_CASES))
def test_gemm_plan_fills_the_card_at_one_task(case):
    """The rule's tile at the shapes the port runs and at long rows: 128 x
    64 and 64 x 64 where they were chosen before the short-row tile (at
    one task, p = r = 1024, 128 x 64 gives 128 blocks for 132 SMs: 64 x 64
    fills the card), and no short-row tile where r passes its width."""
    shape, tile = RULE_CASES[case]
    pl = gemm_plan(*shape, H100_SMS)
    assert (pl.bm, pl.bn) == tile
    assert pl.blocks >= H100_SMS or tile == GEMM_TILES[-1][:2]


def test_gemm_plan_covers_the_papers_p_with_little_padding():
    """At the fit cell's (1024, 200, 200) the rule takes a tile whose grid
    covers 200 x 200 with at least 90 % of its outputs real (128 x 64
    covered it as 256 x 256, 61 %), and fills the card."""
    pl = gemm_plan(1024, 200, 200, H100_SMS)
    assert 200 * 200 / padded_area(200, 200, pl.bm, pl.bn) >= 0.9
    assert (pl.bm, pl.bn) not in ((128, 64), (64, 64))
    assert pl.blocks >= H100_SMS


@pytest.mark.parametrize("index", range(len(GEMM_TILES)))
def test_a_tile_is_named_whole_or_by_its_block(index):
    """`block=` at r > 1 takes a GEMM_TILES entry whole, as the autotune
    gives it, or as its (bm, bn); a ring that is not the tile's is
    refused."""
    tile = GEMM_TILES[index]
    assert check_block("t", 8, tile) == index
    assert check_block("t", 8, list(tile[:2])) == index
    with pytest.raises(ValueError, match="GEMM_TILES"):
        check_block("t", 8, (*tile[:2], tile[2] + 1, tile[3]))


@pytest.mark.parametrize("tile", GEMM_TILES)
def test_every_gemm_tile_is_the_rules_somewhere(tile):
    shapes = [(1, 1024, 1024), (16, 1024, 1024), (1024, 200, 200),
              (3, 129, 7), (2, 1001, 1001)]
    assert tile[:2] in {gemm_plan(*s, H100_SMS)[:2] for s in shapes}


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
