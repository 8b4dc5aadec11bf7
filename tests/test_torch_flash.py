"""The port's flash-attention forward against the JAX package, on the CPU.

The same inputs, made with numpy from a seed, go to both packages:

* the port's blockwise `models.attention_core.flash_attention` against
  the reference's, with GQA (G in {1, 2, 4}), causal, sliding-window and
  non-causal masks, ragged S and k_valid masking, and the port's plain
  kernel version (`kernels/flash_attention/ref.py`) against the
  reference's, on the shapes of the reference's own kernel tests: within
  2e-5 in f32;
* the same plain version against the reference's Pallas kernel in
  interpret mode (`flash_attention_op(..., interpret=True)`), S <= 256:
  within 2e-5 in f32;
* bf16 against the f32 result of the same inputs, within 2e-2 absolute
  per element (the reference's own test of its kernel in bf16 allows
  atol = rtol = 2e-2);
* the wrapper's `use_kernel` rules on the CPU, and the kernel's launch
  plan (`launch_plan`: which design, blocks, shared memory);
* the f32 kernel's arithmetic, emulated in torch (its key tiles, the
  operands split into hi and lo, each rounded to TF32 by bit masking, and
  `mma.sync`'s accumulation modelled as truncating): each product as
  three TF32 products lands within the f32 bars of `chip_smoke.py` (2e-5
  · max|ref|, 1e-4 a query row, lse 1e-5 · max(1, |lse|)) of a float64
  reference, and one TF32 product does not; summing each tile's P V
  apart gives smaller errors than one accumulator over the whole row.

The CUDA kernel itself runs only on the card (`tests/test_torch_gpu.py`).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention_op
from repro.kernels.flash_attention.ref import (
    flash_attention_ref as jax_flash_ref,
)
from repro.models.attention_core import flash_attention as jax_flash
from repro_torch.kernels.common import LAUNCHES
from repro_torch.kernels.flash_attention.ops import (
    flash_attention, launch_plan,
)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models.attention_core import flash_attention as port_flash

TOL_F32 = 2e-5
TOL_BF16 = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _qkv(seed, b, s, n, k, h, t=None):
    rng = np.random.default_rng(seed)
    t = s if t is None else t
    return (rng.standard_normal((b, s, n, h), dtype=np.float32),
            rng.standard_normal((b, t, k, h), dtype=np.float32),
            rng.standard_normal((b, t, k, h), dtype=np.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


# the shapes of the reference's kernel tests (tests/test_kernels.py)
KERNEL_SHAPES = [(128, 4, 4, 32), (256, 8, 2, 64), (64, 2, 1, 128),
                 (192, 4, 2, 32)]


@pytest.mark.parametrize("s, n, k, h", KERNEL_SHAPES)
def test_plain_flash_matches_reference_causal(s, n, k, h):
    q, kk, v = _qkv(0, 2, s, n, k, h)
    want = jax_flash_ref(jnp.asarray(q), jnp.asarray(kk), jnp.asarray(v),
                         causal=True)
    got = flash_attention_ref(_t(q), _t(kk), _t(v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL_F32)


@pytest.mark.parametrize("causal, window", [(True, 16), (True, 64),
                                            (False, 0), (False, 24)])
@pytest.mark.parametrize("n, k", [(4, 4), (4, 2), (8, 2)])
def test_attention_core_matches_reference(n, k, causal, window):
    """GQA G = N / K in {1, 2, 4}, a ragged S = 100 against T = 100 with
    the last keys invalid, and key blocks of 32 (four of them, the last
    one padded)."""
    s, h = 100, 64
    q, kk, v = _qkv(1, 2, s, n, k, h)
    rng = np.random.default_rng(2)
    k_valid = np.ones(s, bool)
    k_valid[rng.choice(s, 9, replace=False)] = False
    k_valid[-5:] = False
    pos = np.arange(s, dtype=np.int32)
    want = jax_flash(jnp.asarray(q), jnp.asarray(kk), jnp.asarray(v),
                     q_pos=jnp.asarray(pos), k_pos=jnp.asarray(pos),
                     k_valid=jnp.asarray(k_valid), causal=causal,
                     window=window, block=32)
    got = port_flash(_t(q), _t(kk), _t(v), q_pos=torch.from_numpy(pos),
                     k_pos=torch.from_numpy(pos),
                     k_valid=torch.from_numpy(k_valid), causal=causal,
                     window=window, block=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL_F32)


def test_attention_core_offset_positions_and_empty_rows():
    """Cache-like positions: queries at 40..59 against keys 0..63 with a
    window of 8, so early queries see some keys, and a query block with no
    valid key at all (every key invalid) is zero, as the reference."""
    q, kk, v = _qkv(3, 1, 20, 4, 2, 64, t=64)
    qp = np.arange(40, 60, dtype=np.int32)
    kp = np.arange(64, dtype=np.int32)
    for k_valid in (np.ones(64, bool), np.zeros(64, bool)):
        want = jax_flash(jnp.asarray(q), jnp.asarray(kk), jnp.asarray(v),
                         q_pos=jnp.asarray(qp), k_pos=jnp.asarray(kp),
                         k_valid=jnp.asarray(k_valid), causal=True, window=8)
        got = port_flash(_t(q), _t(kk), _t(v), q_pos=torch.from_numpy(qp),
                         k_pos=torch.from_numpy(kp),
                         k_valid=torch.from_numpy(k_valid), causal=True,
                         window=8)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL_F32)
    assert not got.any()


@pytest.mark.parametrize("s, n, k, h, causal, window",
                         [(128, 4, 2, 64, True, 0), (256, 4, 1, 64, True, 64),
                          (128, 2, 2, 128, False, 0),
                          (64, 8, 2, 256, True, 16)])
def test_plain_flash_matches_pallas_kernel_interpreted(s, n, k, h, causal,
                                                       window):
    q, kk, v = _qkv(4, 1, s, n, k, h)
    want = flash_attention_op(jnp.asarray(q), jnp.asarray(kk), jnp.asarray(v),
                              causal=causal, window=window, bq=64, bk=64,
                              interpret=True)
    got = flash_attention(_t(q), _t(kk), _t(v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL_F32)


@pytest.mark.parametrize("s, n, k, h, window", [(256, 8, 2, 64, 0),
                                                (100, 4, 1, 128, 0),
                                                (192, 4, 2, 64, 32)])
def test_plain_flash_bf16_against_f32(s, n, k, h, window):
    q, kk, v = _qkv(5, 2, s, n, k, h)
    bf = [_t(a, torch.bfloat16) for a in (q, kk, v)]
    got = flash_attention(*bf, window=window)
    assert got.dtype == torch.bfloat16
    want = flash_attention(*(a.float() for a in bf), window=window)
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), rtol=0,
                               atol=TOL_BF16)


def test_wrapper_use_kernel_rules_on_cpu():
    q, kk, v = (_t(a) for a in _qkv(6, 1, 32, 4, 2, 64))
    before = dict(LAUNCHES)
    plain = flash_attention(q, kk, v)
    assert torch.equal(plain, flash_attention_ref(q, kk, v))
    assert torch.equal(plain, flash_attention(q, kk, v, use_kernel=False))
    assert dict(LAUNCHES) == before
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, kk, v, use_kernel=True)
    q32, k32, v32 = (_t(a) for a in _qkv(6, 1, 32, 4, 2, 32))
    for use_kernel in (None, False):
        with pytest.raises(ValueError, match="head dim"):
            flash_attention(q32, k32, v32, use_kernel=use_kernel)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, kk[:, :, :1].expand(1, 32, 3, 64).contiguous(),
                        v[:, :, :1].expand(1, 32, 3, 64).contiguous())
    with pytest.raises(TypeError, match="bfloat16"):
        flash_attention(q.half(), kk.half(), v.half())


# ---- the kernel's launch plan (the card tests run the kernel) ---------------

SMEM_PER_BLOCK = 232448        # 227 KB, the opt-in limit of one block


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b, s, n, h", [(4, 2048, 32, 64), (1, 200, 4, 128),
                                        (1, 512, 4, 256), (1, 300, 4, 64),
                                        (2, 1, 8, 128)])
def test_launch_plan_covers_the_queries_and_fits_a_block(b, s, n, h, dtype):
    pl = launch_plan(b, s, n, h, dtype)
    tiles = -(-s // pl.rows)
    assert tiles * pl.rows >= s and (tiles - 1) * pl.rows < s
    assert pl.items == b * n * tiles
    assert pl.smem_bytes <= SMEM_PER_BLOCK and pl.threads % 32 == 0
    hopper = dtype == torch.bfloat16 and h in (64, 128, 256)
    assert (pl.design == "wgmma") == hopper
    if hopper:
        # consumer warpgroups of 64 rows (three at H = 64, two at 128 and
        # 256) and a producer warpgroup; every Q, K and V panel is a whole
        # number of 1024-byte swizzle atoms
        consumers = 3 if h == 64 else 2
        assert pl.rows == 64 * consumers and pl.stages >= 2
        assert pl.threads == 128 * (consumers + 1)
        assert pl.rows * 128 % 1024 == 0 and pl.keys * 128 % 1024 == 0
    else:
        # 3xTF32: warps of 16 rows, a ring of at least two K/V stages
        assert pl.design == "tf32x3" and pl.rows == 16 * (pl.threads // 32)
        assert pl.stages >= 2 and pl.keys % 8 == 0


def test_launch_plan_at_the_serving_shape():
    """granite-3-2b's prefill: the Hopper design, 4 x 32 x 11 work items
    of 192 rows (about 11 for each of 132 persistent blocks), Q and a
    three-stage K/V ring in 121 KB."""
    pl = launch_plan(4, 2048, 32, 64, torch.bfloat16)
    assert pl.design == "wgmma" and pl.items == 1408 and pl.stages == 3
    assert pl.smem_bytes == 24576 + 3 * 2 * 16384 + 64 + 1024
    assert launch_plan(4, 2048, 32, 64, torch.float32).design == "tf32x3"
    assert launch_plan(1, 512, 4, 256, torch.bfloat16).design == "wgmma"


def test_launch_plan_at_h256():
    """recurrentgemma-9b's local attention (B, S, N, H) = (4, 2048, 16,
    256) in bf16: two consumer warpgroups (128 rows an item), 64 keys a
    tile in two stages, K and V released apart (two barrier pairs a
    stage), 4 x 16 x 16 work items; Q's 4 panels and the ring in 193 KiB,
    every panel a whole number of 1024-byte swizzle atoms."""
    pl = launch_plan(4, 2048, 16, 256, torch.bfloat16)
    assert pl.design == "wgmma" and pl.threads == 384
    assert (pl.rows, pl.keys, pl.stages) == (128, 64, 2)
    assert pl.items == 4 * 16 * 16
    q_panel, kv_panel = pl.rows * 128, pl.keys * 128
    assert q_panel % 1024 == 0 and kv_panel % 1024 == 0
    assert pl.smem_bytes == (4 * q_panel + 2 * 2 * 4 * kv_panel
                             + 8 * (4 * 2 + 2) + 1024)
    assert pl.smem_bytes <= SMEM_PER_BLOCK
    # a third stage would not fit
    assert pl.smem_bytes + 2 * 4 * kv_panel > SMEM_PER_BLOCK


# the f32 copies' instances (chip_smoke.py `f32_flash_shapes`): (B, S, N,
# H) and the plan's (rows, keys, stages, threads, shared memory bytes): Q,
# the ring's K and V stages and the split tile's hi and lo of K and V, in
# rows of H + 4 words
F32_PLANS = [((4, 2048, 32, 64), (128, 32, 3, 256, (128 + 6 * 32 + 4 * 32)
                                  * 68 * 4)),
             ((2, 2048, 32, 64), (128, 32, 3, 256, (128 + 6 * 32 + 4 * 32)
                                  * 68 * 4)),
             ((2, 2048, 16, 128), (128, 32, 2, 256, (128 + 4 * 32 + 4 * 32)
                                   * 132 * 4)),
             ((1, 2048, 8, 256), (64, 16, 2, 128, (64 + 4 * 16 + 4 * 16)
                                  * 260 * 4))]


@pytest.mark.parametrize("shape, want", F32_PLANS)
def test_launch_plan_f32_at_the_copies_shapes(shape, want):
    """The 3xTF32 design at 10b's, phase 6's, 9a's and a 13c-rg rank's
    shapes: 8 warps (128 rows) at H = 64 and 128, 4 at 256; 32 keys a
    tile (16 at 256) in a ring of 3 stages at H = 64, 2 above; Q, the ring
    and the split tile in rows padded to H + 4 words, within one block's
    227 KB; one block for each tile of rows of each (batch, head)."""
    b, s, n, h = shape
    pl = launch_plan(b, s, n, h, torch.float32)
    assert pl.design == "tf32x3"
    assert (pl.rows, pl.keys, pl.stages, pl.threads, pl.smem_bytes) == want
    assert pl.smem_bytes <= SMEM_PER_BLOCK
    assert pl.items == b * n * -(-s // pl.rows)
    assert (pl.items // (b * n)) * pl.rows >= s


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero, as `cvt.rna.tf32.f32`) by bit masking."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _trunc(x: torch.Tensor, top: torch.Tensor) -> torch.Tensor:
    """x (float64) cut toward zero to the last of the 24 bits that an f32
    of `top`'s magnitude holds."""
    grid = torch.ldexp(torch.ones_like(x), torch.frexp(top).exponent - 24)
    return torch.trunc(x / grid) * grid


def _mma(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """c + a @ b as one `mma.sync` m16n8k8 on TF32 operands a (..., R, 8)
    and b (..., 8, C) into f32 c (..., R, C), in a model of the tensor
    cores' accumulation: the eight products exact, the nine addends aligned
    to the largest and cut toward zero to its 24 bits, and their sum cut
    toward zero to f32. The card's exact rule is not published; this
    model truncates at least as little as the hardware."""
    terms = torch.cat([c.double()[None],
                       a.double().movedim(-1, 0)[..., None]
                       * b.double().movedim(-2, 0)[..., None, :]])
    total = _trunc(terms, terms.abs().amax(0)).sum(0)
    return _trunc(total, total).float()


def _split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo): x rounded to TF32, and the rest rounded to TF32."""
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _flash_tf32(q, k, v, causal, window, products, per_tile=True):
    """The f32 kernel's arithmetic (`flash_fwd_tf32x3`) in torch: (out
    (B, S, N, H), lse (B, N, S)). Keys in tiles of 32 (16 at H = 256)
    under the online softmax; Q K^T and P V a k-step of 8 at a time
    through `_mma`, as three TF32 products (lo.hi, hi.lo, then hi.hi) or
    as one (hi.hi). `per_tile`: each tile's P V summed in accumulators of
    its own, the small terms apart from hi.hi, and added to the rescaled
    O rounded to nearest, as the kernel does; else every product
    accumulated into O itself."""
    s_len, n, h = q.shape[1:]
    t_len, kv = k.shape[1:3]
    qt = q.permute(0, 2, 1, 3)
    kt, vt = (x.permute(0, 2, 1, 3).repeat_interleave(n // kv, 1)
              for x in (k, v))
    keys = 16 if h == 256 else 32
    scale = float(np.float32(1.0) / np.sqrt(np.float32(h)))
    row = torch.arange(s_len)[:, None]

    def small_terms(acc, a, b):
        (ah, al), (bh, bl) = a, b
        return _mma(_mma(acc, al, bh), ah, bl) if products == 3 else acc

    def mma_3x(acc, a, b):
        return _mma(small_terms(acc, a, b), a[0], b[0])

    qs = _split(qt)
    out = torch.zeros_like(qt)
    m = torch.full((*qt.shape[:-1], 1), -torch.inf)
    l_sum = torch.zeros_like(m)
    for k0 in range(0, t_len, keys):
        ks, vs = (_split(x[..., k0:k0 + keys, :]) for x in (kt, vt))
        sc = torch.zeros((*qt.shape[:-1], ks[0].shape[-2]))
        for e in range(0, h, 8):
            sc = mma_3x(sc, [x[..., e:e + 8] for x in qs],
                        [x[..., e:e + 8].mT for x in ks])
        key = torch.arange(k0, k0 + sc.shape[-1])[None, :]
        vis = (key <= row) if causal else torch.ones_like(key > row)
        if window:
            vis &= key > row - window
        sc = (sc * scale).masked_fill(~vis, -torch.inf)
        mx = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha = torch.where(mx > -torch.inf, torch.exp(m - mx), 1.0)
        p = torch.where(vis, torch.exp(sc - mx), 0.0)
        m, l_sum = mx, l_sum * alpha + p.sum(-1, keepdim=True)
        ps = _split(p)
        if per_tile:
            big, small = torch.zeros_like(out), torch.zeros_like(out)
        else:
            out = out * alpha
        for j in range(0, p.shape[-1], 8):
            a, b = [x[..., j:j + 8] for x in ps], [x[..., j:j + 8, :]
                                                   for x in vs]
            if per_tile:
                small = small_terms(small, a, b)
                big = _mma(big, a[0], b[0])
            else:
                out = mma_3x(out, a, b)
        if per_tile:
            out = (out.double() * alpha.double()
                   + (big + small).double()).float()
    out = out / l_sum.clamp_min(1e-30)
    return out.permute(0, 2, 1, 3), (m + torch.log(l_sum))[..., 0]


def _attention_f64(q, k, v, causal, window):
    """(out (B, S, N, H), lse (B, N, S)) in float64, whole rows at once."""
    q, k, v = (torch.from_numpy(x).double() for x in (q, k, v))
    s_len, n, h = q.shape[1:]
    t_len, kv = k.shape[1:3]
    qt = q.permute(0, 2, 1, 3)
    kt, vt = (x.permute(0, 2, 1, 3).repeat_interleave(n // kv, 1)
              for x in (k, v))
    s = qt @ kt.mT / np.sqrt(h)
    row, key = torch.arange(s_len)[:, None], torch.arange(t_len)[None, :]
    vis = (key <= row) if causal else torch.ones(s_len, t_len, dtype=bool)
    if window:
        vis &= key > row - window
    s = s.masked_fill(~vis, -torch.inf)
    lse = torch.logsumexp(s, -1)
    return (torch.exp(s - lse[..., None]) @ vt).permute(0, 2, 1, 3), lse


def _errors(got, ref):
    """(max|d| / max|ref|, worst row's ||d|| / ||ref||, worst lse error /
    max(1, |lse|)): the measures of chip_smoke.py's f32 bars."""
    (out, lse), (ref_out, ref_lse) = got, ref
    diff = out.double() - ref_out
    return ((diff.abs().max() / ref_out.abs().max()).item(),
            (diff.norm(dim=-1) / ref_out.norm(dim=-1)).max().item(),
            ((lse.double() - ref_lse).abs()
             / ref_lse.abs().clamp_min(1.0)).max().item())


F32_BARS = (2e-5, 1e-4, 1e-5)     # chip_smoke.py TOL_FLASH, rows, lse


@pytest.mark.parametrize("b, s, n, k, h, causal, window",
                         [(1, 128, 4, 2, 64, True, 0),
                          (1, 96, 2, 1, 128, True, 0),
                          (1, 64, 2, 1, 256, True, 32),
                          (1, 64, 4, 4, 64, False, 0)])
def test_three_tf32_products_hold_the_f32_bars(b, s, n, k, h, causal,
                                               window):
    """The f32 kernel's arithmetic emulated (`_flash_tf32`: its tiles, its
    split and its summation, with truncating accumulation): with three
    TF32 products both of attention's products stay within the f32 bars
    of a float64 reference (about 1e-6 here), and with one TF32 product
    every bar is broken (about 5e-4)."""
    q, kk, v = _qkv(7, b, s, n, k, h)
    ref = _attention_f64(q, kk, v, causal, window)
    q32, k32, v32 = (torch.from_numpy(x) for x in (q, kk, v))
    three, one = (_errors(_flash_tf32(q32, k32, v32, causal, window, p),
                          ref) for p in (3, 1))
    assert all(e <= bar for e, bar in zip(three, F32_BARS)), three
    assert all(e > bar for e, bar in zip(one, F32_BARS)), one


def test_summing_each_tile_apart_cuts_the_row_error():
    """Over a row of 1024 keys, the kernel's summation (each tile's P V
    in accumulators of its own, added to O rounded to nearest) keeps both
    the largest and the worst row error below those of one accumulator
    over the whole row, which carries every k-step's truncation into O,
    and within the f32 bars. In `_mma`'s model the gap is small (row
    2.7e-6 against 3.0e-6, largest 4.4e-7 against 5.8e-7); on the card
    the whole-row version's row errors were several times larger, so the
    hardware truncates more than the model does."""
    q, kk, v = _qkv(7, 1, 1024, 1, 1, 64)
    ref = _attention_f64(q, kk, v, True, 0)
    q32, k32, v32 = (torch.from_numpy(x) for x in (q, kk, v))
    tile, whole = (_errors(_flash_tf32(q32, k32, v32, True, 0, 3, apart),
                           ref) for apart in (True, False))
    assert all(e <= bar for e, bar in zip(tile, F32_BARS)), tile
    assert tile[0] < whole[0] and tile[1] < whole[1], (tile, whole)
