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
  plan (`launch_plan`: which design, blocks, shared memory).

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


def test_launch_plan_at_the_serving_shape():
    """granite-3-2b's prefill: the Hopper design, 4 x 32 x 11 work items
    of 192 rows (about 11 for each of 132 persistent blocks), Q and a
    three-stage K/V ring in 121 KB."""
    pl = launch_plan(4, 2048, 32, 64, torch.bfloat16)
    assert pl.design == "wgmma" and pl.items == 1408 and pl.stages == 3
    assert pl.smem_bytes == 24576 + 3 * 2 * 16384 + 64 + 1024
    assert launch_plan(4, 2048, 32, 64, torch.float32).design == "fma"
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
