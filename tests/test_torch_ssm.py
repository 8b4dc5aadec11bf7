"""The port's recurrent blocks — Mamba-2's SSD (`repro_torch.models.ssd`)
and Griffin's RG-LRU (`repro_torch.models.rglru`) — against the JAX
package, on the CPU.

The smoke mamba2-1.3b and recurrentgemma-9b in float32, the reference's
`init_ssd_params` / `init_recurrent_params` carried across, inputs made
by the reference's PRNG or numpy:

* `_causal_depthwise_conv` (with and without a carry), `rglru_scan`
  (S = 33 and 2048: the log-depth scan's rounding differs from the
  reference's tree), `recurrent_block_train` and three
  `recurrent_block_decode` steps, `ssd_chunked` on a length that is no
  multiple of the chunk, `ssd_block_train` with its final state and
  three `ssd_block_decode` steps, each within 1e-5 · max|.|;
* twins of the reference's `tests/test_model_properties.py` SSD, RG-LRU
  and hybrid cases: chunk-size invariance, causality, the scan against
  the sequential recurrence, a contractive state, the hybrid pattern.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke
from repro.models import rglru as jrg
from repro.models import ssd as jssd
import repro_torch.configs as tconfigs
from repro_torch.convert import from_reference
from repro_torch.models import rglru, ssd

F32 = dict(compute_dtype="float32", param_dtype="float32")
KEY = jax.random.PRNGKey(0)
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _cfgs(arch):
    return (smoke(get_config(arch)).replace(**F32),
            tconfigs.smoke(tconfigs.get_config(arch)).replace(**F32))


def _port(p: dict) -> dict:
    return {k: from_reference(v, "cpu") for k, v in p.items()}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got: torch.Tensor, want, what="", tol=TOL):
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got.numpy() - want)))
    assert err <= tol * float(np.max(np.abs(want))), (what, err)


@pytest.fixture(scope="module")
def griffin():
    jc, tc = _cfgs("recurrentgemma-9b")
    p = jrg.init_recurrent_params(KEY, jc, jnp.float32)
    return jc, tc, p, _port(p)


@pytest.fixture(scope="module")
def mamba():
    jc, tc = _cfgs("mamba2-1.3b")
    p = jssd.init_ssd_params(KEY, jc, jnp.float32)
    return jc, tc, p, _port(p)


# ---- RG-LRU ------------------------------------------------------------

def test_causal_depthwise_conv_matches_reference():
    rng = np.random.default_rng(0)
    u = rng.standard_normal((2, 9, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16)).astype(np.float32)
    carry = rng.standard_normal((2, 3, 16)).astype(np.float32)
    for c in (None, carry):
        got = rglru._causal_depthwise_conv(
            _t(u), _t(w), None if c is None else _t(c))
        want = jrg._causal_depthwise_conv(
            jnp.asarray(u), jnp.asarray(w), None if c is None
            else jnp.asarray(c))
        _close(got, want)


@pytest.mark.parametrize("s", [33, 2048])
def test_rglru_scan_matches_reference(griffin, s):
    jc, _, p, tp = griffin
    u = 0.3 * jax.random.normal(jax.random.PRNGKey(2), (2, s, 256))
    _close(rglru.rglru_scan(tp, _t(u), jc.rglru.c),
           jrg.rglru_scan(p, u, jc.rglru.c))


def test_recurrent_block_train_and_decode_match_reference(griffin):
    jc, tc, p, tp = griffin
    x = 0.5 * jax.random.normal(jax.random.PRNGKey(3), (2, 20, jc.d_model))
    _close(rglru.recurrent_block_train(tp, _t(x), tc),
           jrg.recurrent_block_train(p, x, jc), "train")
    rng = np.random.default_rng(4)
    h = rng.standard_normal((2, 256)).astype(np.float32)
    conv = rng.standard_normal((2, 3, 256)).astype(np.float32)
    jcache = jrg.RecurrentCache(h=jnp.asarray(h), conv=jnp.asarray(conv))
    tcache = rglru.RecurrentCache(h=_t(h), conv=_t(conv))
    for i in range(3):
        xd = x[:, i:i + 1]
        jo, jcache = jrg.recurrent_block_decode(p, xd, jc, jcache)
        to, new = rglru.recurrent_block_decode(tp, _t(xd), tc, tcache)
        assert new.h is not tcache.h and torch.equal(tcache.conv,
                                                     _t(conv) if i == 0
                                                     else tcache.conv)
        tcache = new
        _close(to, jo, f"decode {i}")
        _close(tcache.h, jcache.h, f"h {i}")
        _close(tcache.conv, jcache.conv, f"conv {i}")


def test_rglru_scan_matches_sequential(griffin):
    """The reference's property case on the port."""
    jc, _, _, tp = griffin
    u = _t(0.3 * jax.random.normal(jax.random.PRNGKey(2), (2, 33, 256)))
    h_scan = rglru.rglru_scan(tp, u, jc.rglru.c)
    a, b = rglru._rglru_gates(tp, u, jc.rglru.c)
    h = torch.zeros((2, 256))
    hs = []
    for t in range(33):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    np.testing.assert_allclose(h_scan.numpy(), torch.stack(hs, 1).numpy(),
                               atol=1e-5)


def test_rglru_state_is_contractive():
    """|a_t| < 1 for all inputs: the recurrence cannot blow up (the
    reference's case, its bf16 parameters carried across)."""
    jc = smoke(get_config("recurrentgemma-9b"))
    p = _port(jrg.init_recurrent_params(KEY, jc, jnp.float32))
    u = _t(100.0 * jax.random.normal(KEY, (1, 16, 256)))
    a, _ = rglru._rglru_gates(p, u, jc.rglru.c)
    assert float(a.max()) <= 1.0
    assert float(a.mean()) < 1.0
    assert float(a.min()) > 0.0


def test_hybrid_pattern_structure():
    cfg = tconfigs.get_config("recurrentgemma-9b")
    kinds = cfg.layer_kinds()
    assert len(kinds) == 38
    assert kinds[:3] == ("recurrent", "recurrent", "local_attn")
    assert kinds.count("local_attn") == 12
    assert kinds.count("recurrent") == 26
    from repro_torch.models import stack_plan
    assert stack_plan(cfg) == (("recurrent", "recurrent", "local_attn"), 12,
                               ("recurrent", "recurrent"))


# ---- SSD ---------------------------------------------------------------

def test_ssd_chunked_pads_to_the_chunk_as_the_reference(mamba):
    """l = 45 is no multiple of the chunk (16): padding with dtA = 0 and
    B = 0 leaves the final state exact."""
    rng = np.random.default_rng(5)
    b, l, h, p, n = 2, 45, 4, 8, 16
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dtA = -np.abs(rng.standard_normal((b, l, h))).astype(np.float32) * 0.1
    Bm = rng.standard_normal((b, l, h, n)).astype(np.float32)
    Cm = rng.standard_normal((b, l, h, n)).astype(np.float32)
    s0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    y, fin = ssd.ssd_chunked(_t(x), _t(dtA), _t(Bm), _t(Cm), 16, _t(s0))
    jy, jfin = jssd.ssd_chunked(*(jnp.asarray(a) for a in (x, dtA, Bm, Cm)),
                                16, jnp.asarray(s0))
    _close(y, jy, "y")
    _close(fin, jfin, "final state")


def test_ssd_block_train_and_decode_match_reference(mamba):
    jc, tc, p, tp = mamba
    x = 0.1 * jax.random.normal(jax.random.PRNGKey(1), (2, 40, jc.d_model))
    out, state = ssd.ssd_block_train(tp, _t(x), tc, return_state=True)
    jout, jstate = jssd.ssd_block_train(p, x, jc, return_state=True)
    _close(out, jout, "train")
    _close(state, jstate, "state")
    assert torch.equal(ssd.ssd_block_train(tp, _t(x), tc), out)
    conv_dim = 4 * 32 + 2 * 16
    rng = np.random.default_rng(6)
    conv = rng.standard_normal((2, 3, conv_dim)).astype(np.float32)
    jcache = jssd.SsdCache(state=jstate, conv=jnp.asarray(conv))
    tcache = ssd.SsdCache(state=state, conv=_t(conv))
    for i in range(3):
        xd = x[:, i:i + 1]
        jo, jcache = jssd.ssd_block_decode(p, xd, jc, jcache)
        to, tcache = ssd.ssd_block_decode(tp, _t(xd), tc, tcache)
        _close(to, jo, f"decode {i}")
        _close(tcache.state, jcache.state, f"state {i}")
        _close(tcache.conv, jcache.conv, f"conv {i}")


def test_ssd_chunk_size_invariance(mamba):
    """The chunked SSD algorithm gives the same output for any chunk."""
    _, tc, _, tp = mamba
    x = _t(0.1 * jax.random.normal(jax.random.PRNGKey(1),
                                   (2, 64, tc.d_model)))
    outs = [ssd.ssd_block_train(
        tp, x, tc.replace(ssd=dataclasses.replace(tc.ssd, chunk=chunk)))
        for chunk in (8, 16, 32, 64)]
    for o in outs[1:]:
        np.testing.assert_allclose(outs[0].numpy(), o.numpy(), atol=2e-4)


def test_ssd_is_causal(mamba):
    """Perturbing future inputs does not change past outputs."""
    _, tc, _, tp = mamba
    x = _t(0.1 * jax.random.normal(jax.random.PRNGKey(1),
                                   (1, 48, tc.d_model)))
    y1 = ssd.ssd_block_train(tp, x, tc)
    x2 = x.clone()
    x2[:, 30:] = 5.0
    y2 = ssd.ssd_block_train(tp, x2, tc)
    np.testing.assert_allclose(y1[:, :30].numpy(), y2[:, :30].numpy(),
                               atol=1e-5)
