"""The port's dense model stack and serving path against the JAX package,
on the CPU.

The smoke granite (`smoke(get_config("granite-3-2b"))`: 2 layers, d 256,
4 query and 2 kv heads of 64) with the reference's own random parameters
carried across by `convert.params_from_reference`, and token ids made
with numpy from a seed, go through both packages.

Tolerances, each relative to the reference's max |.|:

* layers (`rms_norm`, `rope`, `mlp_apply`, the attention paths) in f32:
  1e-5;
* logits of `forward_prefill`, `forward_decode` and `forward_train` in
  f32: 1e-4 (measured about 1.4e-6 here); in bf16: 5e-2 (measured about
  1.2e-2 at S = 24 and S = 2048: the two frameworks round bf16 at other
  places, and XLA's CPU backend keeps excess precision in fused bf16
  chains, so bitwise bf16 parity is no goal);
* greedy tokens in f32: identical.

S = 2048 takes the flash branch (S·T >= FLASH_THRESHOLD), here through
the kernel's plain version.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, list_archs, smoke
from repro.configs import ASSIGNED as JAX_ASSIGNED
from repro.models import (
    Batch, forward_decode, forward_features, forward_prefill, forward_train,
    init_params,
)
from repro.models import layers as jl
from repro.models import mlp as jmlp
from repro.serving.engine import greedy_generate as jax_greedy
import repro_torch.configs as tconfigs
from repro_torch.convert import params_from_reference
from repro_torch.kernels.common import LAUNCHES
from repro_torch.launch import serve as tserve
from repro_torch.models import (
    Batch as TBatch, forward_decode as t_decode,
    forward_features as t_features, forward_prefill as t_prefill,
    forward_train as t_train, init_caches as t_init_caches,
    init_params as t_init_params,
)
from repro_torch.models import layers as tl
from repro_torch.models import mlp as tmlp
from repro_torch.serving.engine import (
    greedy_generate, make_prefill_step, make_serve_step,
)

KEY = jax.random.PRNGKey(1)
B = 2
TOL_LAYER = 1e-5
TOL_F32 = 1e-4
TOL_BF16 = 5e-2


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _cfgs(dtype="float32", **kw):
    jc = smoke(get_config("granite-3-2b")).replace(
        param_dtype=dtype, compute_dtype=dtype, **kw)
    tc = tconfigs.smoke(tconfigs.get_config("granite-3-2b")).replace(
        param_dtype=dtype, compute_dtype=dtype, **kw)
    return jc, tc


@pytest.fixture(scope="module")
def f32_model():
    jc, tc = _cfgs()
    params = init_params(KEY, jc)
    return jc, tc, params, params_from_reference(params, tc, "cpu")


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got: torch.Tensor, want, tol: float, what: str = "") -> float:
    want = _np(want)
    got = got.float().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    scale = float(np.max(np.abs(want)))
    assert err <= tol * scale, f"{what}: {err} > {tol} * {scale}"
    return err / scale


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _layer(params, tparams, name):
    return (jax.tree.map(lambda a: a[0], params["layers"]["p0"][name]),
            tparams["layers"][0][name])


def _x(seed, s, d=256):
    return np.random.default_rng(seed).standard_normal((B, s, d),
                                                       dtype=np.float32)


# ---- layers ----------------------------------------------------------------

def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, 24, 256), dtype=np.float32) * 3
    scale = rng.standard_normal(256, dtype=np.float32) * 0.1
    _close(tl.rms_norm(_t(x), _t(scale), 1e-6),
           jl.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6), TOL_LAYER)
    xr = rng.standard_normal((B, 24, 4, 64), dtype=np.float32)
    pos1 = np.arange(7, 31, dtype=np.int32)
    pos2 = np.stack([pos1, pos1 + 100])
    for pos in (pos1, pos2):
        _close(tl.rope(_t(xr), _t(pos), 10000.0),
               jl.rope(jnp.asarray(xr), jnp.asarray(pos), 10000.0), TOL_LAYER)


@pytest.mark.parametrize("act", ["swiglu", "squared_relu", "geglu", "gelu"])
def test_mlp_apply_matches_reference(act):
    jc, tc = _cfgs(mlp_act=act)
    p = jmlp.init_mlp_params(KEY, jc, jc.d_ff, jnp.float32)
    x = _x(1, 24)
    _close(tmlp.mlp_apply({k: _t(v) for k, v in p.items()}, _t(x), act),
           jmlp.mlp_apply(p, jnp.asarray(x), act), TOL_LAYER, act)


@pytest.mark.parametrize("s, causal, window", [(24, True, 0), (24, True, 8),
                                               (24, False, 0),
                                               (2048, True, 0),
                                               (2048, True, 300)])
def test_attention_train_matches_reference(f32_model, s, causal, window):
    """S = 24 takes the dense branch, S = 2048 the flash branch."""
    jc, tc, params, tparams = f32_model
    jp, tp = _layer(params, tparams, "attn")
    x = _x(2, s)
    pos = np.arange(s, dtype=np.int32)
    want = jl.attention_train(jp, jnp.asarray(x), jc,
                              positions=jnp.asarray(pos), causal=causal,
                              window=window)
    got = tl.attention_train(tp, _t(x), tc, positions=_t(pos), causal=causal,
                             window=window)
    _close(got, want, TOL_LAYER)


@pytest.mark.parametrize("s, window, cache_len", [(24, 0, 30), (40, 16, 48),
                                                  (2048, 0, 2051)])
def test_attention_prefill_and_decode_match_reference(f32_model, s, window,
                                                      cache_len):
    """The prompt's output and cache, then three decode steps against the
    cache: direct-indexed, a ring buffer (window 16 < S = 40, decode
    wrapping around it), and the flash branch's cache."""
    jc, tc, params, tparams = f32_model
    jp, tp = _layer(params, tparams, "attn")
    x = _x(5, s)
    pos = np.arange(s, dtype=np.int32)
    jo, jcache = jl.attention_prefill(jp, jnp.asarray(x), jc,
                                      positions=jnp.asarray(pos),
                                      window=window, cache_len=cache_len)
    to, tcache = tl.attention_prefill(tp, _t(x), tc, positions=_t(pos),
                                      window=window, cache_len=cache_len)
    _close(to, jo, TOL_LAYER, "prefill out")
    for name in ("k", "v"):
        _close(getattr(tcache, name), getattr(jcache, name), TOL_LAYER, name)
    assert np.array_equal(tcache.slot_pos.numpy(), np.asarray(jcache.slot_pos))
    for i in range(3):
        xd = _x(6 + i, 1)
        jpos = jnp.asarray(s + i, jnp.int32)
        jo, jcache = jl.attention_decode(jp, jnp.asarray(xd), jc,
                                         position=jpos, cache=jcache,
                                         window=window)
        to, tcache = tl.attention_decode(tp, _t(xd), tc, position=s + i,
                                         cache=tcache, window=window)
        _close(to, jo, TOL_LAYER, f"decode {i}")
        assert np.array_equal(tcache.slot_pos.numpy(),
                              np.asarray(jcache.slot_pos))


# ---- the stack -------------------------------------------------------------

@pytest.mark.parametrize("dtype, tol", [("float32", TOL_F32),
                                        ("bfloat16", TOL_BF16)])
@pytest.mark.parametrize("s", [24, 2048])
def test_prefill_and_decode_logits_match_reference(s, dtype, tol):
    jc, tc = _cfgs(dtype)
    params = init_params(KEY, jc)
    tparams = params_from_reference(params, tc, "cpu")
    toks = _tokens(s, (B, s + 1), jc.vocab)
    jl_, jcaches = forward_prefill(params, jc,
                                   Batch(tokens=jnp.asarray(toks[:, :s])),
                                   cache_len=s + 4)
    tl_, tcaches = t_prefill(tparams, tc, TBatch(tokens=_t(toks[:, :s])),
                             cache_len=s + 4)
    _close(tl_, jl_, tol, "prefill logits")
    jd, _ = forward_decode(params, jc, jnp.asarray(toks[:, s:]),
                           jnp.asarray(s, jnp.int32), jcaches)
    td, _ = t_decode(tparams, tc, _t(toks[:, s:]), s, tcaches)
    v = jc.vocab        # the pad columns are finfo.min on both sides
    _close(td[..., :v], jd[..., :v], tol, "decode logits")
    assert bool((td[..., v:] == torch.finfo(td.dtype).min).all())


def test_forward_train_and_features_match_reference(f32_model):
    jc, tc, params, tparams = f32_model
    toks = _tokens(7, (B, 24), jc.vocab)
    want, aux = forward_train(params, jc, Batch(tokens=jnp.asarray(toks)),
                              remat=False)
    got, taux = t_train(tparams, tc, TBatch(tokens=_t(toks)))
    _close(got, want, TOL_F32)
    assert float(taux) == float(aux) == 0.0
    _close(t_features(tparams, tc, TBatch(tokens=_t(toks))),
           forward_features(params, jc, Batch(tokens=jnp.asarray(toks))),
           TOL_F32)


def test_sliding_window_ring_buffer_matches_full_forward():
    """As the reference's serving test: decode past the window (T = 40 >
    2 x 16) equals the windowed full forward, and the reference's decode."""
    jc, tc = _cfgs(window=16)
    params = init_params(KEY, jc)
    tparams = params_from_reference(params, tc, "cpu")
    T = 40
    toks = _tokens(8, (B, T + 1), jc.vocab)
    full, _ = t_train(tparams, tc, TBatch(tokens=_t(toks)))
    _, caches = t_prefill(tparams, tc, TBatch(tokens=_t(toks[:, :T])),
                          cache_len=T + 8)
    assert caches["stack"][0].k.shape[1] == 16
    ld, _ = t_decode(tparams, tc, _t(toks[:, T:]), T, caches)
    v = jc.vocab
    _close(ld[:, 0, :v], full[:, T, :v].numpy(), TOL_F32)
    _, jcaches = forward_prefill(params, jc,
                                 Batch(tokens=jnp.asarray(toks[:, :T])),
                                 cache_len=T + 8)
    jd, _ = forward_decode(params, jc, jnp.asarray(toks[:, T:]),
                           jnp.asarray(T, jnp.int32), jcaches)
    _close(ld[..., :v], jd[..., :v], TOL_F32)


# ---- serving ---------------------------------------------------------------

@pytest.mark.parametrize("s, steps", [(8, 6), (2048, 3)])
def test_greedy_generate_matches_reference(f32_model, s, steps):
    jc, tc, params, tparams = f32_model
    prompt = _tokens(9 + s, (B, s), jc.vocab)
    want = jax_greedy(params, jc, jnp.asarray(prompt), steps=steps)
    before = LAUNCHES["flash_attention"]
    got = greedy_generate(tparams, tc, _t(prompt), steps=steps)
    assert LAUNCHES["flash_attention"] == before        # the CPU runs plain
    assert got.dtype == torch.int32 and got.shape == (B, s + steps)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_greedy_generate_zero_steps_is_identity(f32_model):
    _, tc, _, tparams = f32_model
    prompt = _t(_tokens(10, (B, 8), tc.vocab)).long()
    out = greedy_generate(tparams, tc, prompt, steps=0)
    assert out.shape == (B, 8) and out.dtype == torch.int64
    assert torch.equal(out, prompt)


@pytest.mark.parametrize("extra", [0, 3, 16])
def test_greedy_generate_cache_extra_invariance(f32_model, extra):
    _, tc, _, tparams = f32_model
    prompt = _t(_tokens(11, (B, 8), tc.vocab))
    base = greedy_generate(tparams, tc, prompt, steps=5)
    out = greedy_generate(tparams, tc, prompt, steps=5, cache_extra=extra)
    assert torch.equal(out, base)


def test_greedy_generate_matches_manual_decode_loop(f32_model):
    """Prefill, then one decode step per token through the step factories,
    token for token; the last token is a real decoded token."""
    _, tc, _, tparams = f32_model
    S0, steps = 8, 5
    prompt = _t(_tokens(12, (B, S0), tc.vocab))
    logits, caches = make_prefill_step(tc, cache_len=S0 + steps)(
        tparams, TBatch(tokens=prompt))
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    toks = [tok]
    serve_step = make_serve_step(tc)
    for i in range(steps - 1):
        tok, _, caches = serve_step(tparams, tok[:, None], S0 + i, caches)
        toks.append(tok)
    manual = torch.cat([prompt, torch.stack(toks, 1)], dim=1)
    assert torch.equal(greedy_generate(tparams, tc, prompt, steps=steps),
                       manual)


def test_serve_launcher_runs_on_cpu(capsys):
    out = tserve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "8",
                       "--new-tokens", "4"])
    assert out.shape == (2, 12)
    assert "granite-3-2b: generated 2x4 tokens" in capsys.readouterr().out


# ---- parameters, configs, caches -------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_reference_is_bitwise(dtype):
    jc, tc = _cfgs(dtype)
    params = init_params(KEY, jc)
    tparams = params_from_reference(params, tc, "cpu")
    assert len(tparams["layers"]) == jc.n_layers
    want_dtype = getattr(torch, dtype)

    def same(a, t):
        assert t.dtype == want_dtype
        bits = np.array(a).view(np.uint16 if dtype == "bfloat16"
                                else np.uint32)
        tb = t.view(torch.int16 if dtype == "bfloat16" else torch.int32)
        assert np.array_equal(tb.numpy().view(bits.dtype), bits)

    for name in ("embed", "final_norm", "head"):
        same(params[name], tparams[name])
    for i in range(jc.n_layers):
        jax.tree.map(lambda a, t: same(a[i], t), params["layers"]["p0"],
                     tparams["layers"][i])


def test_registry_matches_reference():
    assert tconfigs.list_archs() == list_archs()
    assert tconfigs.ASSIGNED == JAX_ASSIGNED
    for name in list_archs():
        for full in (True, False):
            jc, tc = get_config(name), tconfigs.get_config(name)
            if not full:
                jc, tc = smoke(jc), tconfigs.smoke(tc)
            assert dataclasses.asdict(tc) == dataclasses.asdict(jc), name
            assert tc.param_count() == jc.param_count()
            assert tc.active_param_count() == jc.active_param_count()
            assert tc.padded_vocab == jc.padded_vocab
            assert tc.layer_kinds() == jc.layer_kinds()


def _shapes(tree):
    """The leaf shapes of a tree of dicts, lists and NamedTuples."""
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree).__name__, [_shapes(v) for v in tree]
    return tuple(tree.shape)


def _ref_layers(stack, n_groups):
    """The reference's stacked groups {"p0": ..., } as one tree per
    layer, group by group."""
    return [jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape[1:],
                                                        a.dtype),
                         stack[f"p{i}"])
            for _ in range(n_groups) for i in range(len(stack))]


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "deepseek-moe-16b",
                                  "mamba2-1.3b", "recurrentgemma-9b",
                                  "seamless-m4t-medium", "internvl2-2b"])
def test_non_dense_configs_build(arch):
    """The port's own parameters and caches have the reference's shapes,
    layer for layer: the scanned groups split in order, the tail (the MoE
    head), the encoder, the recurrent and SSD caches, `enc_out`."""
    from repro.models import init_caches as jax_init_caches
    from repro.models import stack_plan as jax_stack_plan
    jc = smoke(get_config(arch))
    cfg = tconfigs.smoke(tconfigs.get_config(arch))
    _, n_groups, tail = jax_stack_plan(jc)
    want = jax.eval_shape(lambda k: init_params(k, jc), KEY)
    p = t_init_params(torch.Generator().manual_seed(0), cfg)
    assert _shapes(p["layers"]) == _shapes(_ref_layers(want["layers"],
                                                       n_groups))
    assert _shapes(p.get("tail", [])) == _shapes(want.get("tail", []))
    for name in ("embed", "final_norm", "head"):
        assert _shapes(p[name]) == _shapes(want[name])
    if "encoder" in want:
        assert _shapes(p["encoder"]["layers"]) == _shapes(
            _ref_layers(want["encoder"]["layers"], cfg.n_encoder_layers))
    assert set(p) == set(want)
    c = t_init_caches(cfg, 3, 10, device="cpu")
    jcache = jax.eval_shape(lambda: jax_init_caches(jc, 3, 10))
    assert _shapes(c["stack"]) == _shapes(_ref_layers(jcache["stack"],
                                                      n_groups))
    assert _shapes(c["tail"]) == _shapes(jcache["tail"])
    assert len(c["tail"]) == len(tail)
    assert (c["enc_out"] is None) == (jcache["enc_out"] is None)
    if c["enc_out"] is not None:
        assert c["enc_out"].shape == jcache["enc_out"].shape


def test_init_params_and_caches_shapes():
    tc = tconfigs.smoke(tconfigs.get_config("granite-3-2b"))
    p = t_init_params(torch.Generator().manual_seed(0), tc)
    assert p["embed"].shape == (tc.padded_vocab, 256)
    assert p["embed"].dtype == torch.bfloat16
    assert p["layers"][1]["attn"]["wo"].shape == (4, 64, 256)
    assert p["layers"][0]["mlp"]["w_gate"].shape == (256, 512)
    assert float(p["embed"].float().std()) == pytest.approx(256 ** -0.5,
                                                            rel=0.05)
    c = t_init_caches(tc, 3, 10, device="cpu")["stack"]
    assert len(c) == 2 and c[0].k.shape == (3, 10, 2, 64)
    assert bool((c[0].slot_pos == -1).all())


def test_serving_cell_is_granite_at_full_width_from_its_seeds():
    """The cell that chip_smoke.py gates and profile_serve.py profiles:
    the registry's granite-3-2b unreduced, with the given changes only,
    and the same prompt and parameters from the same seeds every call."""
    from repro_torch.serving import cell
    full = tconfigs.get_config(cell.ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.resolved_head_dim) == (40, 2048, 32, 8, 64)
    assert cell.PROMPT ** 2 >= tl.FLASH_THRESHOLD
    small = dict(n_layers=1, d_model=64, n_heads=4, n_kv_heads=2,
                 head_dim=16, d_ff=128, vocab=300)
    cfg, params, prompt = cell.make_cell("cpu", **small)
    assert cfg == dataclasses.replace(full, **small)
    assert prompt.shape == (cell.BATCH, cell.PROMPT)
    assert prompt.dtype == torch.int32
    assert int(prompt.min()) >= 0 and int(prompt.max()) < cfg.vocab
    _, params2, prompt2 = cell.make_cell("cpu", **small)
    assert torch.equal(prompt, prompt2)
    assert torch.equal(params["layers"][0]["attn"]["wq"],
                       params2["layers"][0]["attn"]["wq"])


def test_serving_cell_serves_any_family_with_its_stub_frontend():
    """Phase 9's families: the cell's batch for another configuration,
    and the frontend of the VLM and enc-dec ones from its own seed."""
    from repro_torch.serving import cell
    small = dict(n_layers=1, d_model=64, n_heads=4, n_kv_heads=2,
                 head_dim=16, d_ff=128, vocab=300, n_frontend_tokens=8)
    cfg, params, prompt = cell.make_cell("cpu", "internvl2-2b", **small)
    assert cfg == dataclasses.replace(tconfigs.get_config("internvl2-2b"),
                                      **small)
    assert prompt.shape == (cell.BATCH, cell.PROMPT)
    fe = cell.make_frontend(cfg, "cpu")
    assert fe.shape == (cell.BATCH, 8, 64) and fe.dtype == torch.float32
    assert torch.equal(fe, cell.make_frontend(cfg, "cpu"))
    assert float(fe.std()) == pytest.approx(0.1, rel=0.1)
    assert cell.make_frontend(tconfigs.get_config("granite-3-2b")) is None
