"""The port's model zoo against the JAX package, every family, on the CPU.

Each of the ten `ASSIGNED` configurations under `smoke()` in float32,
with the reference's own random parameters (`init_params(PRNGKey(0))`)
carried across by `convert.params_from_reference`, and token ids (and
the stub frontend of the enc-dec and VLM families) made with numpy from
a seed, goes through both packages:

* `forward_train`: logits within 1e-5 · max|logits| and the MoE aux
  (router_aux_weight · balance + router_z_weight · z-loss) within 1e-5
  relative — the reference's `tests/test_arch_smoke.py::test_smoke_forward`
  with the port beside it;
* the six non-dense families: `forward_prefill`'s last logits, then four
  `forward_decode` steps against the caches (ring buffers, recurrent and
  SSD states, the encoder output), each within 1e-5 · max|logits|;
  `greedy_generate` (with the VLM's patches or the enc-dec's frames)
  token for token; `launch/serve.py --arch` on the CPU.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED, get_config, smoke
from repro.models import (
    Batch, forward_decode, forward_prefill, forward_train, init_params,
)
from repro.serving.engine import greedy_generate as jax_greedy
import repro_torch.configs as tconfigs
from repro_torch.convert import params_from_reference
from repro_torch.launch import serve as tserve
from repro_torch.models import Batch as TBatch
from repro_torch.models import forward_decode as t_decode
from repro_torch.models import forward_prefill as t_prefill
from repro_torch.models import forward_train as t_train
from repro_torch.serving.engine import greedy_generate

F32 = dict(compute_dtype="float32", param_dtype="float32")
B, S = 2, 32
TOL = 1e-5
NON_DENSE = ["deepseek-moe-16b", "qwen3-moe-30b-a3b", "seamless-m4t-medium",
             "internvl2-2b", "recurrentgemma-9b", "mamba2-1.3b"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


_MODELS: dict = {}


def _model(arch):
    """(reference cfg, port cfg, reference params, port params), once a
    module."""
    if arch not in _MODELS:
        jc = smoke(get_config(arch)).replace(**F32)
        tc = tconfigs.smoke(tconfigs.get_config(arch)).replace(**F32)
        params = init_params(jax.random.PRNGKey(0), jc)
        _MODELS[arch] = (jc, tc, params,
                         params_from_reference(params, tc, "cpu"))
    return _MODELS[arch]


def _inputs(cfg, seed, s):
    """(tokens (B, s + 4), frontend or None), numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, s + 4)).astype(np.int32)
    fe = None
    if cfg.frontend:
        fe = (0.01 * rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model))).astype(np.float32)
    return toks, fe


def _batches(toks, fe):
    jb = Batch(tokens=jnp.asarray(toks),
               frontend=None if fe is None else jnp.asarray(fe))
    tb = TBatch(tokens=torch.from_numpy(toks),
                frontend=None if fe is None else torch.from_numpy(fe))
    return jb, tb


def _close(got: torch.Tensor, want, what: str) -> None:
    want = np.asarray(want, dtype=np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    scale = float(np.max(np.abs(want)))
    assert err <= TOL * scale, f"{what}: {err} > {TOL} * {scale}"


@pytest.mark.parametrize("arch", ASSIGNED)
def test_smoke_forward_matches_reference(arch):
    jc, tc, params, tparams = _model(arch)
    toks, fe = _inputs(jc, 0, S)
    jb, tb = _batches(toks[:, :S], fe)
    want, aux = forward_train(params, jc, jb, remat=False)
    got, taux = t_train(tparams, tc, tb)
    assert got.shape == (B, S, tc.padded_vocab)
    assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(taux))
    _close(got, want, f"{arch} logits")
    assert taux.dtype == torch.float32 and taux.shape == ()
    assert abs(float(taux) - float(aux)) <= TOL * abs(float(aux))
    assert (float(aux) > 0) == (jc.arch_type == "moe")


_jax_decode = jax.jit(forward_decode, static_argnums=(1,))


@pytest.mark.parametrize("arch", NON_DENSE)
def test_prefill_and_decode_match_reference(arch):
    """The prompt's last logits, then four decode steps; the VLM's
    positions start after its patches."""
    jc, tc, params, tparams = _model(arch)
    toks, fe = _inputs(jc, 1, S)
    jb, tb = _batches(toks[:, :S], fe)
    off = jc.n_frontend_tokens if jc.arch_type == "vlm" else 0
    jl, jcaches = forward_prefill(params, jc, jb, cache_len=S + off + 8)
    tl, tcaches = t_prefill(tparams, tc, tb, cache_len=S + off + 8)
    _close(tl, jl, f"{arch} prefill")
    v = jc.vocab
    for i in range(4):
        tok = toks[:, S + i:S + i + 1]
        jl, jcaches = _jax_decode(params, jc, jnp.asarray(tok),
                                  jnp.asarray(S + off + i, jnp.int32),
                                  jcaches)
        tl, tcaches = t_decode(tparams, tc, torch.from_numpy(tok),
                               S + off + i, tcaches)
        _close(tl[..., :v], jl[..., :v], f"{arch} decode {i}")
        assert bool((tl[..., v:] == torch.finfo(tl.dtype).min).all())


@pytest.mark.parametrize("arch", ["internvl2-2b", "seamless-m4t-medium",
                                  "recurrentgemma-9b"])
def test_greedy_generate_matches_reference(arch):
    """With the stub frontend; recurrentgemma's prompt (40) is past its
    smoke window (32), so decode wraps the ring cache."""
    jc, tc, params, tparams = _model(arch)
    s = 40
    toks, fe = _inputs(jc, 2, s)
    want = jax_greedy(params, jc, jnp.asarray(toks[:, :s]), steps=4,
                      frontend=None if fe is None else jnp.asarray(fe))
    got = greedy_generate(tparams, tc, torch.from_numpy(toks[:, :s]),
                          steps=4, frontend=None if fe is None
                          else torch.from_numpy(fe))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", NON_DENSE)
def test_serve_launcher_runs_every_family_on_cpu(arch, capsys):
    out = tserve.main(["--arch", arch, "--device", "cpu", "--batch", "2",
                       "--prompt-len", "8", "--new-tokens", "3"])
    assert out.shape == (2, 11)
    assert f"{arch}: generated 2x3 tokens" in capsys.readouterr().out
