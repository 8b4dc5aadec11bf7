"""One f32 train step of the families that train on one card, at the long
branch, against the JAX package, on the CPU.

`tests/test_torch_train_zoo.py` steps every family at S = 32, where no
attention reaches the long branch (S·T >= FLASH_THRESHOLD = 2048²).
Here the smoke widths take it, as the full configurations do on the
card (`chip_smoke.py` phase 10c):

* internvl2-2b: 1024 stub patches ahead of 1024 tokens, batch 1 (S =
  2048, causal over the patches, the loss on the tokens alone);
* seamless-m4t-medium: 2048 stub frames through the encoder (the
  non-causal branch, whose lse feeds the blockwise backward) and a
  decoder of 32 tokens (dense, its cross attention dense too);
* minitron-4b (the squared-ReLU MLP) and mamba2-1.3b (the SSD chunked
  scan over 128 chunks) at S = 2048.

Each from the reference's own train state (`init_train_state(PRNGKey(0))`,
carried across by `convert.train_state_from_reference`), on numpy inputs
made from a seed: the loss and every gradient leaf of `make_grad_fn`
(remat on) within 1e-5 of `jax.value_and_grad` of the reference's
`make_loss_fn`, each against its own scale.

Then the long branch's calls in one remat loss and gradient, counted by
a wrapper patched onto `repro_torch.models.layers.flash_attention_train`
at 2048 tokens (and 2048 frames), against the count phase 10c holds the
card's kernel launches to: each encoder layer once (the encoder runs
outside the checkpoints) and not causal, each decoder attention layer
twice (its forward and its recompute), none in the SSD stack.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke
from repro.models import Batch
from repro.training.step import init_train_state as jax_init_train_state
from repro.training.step import make_loss_fn as jax_make_loss_fn
import repro_torch.configs as tconfigs
from repro_torch.convert import params_from_reference
from repro_torch.convert import train_state_from_reference
from repro_torch.models import Batch as TBatch
from repro_torch.models import init_params
from repro_torch.models import layers as tlayers
from repro_torch.training.step import make_grad_fn
from repro_torch.tree import named_leaves

F32 = dict(compute_dtype="float32", param_dtype="float32")
TOL = 1e-5
FLOOR = 1e-6
LONG = 2048


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def flash_calls(monkeypatch):
    """The `causal` flag of every long-branch call, in order."""
    calls: list = []
    inner = tlayers.flash_attention_train

    def counted(q, k, v, *, causal=True, **kwargs):
        calls.append(causal)
        return inner(q, k, v, causal=causal, **kwargs)

    monkeypatch.setattr(tlayers, "flash_attention_train", counted)
    return calls


def _configs(arch: str, frontend: int = 0):
    """(reference cfg, port cfg) of `arch` under `smoke()` in f32, with
    `frontend` stub positions where it has a frontend."""
    extra = {"n_frontend_tokens": frontend} if frontend else {}
    return (smoke(get_config(arch)).replace(**F32, **extra),
            tconfigs.smoke(tconfigs.get_config(arch)).replace(**F32, **extra))


def _batches(cfg, seq: int, frontend: int = 0, seed: int = 0):
    """(reference Batch, port Batch): one sequence of `seq` numpy ids, the
    labels shifted by one (-1 at the end), and `frontend` stub positions
    of 0.1 · N(0, 1) where given."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (1, seq)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((1, 1), -1, np.int32)],
                            axis=1)
    fe = None
    if frontend:
        fe = (0.1 * rng.standard_normal((1, frontend, cfg.d_model))
              ).astype(np.float32)
    jb = Batch(tokens=jax.numpy.asarray(toks),
               labels=jax.numpy.asarray(labels),
               frontend=None if fe is None else jax.numpy.asarray(fe))
    tb = TBatch(tokens=torch.from_numpy(toks),
                labels=torch.from_numpy(labels),
                frontend=None if fe is None else torch.from_numpy(fe))
    return jb, tb


def _close(got: torch.Tensor, want: torch.Tensor, label: str) -> None:
    """max |got - want| <= TOL * max(max |want|, FLOOR)."""
    err = float(torch.max(torch.abs(got - want)))
    scale = max(FLOOR, float(torch.max(torch.abs(want))))
    assert err <= TOL * scale, f"{label}: err {err} > {TOL} * {scale}"


# (arch, tokens, stub positions, the long-branch calls of the step:
# (causal, not causal))
CASES = [
    ("internvl2-2b", LONG - 1024, 1024, (4, 0)),
    ("seamless-m4t-medium", 32, LONG, (0, 2)),
    ("minitron-4b", LONG, 0, (4, 0)),
    ("mamba2-1.3b", LONG, 0, (0, 0)),
]


@pytest.mark.parametrize("arch, seq, frontend, calls", CASES,
                         ids=[c[0] for c in CASES])
def test_long_branch_step_matches_reference(arch, seq, frontend, calls,
                                            flash_calls):
    jc, tc = _configs(arch, frontend)
    jstate = jax_init_train_state(jax.random.PRNGKey(0), jc)
    jb, tb = _batches(jc, seq, frontend)

    (jloss, jparts), jgrads = jax.jit(jax.value_and_grad(
        jax_make_loss_fn(jc, remat=True), has_aux=True))(jstate.params, jb)
    state = train_state_from_reference(jstate, tc, "cpu")
    loss, parts, grads = make_grad_fn(tc, remat=True)(state.params, tb)
    assert (flash_calls.count(True), flash_calls.count(False)) == calls
    _close(loss, torch.tensor(float(jloss)), f"{arch} loss")
    _close(parts["aux"], torch.tensor(float(jparts["aux"])), f"{arch} aux")
    got = named_leaves(grads)
    want = named_leaves(params_from_reference(jgrads, tc, "cpu"))
    assert got.keys() == want.keys()
    for key, w in want.items():
        assert got[key].shape == w.shape and got[key].dtype == w.dtype
        _close(got[key], w, f"{arch} d{key}")


# smoke's 2 decoder layers (and 2 encoder layers): the count phase 10c
# takes from `flash_launches`
COUNTS = [
    ("internvl2-2b", LONG - 1024, 1024, (2 * 2, 0)),
    ("seamless-m4t-medium", LONG, LONG, (2 * 2, 2)),
    ("minitron-4b", LONG, 0, (2 * 2, 0)),
    ("mamba2-1.3b", LONG, 0, (0, 0)),
]


@pytest.mark.parametrize("arch, seq, frontend, calls", COUNTS,
                         ids=[c[0] for c in COUNTS])
def test_remat_step_counts_long_branch_calls(arch, seq, frontend, calls,
                                             flash_calls):
    _, tc = _configs(arch, frontend)
    params = init_params(torch.Generator().manual_seed(0), tc)
    _, tb = _batches(tc, seq, frontend, seed=1)
    loss, _, grads = make_grad_fn(tc, remat=True)(params, tb)
    assert bool(torch.isfinite(loss))
    assert all(bool(torch.isfinite(g).all())
               for g in named_leaves(grads).values())
    assert (flash_calls.count(True), flash_calls.count(False)) == calls
    if tc.arch_type == "encdec":
        # the encoder's calls come first, once each
        assert flash_calls[:tc.n_encoder_layers] == \
            [False] * tc.n_encoder_layers
