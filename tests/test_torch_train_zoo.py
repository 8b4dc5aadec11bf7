"""One training step of every family of the zoo, against the JAX package,
on the CPU.

Each of the ten `ASSIGNED` configurations under `smoke()` in float32,
from the reference's own train state (`init_train_state(PRNGKey(0))`,
carried across by `convert.train_state_from_reference`), on token ids
(and the stub frontend of the enc-dec and VLM families) made with numpy
from a seed:

* the loss and every gradient leaf of `make_grad_fn` (remat on) within
  1e-5 of `jax.value_and_grad` of the reference's `make_loss_fn`: where a
  family's backward breaks in the port (a tensor that autograd saved
  written in place, a branch without a gradient) it shows here;
* then one `make_train_step`, as the reference's
  `tests/test_arch_smoke.py::test_smoke_train_step`: a finite loss,
  grad_norm > 0, step 1 and the parameters moved.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED, get_config, smoke
from repro.models import Batch
from repro.training.step import init_train_state as jax_init_train_state
from repro.training.step import make_loss_fn as jax_make_loss_fn
import repro_torch.configs as tconfigs
from repro_torch.convert import params_from_reference
from repro_torch.convert import train_state_from_reference
from repro_torch.models import Batch as TBatch
from repro_torch.training.step import make_grad_fn, make_train_step
from repro_torch.tree import named_leaves, tree_leaves

F32 = dict(compute_dtype="float32", param_dtype="float32")
B, S = 2, 32
TOL = 1e-5
FLOOR = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _batch(cfg, seed=0):
    """(reference Batch, port Batch) of the same numpy ids and frontend."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    fe = None
    if cfg.frontend:
        fe = (0.01 * rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model))).astype(np.float32)
    jb = Batch(tokens=jnp.asarray(toks), labels=jnp.asarray(toks),
               frontend=None if fe is None else jnp.asarray(fe))
    tb = TBatch(tokens=torch.from_numpy(toks), labels=torch.from_numpy(toks),
                frontend=None if fe is None else torch.from_numpy(fe))
    return jb, tb


def _close(got: torch.Tensor, want: torch.Tensor, label: str) -> None:
    """max |got - want| <= TOL * max(max |want|, FLOOR): each leaf against
    its own scale, so a leaf of small gradients is held as closely as a
    large one (FLOOR only keeps an all-zero leaf's bar above zero)."""
    err = float(torch.max(torch.abs(got - want)))
    scale = max(FLOOR, float(torch.max(torch.abs(want))))
    assert err <= TOL * scale, f"{label}: err {err} > {TOL} * {scale}"


@pytest.mark.parametrize("arch", ASSIGNED)
def test_smoke_train_step_matches_reference(arch):
    jc = smoke(get_config(arch)).replace(**F32)
    tc = tconfigs.smoke(tconfigs.get_config(arch)).replace(**F32)
    jstate = jax_init_train_state(jax.random.PRNGKey(0), jc)
    jb, tb = _batch(jc)

    (jloss, jparts), jgrads = jax.jit(jax.value_and_grad(
        jax_make_loss_fn(jc, remat=True), has_aux=True))(jstate.params, jb)
    state = train_state_from_reference(jstate, tc, "cpu")
    loss, parts, grads = make_grad_fn(tc, remat=True)(state.params, tb)
    _close(loss, torch.tensor(float(jloss)), f"{arch} loss")
    _close(parts["aux"], torch.tensor(float(jparts["aux"])), f"{arch} aux")
    got = named_leaves(grads)
    want = named_leaves(params_from_reference(jgrads, tc, "cpu"))
    assert got.keys() == want.keys()
    for key, w in want.items():
        assert got[key].shape == w.shape and got[key].dtype == w.dtype
        _close(got[key], w, f"{arch} d{key}")

    before = [p.clone() for p in tree_leaves(state.params)]
    state2, metrics = make_train_step(tc, peak_lr=1e-3, remat=True)(state, tb)
    assert bool(torch.isfinite(metrics["loss"]))
    assert bool(torch.isfinite(metrics["grad_norm"]))
    assert float(metrics["grad_norm"]) > 0.0
    assert int(state2.step) == 1
    assert any(not torch.equal(a, b)
               for a, b in zip(before, tree_leaves(state2.params)))
