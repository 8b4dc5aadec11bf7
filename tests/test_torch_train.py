"""The port's training path against the JAX package, on the CPU.

The same inputs, made with numpy from a seed (or the reference's own
random parameters and train state, carried across by
`convert.train_state_from_reference`), go through both packages, in
float32, within 1e-5:

* `cross_entropy` (a padded vocabulary, -1 labels), `warmup_cosine`,
  `global_norm`, `adamw_update` and `adamw_init`/`init_train_state`;
* the blockwise flash attention's forward lse and its gradients against
  `jax.grad` of the reference's `attention_core.flash_attention`
  (`tests/test_attention_core.py::test_flash_gradients_match`'s shapes,
  block 16, causal, windowed and with `k_valid`);
* `flash_attention_train` (the model's long branch) at S = 2048 against
  `torch.autograd` through dense attention;
* one `make_train_step` on smoke granite at S = 2048 (the flash branch)
  against one `jax.jit(make_train_step)` step of the reference: loss,
  grad_norm, lr, the gradients, mu, nu, the master weights and the
  parameters;
* remat against no remat, microbatches against the full batch
  (`tests/test_arch_smoke.py::test_microbatched_grads_match_full_batch`)
  and a falling loss (`::test_loss_decreases_tiny_dense`);
* `synthetic_lm_batches`' structure, and `launch/train.py` on the CPU
  with a checkpoint saved and resumed.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config, smoke
from repro.models import Batch
from repro.models.attention_core import _flash_fwd as jax_flash_fwd
from repro.models.attention_core import flash_attention as jax_flash
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro.optim.adamw import adamw_update as jax_adamw_update
from repro.optim.adamw import global_norm as jax_global_norm
from repro.optim.adamw import warmup_cosine as jax_warmup_cosine
from repro.training.step import cross_entropy as jax_cross_entropy
from repro.training.step import init_train_state as jax_init_train_state
from repro.training.step import make_loss_fn as jax_make_loss_fn
from repro.training.step import make_train_step as jax_make_train_step
import repro_torch.configs as tconfigs
from repro_torch.checkpoint.io import restore_pytree
from repro_torch.convert import params_from_reference
from repro_torch.convert import train_state_from_reference
from repro_torch.data.synth_tokens import _markov_params, synthetic_lm_batches
from repro_torch.launch import train as ttrain
from repro_torch.models import Batch as TBatch
from repro_torch.models.attention_core import (
    flash_attention, flash_attention_bwd, flash_attention_with_lse,
)
from repro_torch.models.layers import flash_attention_train
from repro_torch.optim.adamw import (
    AdamWState, adamw_init, adamw_update, global_norm, warmup_cosine,
)
from repro_torch.training.step import (
    TrainState, cross_entropy, init_train_state, make_grad_fn,
    make_train_step,
)
from repro_torch.tree import named_leaves, tree_leaves, tree_map

F32 = dict(compute_dtype="float32", param_dtype="float32")
TOL = 1e-5
FLOOR = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got: torch.Tensor, want, label: str, tol: float = TOL,
           floor: float = FLOOR) -> None:
    """max |got - want| <= tol * max(max |want|, floor): each leaf or value
    against its own scale, so a leaf of small gradients is held as closely
    as a large one (FLOOR only keeps an all-zero leaf's bar above zero)."""
    want = np.array(want, dtype=np.float64)
    err = float(np.max(np.abs(got.detach().double().numpy() - want),
                       initial=0.0))
    scale = max(floor, float(np.max(np.abs(want), initial=0.0)))
    assert err <= tol * scale, f"{label}: err {err} > {tol} * {scale}"


# ---------------------------------------------------------------------------
# loss, schedule, optimizer
# ---------------------------------------------------------------------------

def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((2, 9, 24))).astype(np.float32)
    labels = rng.integers(0, 20, (2, 9)).astype(np.int32)
    labels[0, 3] = labels[1, -1] = -1
    for vocab in (None, 20):
        want = jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 vocab=vocab)
        got = cross_entropy(_t(logits), _t(labels), vocab=vocab)
        _close(got, want, f"cross_entropy vocab={vocab}")
    # every label masked: 0, not NaN
    none = np.full((2, 9), -1, np.int32)
    assert float(cross_entropy(_t(logits), _t(none), vocab=20)) == 0.0


def test_warmup_cosine_matches_reference():
    for step in (0, 1, 7, 20, 21, 55, 99, 100, 150):
        kw = dict(peak_lr=3e-4, warmup=20, total=100)
        want = jax_warmup_cosine(jnp.asarray(step, jnp.int32), **kw)
        got = warmup_cosine(torch.tensor(step, dtype=torch.int32), **kw)
        assert got.dtype == torch.float32
        _close(got, want, f"warmup_cosine step {step}", tol=1e-7)


def _tree(rng, scale=1.0):
    """Keys in sorted order, so both packages see the leaves in one order."""
    return {"a": (scale * rng.standard_normal((5, 7))).astype(np.float32),
            "layers": [{"b": (scale * rng.standard_normal((6,))
                              ).astype(np.float32),
                        "w": (scale * rng.standard_normal((3, 4, 2))
                              ).astype(np.float32)} for _ in range(2)]}


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def test_global_norm_matches_reference():
    tree = _tree(np.random.default_rng(1))
    _close(global_norm(tree_map(_t, tree)), jax_global_norm(_jtree(tree)),
           "global_norm")


@pytest.mark.parametrize("gscale", [0.1, 10.0])   # unclipped, clipped
def test_adamw_update_matches_reference(gscale):
    """Two updates from a state with moments, on the same f32 numbers:
    params, master, mu, nu, count and the metrics."""
    rng = np.random.default_rng(2)
    params = _tree(rng)
    jstate = jax_adamw_init(_jtree(params))
    tparams = tree_map(_t, params)
    tstate = adamw_init(tparams)
    for i in range(2):
        grads = _tree(rng, gscale)
        lr = jax_warmup_cosine(jnp.asarray(i + 3, jnp.int32), peak_lr=1e-2,
                               warmup=2, total=10)
        jp, jstate, jm = jax_adamw_update(_jtree(grads), jstate,
                                          _jtree(params), lr=lr)
        tp, tstate, tm = adamw_update(tree_map(_t, grads), tstate, tparams,
                                      lr=_t(lr))
        params = jax.tree.map(np.array, jp)
        for name, got, want in (("params", tp, jp),
                                ("master", tstate.master, jstate.master),
                                ("mu", tstate.mu, jstate.mu),
                                ("nu", tstate.nu, jstate.nu)):
            for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
                _close(g, w, f"update {i} {name}")
        assert int(tstate.count) == int(jstate.count) == i + 1
        _close(tm["grad_norm"], jm["grad_norm"], "grad_norm")
        _close(tm["lr"], jm["lr"], "lr", tol=1e-7)
    # written in place: the returned tensors are the ones passed in
    assert tp is tparams and tp["a"].data_ptr() == tparams["a"].data_ptr()


def test_adamw_init_and_init_train_state():
    """adamw_init as the reference's on the same parameters (the master an
    f32 copy that does not alias an f32 parameter); init_train_state's
    tree as the reference's, carried across."""
    cfg = smoke(get_config("granite-3-2b"))
    tc = tconfigs.smoke(tconfigs.get_config("granite-3-2b"))
    jstate = jax_init_train_state(jax.random.PRNGKey(0), cfg)
    params = params_from_reference(jstate.params, tc, "cpu")
    opt = adamw_init(params)
    want = train_state_from_reference(jstate, tc, "cpu")
    for name in ("master", "mu", "nu"):
        for g, w in zip(tree_leaves(getattr(opt, name)),
                        tree_leaves(getattr(want.opt, name))):
            assert g.dtype == w.dtype == torch.float32
            assert torch.equal(g, w), name
    assert int(opt.count) == 0 and opt.count.dtype == torch.int32
    f32 = {"w": torch.ones(3)}
    assert adamw_init(f32).master["w"].data_ptr() != f32["w"].data_ptr()

    state = init_train_state(torch.Generator().manual_seed(0), tc)
    assert isinstance(state, TrainState) and isinstance(state.opt, AdamWState)
    assert int(state.step) == 0 and state.step.dtype == torch.int32
    ref = _named(want.params, lambda x: (tuple(x.shape), x.dtype))
    assert _named(state.params, lambda x: (tuple(x.shape), x.dtype)) == ref
    for tree in (state.opt.master, state.opt.mu, state.opt.nu):
        assert _named(tree, lambda x: tuple(x.shape)) == \
            {k: shape for k, (shape, _) in ref.items()}


def _named(tree, fn) -> dict:
    """{path: fn(leaf)}."""
    return {k: fn(v) for k, v in named_leaves(tree).items()}


# ---------------------------------------------------------------------------
# flash attention's forward lse and backward
# ---------------------------------------------------------------------------

def _qkv(seed, b, s, n, k, h):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, s, n, h), (b, s, k, h), (b, s, k, h)))


MASKS = [dict(causal=True, window=0, valid=None),
         dict(causal=True, window=9, valid=None),
         dict(causal=False, window=0, valid=50),
         dict(causal=True, window=0, valid=40)]


@pytest.mark.parametrize("mask", MASKS,
                         ids=["causal", "window9", "noncausal-valid50",
                              "causal-valid40"])
def test_flash_gradients_match_reference(mask):
    """d(sum(out * w))/d(q, k, v) of the port's `flash_attention`
    (autograd through `_FlashGrouped`) against `jax.grad` of the
    reference's (its custom VJP), and the forward's lse against
    `_flash_fwd`'s."""
    q, k, v = _qkv(3, 2, 65, 4, 2, 32)
    w = np.random.default_rng(4).standard_normal(q.shape).astype(np.float32)
    S = q.shape[1]
    valid = (np.arange(S) < mask["valid"]) if mask["valid"] else \
        np.ones(S, bool)
    kw = dict(causal=mask["causal"], window=mask["window"], block=16)
    pos = np.arange(S)

    def jloss(q, k, v):
        out = jax_flash(q, k, v, q_pos=jnp.asarray(pos),
                        k_pos=jnp.asarray(pos), k_valid=jnp.asarray(valid),
                        **kw)
        return jnp.sum(out * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(tq, tk, tv, q_pos=_t(pos), k_pos=_t(pos),
                          k_valid=_t(valid), **kw)
    torch.sum(out * _t(w)).backward()
    for name, got, ref in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        _close(got, ref, f"d{name} {mask}")

    # the lse of the standard-layout forward, (B, N, S)
    qg = jnp.asarray(q).reshape(2, S, 2, 2, 32).transpose(0, 2, 3, 1, 4)
    _, jlse = jax_flash_fwd(qg, jnp.asarray(k).transpose(0, 2, 1, 3),
                            jnp.asarray(v).transpose(0, 2, 1, 3),
                            jnp.asarray(pos), jnp.asarray(pos),
                            jnp.asarray(valid), kw["causal"], kw["window"],
                            16)
    _, lse = flash_attention_with_lse(_t(q), _t(k), _t(v), q_pos=_t(pos),
                                      k_pos=_t(pos), k_valid=_t(valid), **kw)
    assert lse.shape == (2, 4, S) and lse.dtype == torch.float32
    _close(lse, np.array(jlse).reshape(2, 4, S), f"lse {mask}")


@pytest.mark.parametrize("causal, window, t", [(True, 0, 300),
                                               (False, 50, 100)])
def test_flash_attention_fwd_lse_wrapper_on_the_cpu(causal, window, t):
    """The kernel wrapper's training forward on CPU tensors: the plain
    version, the serving call's output bits, the reference's lse (rows
    that see no key at -1e30: non-causal, window 50, T = 100 leaves rows
    s >= 149 without a key); `use_kernel=True` raises, no launch."""
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.kernels.flash_attention import ops as flash_ops
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 300, 4, 64)).astype(np.float32)
    k, v = (rng.standard_normal((2, t, 2, 64)).astype(np.float32)
            for _ in range(2))
    before = dict(LAUNCHES)
    out, lse = flash_ops.flash_attention_fwd_lse(_t(q), _t(k), _t(v),
                                                 causal=causal, window=window)
    assert torch.equal(out, flash_ops.flash_attention(
        _t(q), _t(k), _t(v), causal=causal, window=window))
    qg = jnp.asarray(q).reshape(2, 300, 2, 2, 64).transpose(0, 2, 3, 1, 4)
    _, jlse = jax_flash_fwd(qg, jnp.asarray(k).transpose(0, 2, 1, 3),
                            jnp.asarray(v).transpose(0, 2, 1, 3),
                            jnp.arange(300), jnp.arange(t),
                            jnp.ones(t, bool), causal, window, 1024)
    want = np.array(jlse).reshape(2, 4, 300)
    seen = torch.from_numpy(want > -1e29)
    _close(lse[seen], want[want > -1e29], "lse")
    assert bool((lse[~seen] == -1e30).all())
    assert (want <= -1e29).any() == (not causal)
    with pytest.raises(ValueError, match="CUDA"):
        flash_ops.flash_attention_fwd_lse(_t(q), _t(k), _t(v),
                                          use_kernel=True)
    assert LAUNCHES == before


def _dense(q, k, v, causal, window):
    """Plain attention in f32, differentiable: (B,S,N,H), (B,T,K,H)."""
    B, S, N, H = q.shape
    K = k.shape[2]
    kk = k.repeat_interleave(N // K, dim=2)
    vv = v.repeat_interleave(N // K, dim=2)
    s = torch.einsum("bsnh,btnh->bnst", q, kk) / H ** 0.5
    i = torch.arange(S)[:, None]
    j = torch.arange(S)[None, :]
    m = torch.ones((S, S), dtype=torch.bool)
    if causal:
        m &= j <= i
    if window:
        m &= j > i - window
    p = torch.softmax(torch.where(m, s, -1e30), dim=-1)
    return torch.einsum("bnst,btnh->bsnh", p, vv)


@pytest.mark.parametrize("causal, window", [(True, 0), (True, 300),
                                            (False, 0)])
def test_flash_attention_train_matches_dense_autograd(causal, window):
    """The model's long branch (`flash_attention_train`, plain forward
    with its lse on the CPU, blockwise backward over two key blocks of
    1024) at S = 2048 against autograd through dense attention."""
    q, k, v = _qkv(5, 1, 2048, 4, 2, 64)
    w = np.random.default_rng(6).standard_normal(q.shape).astype(np.float32)
    grads = []
    for fn in (lambda a, b, c: flash_attention_train(
                   a, b, c, causal=causal, window=window),
               lambda a, b, c: _dense(a, b, c, causal, window)):
        ts = [_t(x).requires_grad_() for x in (q, k, v)]
        out = fn(*ts)
        torch.sum(out * _t(w)).backward()
        grads.append((out.detach(), *(t.grad for t in ts)))
    for name, got, ref in zip(("out", "dq", "dk", "dv"), *grads):
        _close(got, ref.numpy(), f"{name} causal={causal} window={window}")
    # no gradient to take: the kernel wrapper's forward call, no Function
    with torch.no_grad():
        out = flash_attention_train(*map(_t, (q, k, v)), causal=causal,
                                    window=window)
    assert out.grad_fn is None
    assert torch.equal(out, grads[0][0])


def test_flash_backward_recomputes_the_scores_as_the_forward_did():
    """`attention_core.flash_attention_bwd` after a forward that kept q·k
    in f32 (the CUDA kernel's; here the plain forward on the f32 upcast,
    its output rounded to bf16): with `scores_f32`, as
    `flash_attention_train` runs it after the kernel, bf16 q, k, v and
    dout give dq, dk, dv closer to the f32 backward's than with the
    scores rounded to bf16 first, a softmax that lse does not normalise
    (relative l2 0.0032 against 0.0044 for dq, 0.0023 against 0.0039 for
    dv here). In f32 the two are the same bits."""
    q, k, v = _qkv(12, 1, 512, 4, 2, 64)
    dout = np.random.default_rng(13).standard_normal(q.shape).astype(
        np.float32)
    q16, k16, v16, d16 = (_t(x).bfloat16() for x in (q, k, v, dout))
    up = [t.float() for t in (q16, k16, v16)]
    pos = torch.arange(512)
    kw = dict(causal=True, window=0)
    out, lse = flash_attention_with_lse(*up, q_pos=pos, k_pos=pos)
    want = flash_attention_bwd(*up, out, lse, d16.float(), **kw,
                               scores_f32=False)
    errs = {}
    for f32 in (True, False):
        got = flash_attention_bwd(q16, k16, v16, out.bfloat16(), lse, d16,
                                  **kw, scores_f32=f32)
        errs[f32] = [float(torch.linalg.vector_norm(g.float() - w)
                           / torch.linalg.vector_norm(w))
                     for g, w in zip(got, want)]
    for name, a, b in zip(("dq", "dk", "dv"), errs[True], errs[False]):
        assert a < 0.85 * b, (name, a, b)
    f32 = [_t(x) for x in (q, k, v)]
    out, lse = flash_attention_with_lse(*f32, q_pos=pos, k_pos=pos)
    for a, b in zip(*(flash_attention_bwd(*f32, out, lse, _t(dout), **kw,
                                          scores_f32=sf)
                      for sf in (True, False))):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

_STATES: dict = {}


def _granite(**changes):
    """(reference cfg, port cfg) of smoke granite in f32."""
    jc = smoke(get_config("granite-3-2b")).replace(**F32, **changes)
    tc = tconfigs.smoke(tconfigs.get_config("granite-3-2b")).replace(
        **F32, **changes)
    return jc, tc


def _tokens(cfg, b, s, seed=7):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((b, 1), -1, np.int32)],
                            axis=1)
    return toks, labels


def test_train_step_matches_reference_at_s2048():
    """One step of smoke granite in f32 (batch 1, S = 2048: the flash
    branch forward and backward in both packages) from the reference's
    state: loss, grad_norm, lr, every gradient leaf, and after the update
    mu, nu, the master weights and the parameters."""
    jc, tc = _granite()
    jstate = jax_init_train_state(jax.random.PRNGKey(0), jc)
    toks, labels = _tokens(jc, 1, 2048)
    jbatch = Batch(tokens=jnp.asarray(toks), labels=jnp.asarray(labels))
    tbatch = TBatch(tokens=_t(toks), labels=_t(labels))
    kw = dict(peak_lr=1e-3, warmup=4, total_steps=100)

    (jloss, _), jgrads = jax.value_and_grad(
        jax_make_loss_fn(jc, remat=True), has_aux=True)(jstate.params, jbatch)
    tstate = train_state_from_reference(jstate, tc, "cpu")
    tloss, _, tgrads = make_grad_fn(tc, remat=True)(tstate.params, tbatch)
    _close(tloss, jloss, "loss")
    for g, w in zip(tree_leaves(tgrads),
                    tree_leaves(params_from_reference(jgrads, tc, "cpu"))):
        assert g.shape == w.shape
        _close(g, w.numpy(), "a gradient leaf")

    js, jm = jax.jit(jax_make_train_step(jc, **kw))(jstate, jbatch)
    ts, tm = make_train_step(tc, **kw)(tstate, tbatch)
    for key in ("loss", "ce", "aux", "grad_norm", "lr"):
        _close(tm[key], jm[key], key)
    assert int(ts.step) == int(js.step) == 1
    assert int(ts.opt.count) == int(js.opt.count) == 1
    want = train_state_from_reference(js, tc, "cpu")
    for name, got, ref in (("mu", ts.opt.mu, want.opt.mu),
                           ("nu", ts.opt.nu, want.opt.nu)):
        for g, w in zip(tree_leaves(got), tree_leaves(ref)):
            _close(g, w.numpy(), name)
    # The update. At count 1, mu / c1 = g and sqrt(nu / c2) = |g| (g the
    # clipped gradient), so an element moves by lr · g / (|g| + eps):
    # ±lr, except where |g| is near eps = 1e-8, where the step's
    # derivative eps / (|g| + eps)^2 turns the gradients' 1e-5-level
    # differences into a visible share of lr. Those elements (0 < |g| <
    # 10 eps, found from the reference's mu = 0.1 g; 2 of 1.44 M here)
    # are held to the step's own bound 2 lr and must be few; every other
    # element, a zero gradient's (unseen tokens' embedding rows)
    # included, to 1e-5. Both bars are absolute, a unit weight's scale
    # (floor 1): where |g| is a few eps the same amplification leaves an
    # element of a zero-initialised leaf (a norm's scale, ±lr after the
    # step) off by 1.7e-5 of lr here: a bar relative to that leaf's own
    # scale would measure AdamW's amplification, not the gradient.
    lr = float(jm["lr"])
    small = 0
    for name, got, ref in (("master", ts.opt.master, want.opt.master),
                           ("params", ts.params, want.params)):
        for g, w, mu in zip(tree_leaves(got), tree_leaves(ref),
                            tree_leaves(want.opt.mu)):
            tiny = (torch.abs(mu) < 0.1 * 1e-7) & (mu != 0)
            _close(g[~tiny], w[~tiny].numpy(), name, floor=1.0)
            _close(g[tiny], w[tiny].numpy(), f"{name} where |g| < 1e-7",
                   tol=2 * lr, floor=1.0)
            small += int(tiny.sum())
    n = sum(p.numel() for p in tree_leaves(ts.params))
    assert small <= 1e-3 * 2 * n, \
        f"{small} of {n} elements with 0 < |g| < 1e-7"


def test_remat_gives_the_same_gradients():
    """remat=True (each layer checkpointed and recomputed, the flash
    branch's Function with it) and remat=False: the same gradients."""
    _, tc = _granite()
    state = init_train_state(torch.Generator().manual_seed(0), tc)
    toks, labels = _tokens(tc, 1, 2048, seed=8)
    batch = TBatch(tokens=_t(toks), labels=_t(labels))
    l1, _, g1 = make_grad_fn(tc, remat=True)(state.params, batch)
    l0, _, g0 = make_grad_fn(tc, remat=False)(state.params, batch)
    assert torch.equal(l1, l0)
    # the same bits, but for the embedding's: its backward is a threaded
    # scatter-add whose order varies from run to run, remat or not
    for key in g1:
        for a, b in zip(tree_leaves(g1[key]), tree_leaves(g0[key])):
            if key == "embed":
                _close(a, b.numpy(), "embed", tol=1e-6)
            else:
                assert torch.equal(a, b), key


def test_microbatched_grads_match_full_batch():
    """Gradient accumulation reproduces the full-batch step (the
    reference's bars: 5e-5 on the parameters, 1e-4 on the loss)."""
    _, tc = _granite()
    toks, labels = _tokens(tc, 2, 32, seed=9)
    batch = TBatch(tokens=_t(toks), labels=_t(labels))
    out = []
    for mb in (1, 2):
        state = init_train_state(torch.Generator().manual_seed(0), tc)
        out.append(make_train_step(tc, microbatches=mb)(state, batch))
    (s1, m1), (s2, m2) = out
    diff = max(float(torch.max(torch.abs(a - b)))
               for a, b in zip(tree_leaves(s1.params), tree_leaves(s2.params)))
    assert diff < 5e-5
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4


def test_loss_decreases_tiny_dense():
    """Eight steps on one fixed batch reduce the loss."""
    _, tc = _granite()
    state = init_train_state(torch.Generator().manual_seed(0), tc)
    step = make_train_step(tc, peak_lr=3e-3, warmup=1, total_steps=100)
    toks, _ = _tokens(tc, 2, 32, seed=10)
    batch = TBatch(tokens=_t(toks), labels=_t(toks))
    losses = []
    for _ in range(8):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]


# ---------------------------------------------------------------------------
# data and the launcher
# ---------------------------------------------------------------------------

def test_synthetic_lm_batches_structure():
    vocab, batch, seq = 50, 3, 40
    it = synthetic_lm_batches(torch.Generator().manual_seed(1), vocab=vocab,
                              batch=batch, seq=seq, frontend_shape=(6, 8))
    nxt, _ = _markov_params(torch.Generator().manual_seed(1), vocab)
    first = [next(it) for _ in range(3)]
    for b in first:
        assert b.tokens.shape == b.labels.shape == (batch, seq)
        assert b.tokens.dtype == b.labels.dtype == torch.int32
        assert torch.equal(b.labels[:, :-1], b.tokens[:, 1:])
        assert bool((b.labels[:, -1] == -1).all())
        assert bool(((b.tokens >= 0) & (b.tokens < vocab)).all())
        # every transition is one of the chain's 4 successors
        succ = nxt[b.tokens[:, :-1].long()]                  # (b, s-1, 4)
        assert bool((succ == b.tokens[:, 1:, None]).any(-1).all())
        assert b.frontend.shape == (batch, 6, 8)
        assert b.frontend.dtype == torch.float32
    fe = torch.cat([b.frontend.flatten() for b in first])
    assert abs(float(fe.mean())) < 0.02 and 0.08 < float(fe.std()) < 0.12
    assert not torch.equal(first[0].tokens, first[1].tokens)
    again = synthetic_lm_batches(torch.Generator().manual_seed(1),
                                 vocab=vocab, batch=batch, seq=seq,
                                 frontend_shape=(6, 8))
    for b, c in zip(first, again):
        assert all(torch.equal(x, y) for x, y in zip(b, c))
    assert next(synthetic_lm_batches(torch.Generator().manual_seed(1),
                                     vocab=vocab, batch=batch,
                                     seq=seq)).frontend is None


def test_train_launcher_saves_and_resumes(tmp_path):
    """`launch/train.py --device cpu`: 2 steps, the state saved, restored
    and trained on; `--model-axis 2` refused."""
    ck = str(tmp_path / "state")
    state, losses = ttrain.main(["--device", "cpu", "--steps", "2",
                                 "--batch", "2", "--seq", "32",
                                 "--checkpoint", ck])
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert int(state.step) == 2 and int(state.opt.count) == 2
    back = restore_pytree(ck, state)
    trees = [state.params, *state.opt[:3]]
    restored = _named([back.params, *back.opt[:3]], lambda x: x)
    for key, leaf in _named(trees, lambda x: x).items():
        assert torch.equal(restored[key], leaf), key
    assert int(back.step) == 2
    resumed, more = ttrain.main(["--device", "cpu", "--steps", "1",
                                 "--batch", "2", "--seq", "32",
                                 "--resume", ck])
    assert int(resumed.step) == 3 and np.isfinite(more[0])
    with pytest.raises(SystemExit, match="ROADMAP"):
        ttrain.main(["--device", "cpu", "--model-axis", "2"])
