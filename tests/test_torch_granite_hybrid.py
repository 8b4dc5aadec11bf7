"""granite-4.0-h-small's hybrid stack (`hybrid_moe`) on the CPU against the
plain reference (`repro_torch.testing.granite_hybrid_ref`), small and in
float32, on seeded random weights.

Tolerance `TOL` = 2e-5, relative (l2 norm of the difference over the
reference's, per output: the logits, the loss, each gradient leaf). Both
sides compute in float32, in other orders: the port's chunked SSD scan
against the reference's step-by-step recurrence, its grouped held
experts and k-ordered combine against one product and one `index_add`
an expert. The readings are about 1e-6 (the loss and logits 1e-7, the
worst leaf 1.4e-6). Each planted fault (RoPE on, the scale 1/sqrt(H), no
gated norm, no conv bias, routes dropped past a capacity) moves some
output by 1e-2 or more.
"""
from __future__ import annotations

import dataclasses
import math

import pytest
import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.configs import expert_share, get_config, smoke
from repro_torch.models import (
    Batch, forward_decode, forward_prefill, forward_train, init_params,
    moe as moe_mod,
)
from repro_torch.models import layers, ssd
from repro_torch.models.moe import grouped_mm, held_routes, moe_held_apply
from repro_torch.testing import granite_hybrid_ref as ref
from repro_torch.training.step import (
    init_train_state, make_grad_fn, make_train_step,
)
from repro_torch.tree import named_leaves

TOL = 2e-5
B, S = 2, 40


def config():
    """The smoke size in float32: Mamba-2, attention, Mamba-2; 8 routed
    experts, top 3, every one held."""
    cfg = smoke(get_config("granite-4.0-h-small")).replace(
        param_dtype="float32", compute_dtype="float32")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, n_experts=8,
                                              top_k=3))
    return cfg.replace(hybrid_moe=dataclasses.replace(cfg.hybrid_moe,
                                                      experts_held=8))


def rel(got, want) -> float:
    return float(torch.linalg.vector_norm((got - want).double())
                 / torch.linalg.vector_norm(want.double()))


def inputs(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    params = init_params(g, cfg)
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=g)
    labels = torch.randint(0, cfg.vocab, (B, S), generator=g)
    return params, tokens, labels


def gaps(cfg, params, tokens, labels):
    """The port's logits, loss and gradients against the reference's: the
    worst relative gap of each."""
    spec = ref.spec_of(cfg)
    want_loss, want = ref.loss_and_grads(params, spec, tokens, labels)
    logits = forward_train(params, cfg, Batch(tokens))[0]
    loss, _, grads = make_grad_fn(cfg)(params, Batch(tokens, labels))
    mine = named_leaves(grads)
    assert set(mine) == set(want)
    return {"logits": rel(logits, ref.logits_of(params, spec, tokens)),
            "loss": abs(float(loss - want_loss)) / float(want_loss),
            "grads": max(rel(mine[k], g) for k, g in want.items())}


def test_train_step_matches_the_reference():
    cfg = config()
    params, tokens, labels = inputs(cfg)
    got = gaps(cfg, params, tokens, labels)
    assert max(got.values()) < TOL, got


def test_train_step_runs_through_make_train_step():
    cfg = config()
    state = init_train_state(torch.Generator().manual_seed(3), cfg)
    _, tokens, labels = inputs(cfg)
    before = {k: v.clone() for k, v in named_leaves(state.params).items()}
    state, metrics = make_train_step(cfg)(state, Batch(tokens, labels))
    assert torch.isfinite(metrics["loss"]) and metrics["grad_norm"] > 0
    after = named_leaves(state.params)
    assert all(not torch.equal(after[k], v) for k, v in before.items()
               if k.endswith(("w_in", "wq", "w_gate", "router")))


def test_prefill_then_decode_matches_the_reference_forward():
    """Both cache kinds: the SSD state and conv window, the KV cache."""
    cfg = config()
    params, tokens, _ = inputs(cfg, seed=1)
    want = ref.logits_of(params, ref.spec_of(cfg), tokens)
    P = 24
    last, caches = forward_prefill(params, cfg, Batch(tokens[:, :P]),
                                   cache_len=S)
    assert rel(last[:, 0], want[:, P - 1]) < TOL
    kinds = [type(c).__name__ for c in caches["stack"]]
    assert kinds == ["SsdCache", "KVCache", "SsdCache"]
    for t in range(P, S):
        logits, caches = forward_decode(params, cfg, tokens[:, t:t + 1], t,
                                        caches)
        assert rel(logits[:, 0], want[:, t]) < TOL, t


def test_expert_shares_add_up_to_the_whole_layer():
    """Four disjoint shares of the experts: their held parts, with the
    shared expert counted once, give the uncut layer, as the reference
    computes it."""
    cfg = config()
    g = torch.Generator().manual_seed(4)
    p = init_params(g, cfg)["layers"][0]["moe"]
    x = torch.randn((B, S, cfg.d_model), generator=g)
    total = torch.zeros_like(x)
    for lo in range(0, 8, 2):
        part = expert_share(cfg, n_layers=cfg.n_layers, experts_held=2,
                            vocab=cfg.vocab, expert_offset=lo)
        held = dict(p, experts={k: v[lo:lo + 2]
                                for k, v in p["experts"].items()})
        total = total + moe_held_apply(held, x, part)
    whole = moe_held_apply(p, x, cfg)
    assert rel(total, whole) < TOL
    spec = ref.spec_of(cfg)
    sh = p["shared"]
    want = ref.moe_held(p, x, spec) + ref.swiglu(x, sh["w_gate"], sh["w_up"],
                                                 sh["w_down"])
    got = total + moe_mod.mlp_apply(sh, x, cfg.mlp_act)
    assert rel(got, want) < TOL


def test_dropless_under_a_router_skewed_to_one_expert():
    """Every token chooses expert 5 first: its group holds all T tokens,
    none is dropped, and the layer is the reference's."""
    cfg = config()
    g = torch.Generator().manual_seed(5)
    p = init_params(g, cfg)["layers"][0]["moe"]
    x = torch.randn((B, S, cfg.d_model), generator=g)
    p = dict(p, router=p["router"].clone())
    p["router"][:, 5] = 0.0
    x[..., 0] = 1.0
    p["router"][0, 5] = 100.0
    obs.reset()
    got = moe_held_apply(p, x, cfg)
    assert obs.counter_total("moe.routes_dropped") == 0
    assert obs.counter_total("moe.routes_held") == B * S * cfg.moe.top_k
    assert obs.hist_stats("moe.routes_max_expert")["max"] == B * S
    assert rel(got, ref.moe_held(p, x, ref.spec_of(cfg))) < TOL


def rope_on(monkeypatch, cfg):
    monkeypatch.setattr(layers, "uses_rope", lambda c: True)


def scale_inv_sqrt_h(monkeypatch, cfg):
    monkeypatch.setattr(layers, "softmax_scale", lambda c: None)


def no_gated_norm(monkeypatch, cfg):
    monkeypatch.setattr(ssd, "_gate", lambda p, y, z, c: y * F.silu(z))


def no_conv_bias(monkeypatch, cfg):
    monkeypatch.setattr(ssd, "_conv_act", lambda p, u, c, carry=None: F.silu(
        ssd._causal_depthwise_conv(u, p["conv_w"], carry=carry)))


def capacity_dropping(monkeypatch, cfg):
    """The reference MoE's capacity: an expert keeps its first
    ⌈T·K·1.25 / E⌉ routes and drops the rest."""
    orig = held_routes

    def capped(top_e, lo, n):
        T, K = top_e.shape
        E = cfg.moe.n_experts
        C = math.ceil(T * K * 1.25 / E)
        flat = top_e.reshape(-1)
        onehot = flat[:, None] == torch.arange(E)
        rank = torch.cumsum(onehot, 0)[torch.arange(T * K), flat] - 1
        return orig(torch.where((rank < C).reshape(T, K), top_e, -1), lo, n)
    monkeypatch.setattr(moe_mod, "held_routes", capped)


FAULTS = [rope_on, scale_inv_sqrt_h, no_gated_norm, no_conv_bias,
          capacity_dropping]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_planted_fault_fails(fault, monkeypatch):
    cfg = config()
    params, tokens, labels = inputs(cfg)
    fault(monkeypatch, cfg)
    got = gaps(cfg, params, tokens, labels)
    assert max(got.values()) > 100 * TOL, got


@pytest.mark.parametrize("counts", [[5, 0, 7, 1], [0, 0, 0, 9], [3, 3, 3, 3]])
def test_grouped_mm_and_its_gradients(counts):
    g = torch.Generator().manual_seed(6)
    R, K, N = sum(counts), 16, 12
    x = torch.randn((R, K), generator=g, requires_grad=True)
    w = torch.randn((len(counts), K, N), generator=g, requires_grad=True)
    obs.reset()
    y = grouped_mm(x, w, counts)
    rows = torch.repeat_interleave(torch.arange(len(counts)),
                                   torch.tensor(counts))
    want = torch.einsum("rk,rkn->rn", x, w[rows])
    assert torch.allclose(y, want, atol=1e-5)
    dy = torch.randn((R, N), generator=g)
    dx, dw = torch.autograd.grad(y, (x, w), dy)
    wx, ww = torch.autograd.grad(want, (x, w), dy)
    assert torch.allclose(dx, wx, atol=1e-5)
    assert torch.allclose(dw, ww, atol=1e-5)
    # the forward and the backward each open the products' span
    names = [ev["name"] for ev in obs.get_registry().trace_events()]
    assert names.count("model.moe.experts") == 2


def test_held_routes_group_every_held_choice():
    top_e = torch.tensor([[3, 1], [2, 3], [0, 1], [3, 2]])
    r = held_routes(top_e, 1, 3)              # experts 1, 2, 3 held
    assert r.counts == [2, 2, 3] and r.chosen == 7
    assert r.tok.tolist() == [0, 2, 1, 3, 0, 1, 3]
    assert r.held.tolist() == [[True, True], [True, True], [False, True],
                               [True, True]]
    for t in range(4):
        for k in range(2):
            if r.held[t, k]:
                assert r.tok[r.pos[t, k]] == t


def test_published_widths_and_the_card_share():
    cfg = get_config("granite-4.0-h-small")
    assert cfg.layer_kinds().count("attn+moe") == 4
    assert [i for i, k in enumerate(cfg.layer_kinds()) if k == "attn+moe"] \
        == [5, 15, 25, 35]
    assert round(cfg.param_count() / 1e9, 1) == 32.2
    assert round(cfg.active_param_count() / 1e9, 1) == 8.8
    share = expert_share(cfg, n_layers=10, experts_held=9, vocab=12544)
    assert share.padded_vocab == 12544
    assert round(share.param_count() / 1e9, 2) == 2.06
    with pytest.raises(ValueError):
        expert_share(cfg, n_layers=10, experts_held=9, vocab=12544,
                     expert_offset=64)


def test_reference_scan_derivative_is_the_recurrences(monkeypatch):
    """The reference's written-out backward of the SSD recurrence, over
    several blocks of time steps, against autograd through the same
    steps."""
    monkeypatch.setattr(ref, "SCAN_STEPS", 8)
    g = torch.Generator().manual_seed(7)
    b, S, H, P, N = 2, 30, 3, 4, 5
    u, Bm, Cm = (torch.randn(sh, generator=g, requires_grad=True) for sh in
                 ((b, S, H, P), (b, S, H, N), (b, S, H, N)))
    decay = torch.rand((b, S, H), generator=g).requires_grad_()
    dy = torch.randn((b, S, H, P), generator=g)
    got = torch.autograd.grad(ref._Scan.apply(u, decay, Bm, Cm),
                              (u, decay, Bm, Cm), dy)
    y = torch.einsum("bshpn,bshn->bshp",
                     ref._states(torch.zeros((b, H, P, N)), u, decay, Bm), Cm)
    want = torch.autograd.grad(y, (u, decay, Bm, Cm), dy)
    assert torch.allclose(ref._Scan.apply(u, decay, Bm, Cm), y)
    for a, w in zip(got, want):
        assert rel(a, w) < 1e-6
