"""The training cell (`bench/drivers/train.py`) on the CPU at its
configuration's `small` size: it runs correct, each planted fault (in the
model, in the routing, in the optimiser's update) comes out not correct, the benchmark's copy of the reference computes what the
repository's does, the configuration file is the registry's entry cut to
the card's share, and the step's FLOPs count follows its closed form."""
from __future__ import annotations

import dataclasses
import json
import math

import pytest
import torch

from bench import harness, roofline_lm, run
from bench.drivers import train
from bench.reference import granite_hybrid as bench_ref
from conftest import make_small_root

import repro_torch.models.layers as layers
import repro_torch.models.moe as moe
import repro_torch.models.ssd as ssd
import repro_torch.training.step as step_mod
from repro_torch.configs import expert_share, get_config
from repro_torch.testing import granite_hybrid_ref as repo_ref
from repro_torch.tree import tree_map

CELL = "granite-4.0-h-small.train-8k"


def run_line(root, capsys, seed=2147483659):
    rc = run.main(["--workload", CELL, "--seed", str(seed), "--seconds",
                   "0.5", "--root", str(root)], device="cpu")
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_small_cell_is_correct(small_root, capsys):
    line = run_line(small_root, capsys)
    assert line["correct"] is True, line["checks"]
    assert line["checks"]["routes_dropped"]["value"] == 0


def rope_on(monkeypatch):
    monkeypatch.setattr(layers, "uses_rope", lambda cfg: True)


def scale_inv_sqrt_h(monkeypatch):
    monkeypatch.setattr(layers, "softmax_scale", lambda cfg: None)


def no_gated_norm(monkeypatch):
    monkeypatch.setattr(ssd, "_gate",
                        lambda p, y, z, cfg: y * torch.nn.functional.silu(z))


def no_conv_bias(monkeypatch):
    monkeypatch.setattr(ssd, "_conv_act", lambda p, u, cfg, carry=None:
                        torch.nn.functional.silu(ssd._causal_depthwise_conv(
                            u, p["conv_w"], carry=carry)))


def capacity_dropping(monkeypatch):
    """Each expert keeps its first ⌈T·K·1.25 / E⌉ choices, as the
    capacity-bounded layer does, and drops the rest."""
    orig = moe.held_routes

    def capped(top_e, lo, n):
        T, K = top_e.shape
        E = int(top_e.max()) + 1
        C = math.ceil(T * K * 1.25 / E)
        flat = top_e.reshape(-1)
        onehot = flat[:, None] == torch.arange(E)
        rank = torch.cumsum(onehot, 0)[torch.arange(T * K), flat] - 1
        return orig(torch.where((rank < C).reshape(T, K), top_e, -1), lo, n)
    monkeypatch.setattr(moe, "held_routes", capped)


def state_unchanged(monkeypatch):
    """The step computes its loss and gradients and leaves the weights and
    the AdamW state as they were."""
    def kept(grads, state, params, *, lr, **kw):
        return params, state, {"grad_norm": torch.zeros(()), "lr": lr}
    monkeypatch.setattr(step_mod, "adamw_update", kept)


def lr_doubled(monkeypatch):
    """AdamW at twice the schedule's learning rate."""
    orig = step_mod.adamw_update

    def doubled(grads, state, params, *, lr, **kw):
        return orig(grads, state, params, lr=2 * lr, **kw)
    monkeypatch.setattr(step_mod, "adamw_update", doubled)


FAULTS = [rope_on, scale_inv_sqrt_h, no_gated_norm, no_conv_bias,
          capacity_dropping, state_unchanged, lr_doubled]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_planted_fault_is_not_correct(small_root, monkeypatch, capsys,
                                      fault):
    fault(monkeypatch)
    line = run_line(small_root, capsys)
    assert line["correct"] is False, line["checks"]


def test_bench_reference_is_the_repositorys(tmp_path):
    root = make_small_root(tmp_path)
    cell = harness.cell(harness.load_spec(root), CELL, root)
    ctx = harness.Context(cell, 7, 1.0, False, "cpu", 0.0)
    conf, traffic = train.sized(ctx)
    cfg = train.model_config(conf)
    from repro_torch.models import init_params
    params = tree_map(lambda p: p.float(),
                      init_params(torch.Generator().manual_seed(7), cfg))
    batch = train.batches(7, traffic, cfg.vocab, "cpu")[0]
    spec = bench_ref.spec_from_json(conf)
    assert dataclasses.astuple(spec) == \
        dataclasses.astuple(repo_ref.spec_of(cfg))
    a = bench_ref.loss_and_grads(params, spec, batch.tokens, batch.labels)
    b = repo_ref.loss_and_grads(params, repo_ref.spec_of(cfg), batch.tokens,
                                batch.labels)
    # the same code, its sums threaded in another order run to run
    assert torch.allclose(a[0], b[0], rtol=1e-6, atol=0)
    assert a[1].keys() == b[1].keys()
    for k in a[1]:
        scale = torch.max(torch.abs(b[1][k]))
        assert torch.max(torch.abs(a[1][k] - b[1][k])) <= 1e-5 * scale, k


def test_configuration_is_the_registrys_share():
    cell = harness.cell(harness.load_spec(), CELL)
    conf = cell.config
    want = expert_share(get_config("granite-4.0-h-small"), n_layers=10,
                        experts_held=9, vocab=12544)
    assert train.model_config(conf) == want
    assert (conf["num_hidden_layers"], conf["num_local_experts"],
            conf["vocab_size"]) == (10, 9, 12544)
    assert conf["published"]["layer_types"][:10] == conf["layer_types"]


def test_step_flops_closed_form():
    conf = harness.cell(harness.load_spec(), CELL).config
    T, R = 2 * 8192, 20480 * 10
    d, V = 4096, 12544
    mamba = d * (2 * 8192 + 2 * 128 + 128) + 8192 * d
    attn = 2 * d * 32 * 128 + 2 * d * 8 * 128
    dense = 9 * mamba + attn + 10 * (3 * d * 1536 + d * 72) + d * V
    ssd_f = 9 * 2 * T * 128 * (256 * 128 / 2 + 256 * 64 / 2 + 2 * 128 * 64)
    att_f = 2 * 2 * 32 * 8192 ** 2 * 128
    want = 6 * (dense * T + R * 3 * d * 768) + 3 * (att_f + ssd_f)
    assert roofline_lm.step_flops(conf, 2, 8192, R) == pytest.approx(want)
    flops, nbytes = roofline_lm.grouped_products(conf, R)
    assert flops == 12 * 2 * R * d * 768
    assert nbytes == 12 * 2 * (R * (d + 768) + 10 * 9 * d * 768)


@pytest.mark.parametrize("count", [0, 1, 5])
def test_reference_adamw_is_the_programs(count):
    """The reference's plain AdamW (`adamw_changes`, at `learning_rate`)
    changes every weight as the program's `adamw_update` does from the
    same state and gradients, in float32: within 1e-4 of the change, the
    clip (a gradient norm over 1) and the decay included. The weights are
    about 1e-3, so that the float32 rounding of the new weight is about
    1e-5 of a change of about 6e-6."""
    from repro_torch.optim.adamw import (
        AdamWState, adamw_update, warmup_cosine,
    )
    g = torch.Generator().manual_seed(count)
    shapes = {"a": (7, 5), "b": (3,), "c": (2, 4, 3)}
    master = {k: 1e-3 * torch.randn(s, generator=g)
              for k, s in shapes.items()}
    mu = {k: 0.1 * torch.randn(s, generator=g) for k, s in shapes.items()}
    nu = {k: 0.01 * torch.rand(s, generator=g) for k, s in shapes.items()}
    grads = {k: 3 * torch.randn(s, generator=g) for k, s in shapes.items()}
    step = count + 1
    state = AdamWState({k: v.clone() for k, v in master.items()},
                       {k: v.clone() for k, v in mu.items()},
                       {k: v.clone() for k, v in nu.items()},
                       torch.tensor(count, dtype=torch.int32))
    params = {k: v.clone() for k, v in master.items()}
    lr = warmup_cosine(torch.tensor(step), peak_lr=3e-4, warmup=100,
                       total=10000)
    adamw_update(grads, state, params, lr=lr, weight_decay=0.1,
                 clip_norm=1.0)
    want = dict(bench_ref.adamw_changes(
        grads, master, mu, nu, count,
        bench_ref.learning_rate(step, peak_lr=3e-4, warmup=100,
                                total=10000),
        weight_decay=0.1, clip_norm=1.0))
    for k in shapes:
        got = state.master[k].double() - master[k].double()
        assert torch.linalg.vector_norm(got - want[k]) <= \
            1e-4 * torch.linalg.vector_norm(want[k]), k
