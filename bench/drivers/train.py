"""A closed loop of `train_step` on one card's share of a
granitemoehybrid deployment (granite-4.0-h-small): the training job.

The configuration file gives the published config.json's keys with the
card's cut (its layers, the experts it holds, its slice of the
vocabulary), and the model is the port's registry entry cut by
`expert_share` to those numbers; off the card, its `small` keys replace
the widths (the CPU copies of the cell). Set-up draws the parameters
from the seed on the card (`init_train_state`) and `batches` batches of
`batch` x `seq` token ids, Zipf(`zipf_s`) over the vocabulary slice,
each label the next id; then one step, which builds the kernels and
leaves the allocator the blocks every later step takes. The window calls
the step back to back, each waiting for its result.

The window's first step is checked. Its state before (the AdamW master
weights and moments, on the host: a copy of a later step's would fall in
the window) is kept at set-up, and its master weights after it and its
loss in the window. After the window the plain float32 reference
(`bench/reference/granite_hybrid.py`) computes the loss and every
gradient leaf from the same parameters upcast to float32 and the same
batch, then applies its own plain AdamW to those gradients from the same
state (`OPTIMISER`, the step's learning rate): `update_gap` holds the
program's change of each weight to the reference's, the worst leaf
(`compare`). A step that computes the gradients but leaves the state as
it was reads 1 there. Every route to a held expert must have been
computed (`moe.routes_dropped` 0). `control` hands the same comparison
the reference run wholly in bf16.

A traced run profiles the window here (not through `devtrace.traced`),
reduces the events with `devtrace.reduce`, as every cell's trace, and
charges the same events to the program's obs spans
(`repro_torch.obs.torchprof.charge`): the device time of `model.moe`
and `model.ssd` by span, read by `moe_fwd_ms` and `ssd_fwd_ms`, and of
`model.moe.experts` (the held experts' products, forward, recompute and
backward), read by `expert_gemm_roofline`.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from bench import devtrace, harness, roofline_lm
from bench.reference import granite_hybrid as ref

def sized(ctx) -> tuple[dict, dict]:
    """The configuration and traffic files, with their `small` keys in
    place off the card."""
    conf, traffic = dict(ctx.cell.config), dict(ctx.cell.traffic)
    if ctx.device != "cuda":
        conf.update(conf.get("small", {}))
        traffic.update(traffic.get("small", {}))
    return conf, traffic


def model_config(c: dict):
    """The port's registry entry with the file's widths and cut."""
    from repro_torch.configs import expert_share, get_config
    base = get_config(c["model"])
    heads = c["num_attention_heads"]
    cfg = base.replace(
        d_model=c["hidden_size"], n_heads=heads,
        n_kv_heads=c["num_key_value_heads"],
        head_dim=c["hidden_size"] // heads, d_ff=c["intermediate_size"],
        norm_eps=c["rms_norm_eps"], param_dtype=c["dtype"],
        compute_dtype=c["dtype"],
        moe=dataclasses.replace(base.moe, n_experts=c["router_experts"],
                                top_k=c["num_experts_per_tok"],
                                d_expert=c["intermediate_size"]),
        ssd=dataclasses.replace(
            base.ssd, n_heads=c["mamba_n_heads"], head_dim=c["mamba_d_head"],
            state_dim=c["mamba_d_state"], n_groups=c["mamba_n_groups"],
            chunk=c["mamba_chunk_size"], conv_kernel=c["mamba_d_conv"]),
        hybrid_moe=dataclasses.replace(
            base.hybrid_moe, layer_types=tuple(c["layer_types"]),
            d_shared=c["shared_intermediate_size"],
            embedding_multiplier=c["embedding_multiplier"],
            residual_multiplier=c["residual_multiplier"],
            logits_scaling=c["logits_scaling"],
            attention_multiplier=c["attention_multiplier"]))
    return expert_share(cfg, n_layers=c["num_hidden_layers"],
                        experts_held=c["num_local_experts"],
                        vocab=c["vocab_size"],
                        expert_offset=c.get("expert_offset", 0))


def batches(seed: int, traffic: dict, vocab: int, device) -> list:
    """`batches` (tokens, labels) pairs from the seed: ids drawn Zipf over
    the vocabulary slice (rank r with weight r^-s), each sequence one
    longer than `seq`, its labels the ids shifted by one."""
    from repro_torch.models import Batch
    rng = np.random.default_rng(seed)
    w = np.arange(1, vocab + 1, dtype=np.float64) ** -traffic["zipf_s"]
    cdf = np.cumsum(w / w.sum())
    out = []
    for _ in range(traffic["batches"]):
        u = rng.random((traffic["batch"], traffic["seq"] + 1))
        ids = np.minimum(np.searchsorted(cdf, u), vocab - 1)
        seq = torch.as_tensor(ids, dtype=torch.int64, device=device)
        out.append(Batch(seq[:, :-1].contiguous(), seq[:, 1:].contiguous()))
    return out


# the optimiser's settings, `make_train_step`'s defaults, given to the
# program and the reference alike
OPTIMISER = {"peak_lr": 3e-4, "warmup": 100, "total_steps": 10000,
             "weight_decay": 0.1, "clip_norm": 1.0}


def warmed(ctx):
    """(configuration file, traffic, model configuration, batches, the
    train step, its state after one step): the set-up both a run and the
    control make. The step builds the kernels and leaves the allocator
    the blocks every later step takes."""
    from repro_torch.training.step import init_train_state, make_train_step
    conf, traffic = sized(ctx)
    cfg = model_config(conf)
    dev = torch.device(ctx.device)
    gen = torch.Generator(device=dev).manual_seed(ctx.seed)
    state = init_train_state(gen, cfg)
    data = batches(ctx.seed, traffic, cfg.vocab, dev)
    train_step = make_train_step(cfg, **OPTIMISER)
    state, _ = train_step(state, data[0])
    harness.sync(ctx.device)
    return conf, traffic, cfg, data, train_step, state


def on_host(state) -> dict:
    """A copy on the host of the state a step starts from: the AdamW
    master weights and moments by leaf path, the master weights also as
    the parameter tree, the count and the step."""
    from repro_torch.tree import named_leaves, tree_map
    master, mu, nu = (tree_map(lambda t: t.detach().to("cpu", copy=True),
                               tree)
                      for tree in (state.opt.master, state.opt.mu,
                                   state.opt.nu))
    return {"tree": master, "master": named_leaves(master),
            "mu": named_leaves(mu), "nu": named_leaves(nu),
            "count": int(state.opt.count), "step": int(state.step)}


def run(ctx: harness.Context) -> harness.Outcome:
    from repro_torch import obs
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.tree import named_leaves

    t_data = time.perf_counter()
    conf, traffic, cfg, data, train_step, state = warmed(ctx)
    t_warm = time.perf_counter()
    box = {"state": state}
    del state
    kept = {"before": on_host(box["state"])}
    calls, marks = [0], []

    def step():
        i = calls[0]
        t0 = time.time_ns()
        box["state"], m = train_step(box["state"], data[i % len(data)])
        harness.sync(ctx.device)
        marks.append((t0, time.time_ns(), "step"))
        if i == 0:                           # the checked step
            kept["loss"] = float(m["loss"])
            kept["after"] = {k: w.detach().clone() for k, w in
                             named_leaves(box["state"].opt.master).items()}
        calls[0] = i + 1

    t_kept = time.perf_counter()
    notes = [f"set-up: before the model {t_data - ctx.t_start:.3f} s, "
             f"its parameters, data and warm-up step {t_warm - t_data:.3f} "
             f"s, the checked step's state to the host "
             f"{t_kept - t_warm:.3f} s; "
             f"{cfg.param_count() / 1e9:.3f} B parameters held"]
    # the allocator keeps the warm-up's blocks, as a training job's does
    # from step to step: every run's warm-up is the same step
    if ctx.device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    obs.reset()
    before = dict(LAUNCHES)
    trace, charge, thread_note, n_calls, t0, t1 = window(ctx, step, marks)
    launches = harness.launches_delta(before, LAUNCHES)
    peak = harness.memory_peak(ctx.device)
    routes = obs.counter_total("moe.routes_held")
    dropped = obs.counter_total("moe.routes_dropped")
    widest = obs.hist_stats("moe.routes_max_expert") or {}

    # every layer's MoE runs twice a step under remat: forward, recompute
    fwd_routes = routes / max(n_calls, 1) / 2
    flops = roofline_lm.step_flops(conf, traffic["batch"], traffic["seq"],
                                   fwd_routes)
    gf, gb = roofline_lm.grouped_products(conf, fwd_routes)
    work = {"flops": n_calls * flops,
            "expert_gemm_bound_s": n_calls * roofline_lm.bound_s(gf, gb)}
    spans = {} if charge is None else {
        "device_s": {k: v[1] for k, v in charge.spans.items()},
        "idle_s": charge.idle}
    window_ = harness.Window(t1 - t0, n_calls, launches, spans, work, trace)
    notes += ["steps (ms): " + ", ".join(f"{(b - a) / 1e6:.1f}"
                                        for a, b, _ in marks),
              f"routes to held experts a step {fwd_routes:.0f} (forward), "
              f"the largest group {widest.get('max')}, dropped {dropped}; "
              f"model {flops / 1e12:.3f} TFLOP a step",
              f"memory peak {peak} B"]
    if charge is not None:
        notes.append("device ms a step by span (inclusive): " + ", ".join(
            f"{k} {v[1] / n_calls * 1e3:.2f}" for k, v in
            sorted(charge.spans.items(), key=lambda kv: -kv[1][1])))
        notes.append(thread_note)

    box.clear()                              # the state, before the check
    harness.release(ctx.device)
    checks = harness.Checks(ctx.cell.limits)
    checks.worst("routes_dropped", dropped)
    batch = data[0]
    del data
    gaps = verify(ctx, conf, cfg, checks, batch, kept)
    notes.append("the worst leaves' update gaps: " + ", ".join(
        f"{k} {g:.3e}" for g, k in gaps[:4]) + "; the worst but the "
        "routers': " + ", ".join(f"{k} {g:.3e}" for g, k in [
            x for x in gaps if not x[1].endswith("/router")][:3]))
    e2e = {"step_ms": (t1 - t0) / n_calls * 1e3,
           "setup_s": t0 - ctx.t_start}
    return harness.Outcome(e2e, window_, checks, n_calls, 0, peak, notes)


def window(ctx, step, marks):
    """The closed loop, profiled where the run is traced: (trace, span
    charge, calls, start, end), the first two None untraced."""
    if not ctx.trace:
        n, t0, t1 = harness.closed_loop(step, ctx.seconds)
        return None, None, "", n, t0, t1
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    from repro_torch.obs import torchprof
    threads = torchprof.thread_ids()
    kinds = [ProfilerActivity.CUDA] if ctx.device == "cuda" \
        else [ProfilerActivity.CPU]
    with profile(activities=kinds) as prof:
        w0 = time.time_ns()
        n, t0, t1 = harness.closed_loop(step, ctx.seconds)
        w1 = time.time_ns()
    threads.update(torchprof.thread_ids())
    events = prof.profiler.kineto_results.events()
    trace = devtrace.reduce(events, [(w0, w1, "window")] + marks)
    spans = [ev for ev in obs.get_registry().trace_events()
             if ev["ts_ns"] < w1 and ev["ts_ns"] + ev["dur_ns"] > w0]
    # the threads that opened spans, and whether the trace's launches
    # name each (a thread the map misses has its kernels charged outside)
    cuda = torch.autograd.DeviceType.CUDA
    launching = {threads.get(ev.device_resource_id(), ev.device_resource_id())
                 for ev in events
                 if ev.device_type() != cuda and ev.correlation_id()}
    tids: dict = {}
    for ev in spans:
        tids[ev["tid"]] = tids.get(ev["tid"], 0) + 1
    note = "spans in the window by thread (count, launches traced): " + \
        ", ".join(f"{t} ({c}, {t in launching})" for t, c in tids.items())
    return (trace, torchprof.charge(events, spans, w0, w1, threads), note, n,
            t0, t1)


def rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """‖got − want‖ / ‖want‖ in float64 (0 where both are 0)."""
    got, want = got.double(), want.double()
    den = torch.linalg.vector_norm(want)
    num = torch.linalg.vector_norm(got - want)
    return float(num / den) if den > 0 else float(num > 0)


def params_of(cfg, before: dict, device) -> dict:
    """The parameter tree a step started from, upcast to float32: each
    master weight cast to the parameters' dtype, as the program's
    parameters are, on `device`."""
    from repro_torch.tree import tree_map
    dtype = getattr(torch, cfg.param_dtype)
    return tree_map(lambda w: w.to(device).to(dtype).float(), before["tree"])


def compare(checks, before: dict, got_loss: float, got_after: dict,
            grads: dict, loss: float) -> list:
    """The loss, relative, and the worst leaf's `update_gap`: the program's
    change of the leaf's master weights over the step (`got_after` less
    the state before) against the change the reference's AdamW makes
    with the reference's gradients `grads`, ‖Δ − Δ_ref‖ / ‖Δ_ref‖.
    Returns the leaves' gaps, the largest first."""
    checks.worst("loss_gap", abs(got_loss - loss) / abs(loss))
    gaps = []
    for k, want in reference_changes(before, grads):
        dev = want.device
        got = got_after[k].to(dev, torch.float64) \
            - before["master"][k].to(dev, torch.float64)
        gaps.append((rel(got, want), k))
    gaps.sort(reverse=True)
    checks.worst("update_gap", gaps[0][0])
    return gaps


def reference(conf: dict, params: dict, batch, dtype):
    """The reference's (loss, gradients by leaf path) of the parameter
    tree `params` on `batch`, computed in `dtype`."""
    loss, grads = ref.loss_and_grads(params, ref.spec_from_json(conf),
                                     batch.tokens, batch.labels, dtype=dtype)
    return float(loss), grads


def verify(ctx, conf, cfg, checks, batch, kept: dict) -> list:
    """The comparison that decides `correct`: the checked step's loss and
    change of the weights against the float32 reference's on the same
    parameters, upcast, the same batch and the same AdamW state."""
    before = kept["before"]
    params = params_of(cfg, before, ctx.device)
    loss, grads = reference(conf, params, batch, torch.float32)
    del params
    return compare(checks, before, kept["loss"], kept.pop("after"), grads,
                   loss)


def reference_changes(before: dict, grads: dict):
    """(leaf path, Δw in float64) of the reference's AdamW step from the
    state `before` with the gradients `grads`, at the step's learning
    rate."""
    lr = ref.learning_rate(before["step"], peak_lr=OPTIMISER["peak_lr"],
                           warmup=OPTIMISER["warmup"],
                           total=OPTIMISER["total_steps"])
    return ref.adamw_changes(
        grads, before["master"], before["mu"], before["nu"],
        before["count"], lr, weight_decay=OPTIMISER["weight_decay"],
        clip_norm=OPTIMISER["clip_norm"])


def flips(a: list, b: list, experts: int) -> list:
    """Each layer's share of the tokens' top-k choices that differ between
    two forwards' routes (T, k) a layer."""
    out = []
    for x, y in zip(a, b):
        hot = [torch.zeros((x.shape[0], experts), dtype=torch.bool,
                           device=x.device).scatter_(1, t, True)
               for t in (x, y)]
        out.append(float((hot[0] & ~hot[1]).sum()) / x.numel())
    return out


def control(ctx, checks, chunks: int | None = None) -> None:
    """The reference wholly in bf16 (its SSD recurrence and softmax
    statistics too) in the program's place at the window's first step,
    from the state the program's warm-up step left, judged by `compare`;
    no route dropped. Also says, by layer, the share of the top-k routing
    choices that differ between the bf16 and the float32 forwards."""
    conf, _, cfg, data, _, state = warmed(ctx)
    before = on_host(state)
    del state
    harness.release(ctx.device)
    batch = data[0]
    params = params_of(cfg, before, ctx.device)
    loss, grads = reference(conf, params, batch, torch.bfloat16)
    # the master weights the control's step leaves, in float32
    after = {k: (before["master"][k].to(d.device, torch.float64) + d).float()
             for k, d in reference_changes(before, grads)}
    del grads
    want_loss, want = reference(conf, params, batch, torch.float32)
    checks.worst("routes_dropped", 0)
    gaps = compare(checks, before, loss, after, want, want_loss)
    del want, after
    harness.say("the worst but the routers' update gaps: " + ", ".join(
        f"{k} {g:.3e}" for g, k in [
            x for x in gaps if not x[1].endswith("/router")][:3]))
    spec = ref.spec_from_json(conf)
    routes = [], []
    for dtype, r in zip((torch.bfloat16, torch.float32), routes):
        ref.logits_of(params, spec, batch.tokens, dtype, routes=r)
    harness.say("routing choices that differ, bf16 against float32, by "
                "layer: " + ", ".join(
                    f"{f:.4f}" for f in flips(*routes, spec.n_experts)))
