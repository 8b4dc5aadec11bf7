"""A closed loop of `dsml_fit` (Algorithm 1 on one host) over data sets
made at set-up and cycled: the batch fit users run.

Set-up makes the data sets, then makes one call, which builds the
kernels and times their launch plans where the plan cache is cold. The
window calls `dsml_fit` back to back, each call waiting for its result.
A sample of the window's calls, drawn from the seed, is then held by
`verify` to the plain reference of its data set: beta_local, beta_u and
the support. `control` puts the reference in TF32 in the program's
place and hands its answers to the same `verify`.
"""
from __future__ import annotations

import time

import torch

from bench import datagen, devtrace, harness, roofline
from bench.reference import dsml as ref


def plans(m: int, p: int, n: int, device) -> str:
    """The launch plans the calls used, as the plan cache holds them."""
    from repro_torch.kernels import autotune
    if torch.device(device).type != "cuda":
        return "plans: the plain path (no kernels off the card)"
    gemv = autotune.autotune_block(m, p, 1, device=device)
    gemm = autotune.autotune_block(m, p, p, device=device)
    rank = autotune.autotune_rank_block(m, n, p, device=device)
    return (f"plans: fista_step ({m}, {p}, 1) {gemv}, ({m}, {p}, {p}) "
            f"{gemm}; rank_update ({m}, {n}, {p}) {rank}")


def datasets(ctx: harness.Context, m: int | None = None) -> list:
    """The traffic's data sets from the run's seed, `m` tasks each."""
    g = datagen.generator(ctx.seed, ctx.device)
    return [datagen.regression(g, ctx.cell.config, m=m)
            for _ in range(ctx.cell.traffic["datasets"])]


def run(ctx: harness.Context) -> harness.Outcome:
    from repro_torch import obs
    from repro_torch.core import dsml_fit
    from repro_torch.kernels.common import LAUNCHES

    cfg = ctx.cell.config
    m, n, p = cfg["m"], cfg["n"], cfg["p"]
    li, di = cfg["lasso_iters"], cfg["debias_iters"]
    sets = datasets(ctx)
    args = (cfg["lam"], cfg["mu"], cfg["Lam"])
    calls = [0]

    def step():
        i = calls[0]
        d = i % len(sets)
        with devtrace.mark("fit"):
            r = dsml_fit(sets[d].Xs, sets[d].ys, *args, lasso_iters=li,
                         debias_iters=di)
            harness.sync(ctx.device)
        kept.offer((d, answer(r)))
        calls[0] = i + 1

    kept = harness.Sample(ctx.seed)          # (data set, answer)
    t_data = time.perf_counter()
    step()                                   # warm-up: build, plans
    t_warm = time.perf_counter()
    calls[0], kept = 0, harness.Sample(ctx.seed)
    notes = [plans(m, p, n, ctx.device),
             f"set-up: to the data {t_data - ctx.t_start:.3f} s, the "
             f"warm-up call {t_warm - t_data:.3f} s"]
    harness.release(ctx.device)              # the same start every run
    obs.reset()
    before = dict(LAUNCHES)
    with devtrace.traced(ctx.trace) as box:
        with devtrace.mark("window"):
            n_calls, t0, t1 = harness.closed_loop(step, ctx.seconds)
    launches = harness.launches_delta(before, LAUNCHES)
    peak = harness.memory_peak(ctx.device)

    gemm = roofline.bound_s(roofline.gemm_step_flops(m, p, p),
                            roofline.gemm_step_bytes(m, p, p))
    gemv = roofline.bound_s(roofline.gemv_step_flops(m, p),
                            roofline.gemv_step_bytes(m, p))
    flops = roofline.fit_flops(m, n, p, li, di)
    work = {"gemm_bound_s": n_calls * di * gemm,
            "gemv_bound_s": n_calls * li * gemv, "flops": n_calls * flops}
    fma = roofline.gemm_step_flops(m, p, p) / roofline.FP32_FMA
    notes.append(f"work a call: {flops / 1e12:.6f} TFLOP; the debias GEMM "
                 f"step's bound {gemm * 1e3:.6f} ms at 165 TFLOP/s "
                 f"({fma * 1e3:.6f} ms at the 67 TFLOP/s FP32 FMA peak)")
    window = harness.Window(t1 - t0, n_calls, launches, {}, work,
                            box["trace"])

    harness.release(ctx.device)
    checks = harness.Checks(ctx.cell.limits)
    notes.append(f"answers checked: {len(kept.items)} of {n_calls} calls")
    verify(ctx, checks, sets, kept.items)
    e2e = {"step_ms": (t1 - t0) / n_calls * 1e3,
           "setup_s": t0 - ctx.t_start}
    return harness.Outcome(e2e, window, checks, n_calls, 0, peak, notes)


def answer(r) -> dict:
    """What a call's result is judged by."""
    return {"beta_local": r.beta_local, "beta_u": r.beta_u,
            "support": r.support}


def compare(checks: harness.Checks, got: dict, want: dict) -> None:
    checks.worst("beta_local_gap", ref.gap(got["beta_local"],
                                           want["beta_local"]))
    checks.worst("beta_u_gap", ref.gap(got["beta_u"], want["beta_u"]))
    checks.worst("support_diff", ref.mismatches(got["support"],
                                                want["support"]))


def verify(ctx, checks, sets: list, kept: list) -> None:
    """The comparison that decides `correct`: each (data set, answer) of
    `kept` against the float32 reference's fit of that data set."""
    cfg = ctx.cell.config
    with ref.precision("f32"):
        for i, d in enumerate(sets):
            mine = [a for j, a in kept if j == i]
            if not mine:
                continue
            want = ref.fit(d.Xs, d.ys, cfg["lam"], cfg["mu"], cfg["Lam"],
                           cfg["lasso_iters"], cfg["debias_iters"])
            for got in mine:
                compare(checks, got, want)


def control(ctx, checks, chunks: int | None = None) -> None:
    """The reference in TF32 in the program's place, one answer a data
    set, judged by `verify`."""
    cfg = ctx.cell.config
    sets = datasets(ctx)
    with ref.precision("tf32"):
        kept = [(i, ref.fit(d.Xs, d.ys, cfg["lam"], cfg["mu"], cfg["Lam"],
                            cfg["lasso_iters"], cfg["debias_iters"]))
                for i, d in enumerate(sets)]
    verify(ctx, checks, sets, kept)
