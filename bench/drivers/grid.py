"""A closed loop of lambda selection: `sufficient_stats`, then
`solve_lasso_eq2_grid` over the traffic's values of lambda (every task
at every value, one batched solve), over data sets made at set-up and
cycled. A sample of the window's calls, drawn from the seed, is held by
`verify` to the plain reference of its data set; `control` hands the
reference's answers in TF32 to the same `verify`."""
from __future__ import annotations

import time

import torch

from bench import devtrace, harness, roofline
from bench.drivers import fit
from bench.reference import dsml as ref


def run(ctx: harness.Context) -> harness.Outcome:
    from repro_torch import obs
    from repro_torch.core import solve_lasso_eq2_grid, sufficient_stats
    from repro_torch.kernels import autotune
    from repro_torch.kernels.common import LAUNCHES

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    m, n, p = cfg["m"], cfg["n"], cfg["p"]
    iters = tr["iters"]
    lams = lambdas(ctx)
    k = len(lams)
    sets = fit.datasets(ctx)
    lam_t = torch.tensor(lams, dtype=torch.float32, device=ctx.device)
    calls = [0]

    def step():
        i = calls[0]
        d = i % len(sets)
        with devtrace.mark("grid"):
            S, c = sufficient_stats(sets[d].Xs, sets[d].ys)
            B = solve_lasso_eq2_grid(S, c, lam_t, iters=iters)
            harness.sync(ctx.device)
        kept.offer((d, B))
        calls[0] = i + 1

    kept = harness.Sample(ctx.seed)          # (data set, answer)
    t_data = time.perf_counter()
    step()                                   # warm-up: build, plans
    t_warm = time.perf_counter()
    calls[0], kept = 0, harness.Sample(ctx.seed)
    notes = [f"lambdas {lams}",
             f"set-up: to the data {t_data - ctx.t_start:.3f} s, the "
             f"warm-up call {t_warm - t_data:.3f} s"]
    if ctx.device == "cuda":
        plan = autotune.autotune_block(k * m, p, 1, device=ctx.device)
        rank = autotune.autotune_rank_block(m, n, p, device=ctx.device)
        notes.append(f"plans: fista_step ({k * m}, {p}, 1) {plan}; "
                     f"rank_update ({m}, {n}, {p}) {rank}")
    harness.release(ctx.device)              # the same start every run
    obs.reset()
    before = dict(LAUNCHES)
    with devtrace.traced(ctx.trace) as box:
        with devtrace.mark("window"):
            n_calls, t0, t1 = harness.closed_loop(step, ctx.seconds)
    launches = harness.launches_delta(before, LAUNCHES)
    peak = harness.memory_peak(ctx.device)

    gemv = roofline.bound_s(roofline.gemv_step_flops(k * m, p),
                            roofline.grid_step_bytes(m, p, k))
    flops = roofline.grid_flops(m, n, p, k, iters)
    work = {"gemv_bound_s": n_calls * iters * gemv,
            "flops": n_calls * flops}
    tiled = roofline.gemv_step_bytes(k * m, p) / roofline.HBM
    notes.append(f"work a call: {flops / 1e9:.6f} GFLOP; a step's bound "
                 f"{gemv * 1e3:.6f} ms (the {m} distinct Sigma read once), "
                 f"{tiled * 1e3:.6f} ms for the {k * m} tiled copies")
    window = harness.Window(t1 - t0, n_calls, launches, {}, work,
                            box["trace"])

    harness.release(ctx.device)
    checks = harness.Checks(ctx.cell.limits)
    notes.append(f"answers checked: {len(kept.items)} of {n_calls} calls")
    verify(ctx, checks, sets, kept.items)
    e2e = {"step_ms": (t1 - t0) / n_calls * 1e3,
           "setup_s": t0 - ctx.t_start}
    return harness.Outcome(e2e, window, checks, n_calls, 0, peak, notes)


def lambdas(ctx) -> list:
    return [ctx.cell.config["lam"] * r for r in ctx.cell.traffic["lam_ratios"]]


def verify(ctx, checks, sets: list, kept: list) -> None:
    """The comparison that decides `correct`: each (data set, (k, m, p)
    solutions) of `kept` against the float32 reference's grid."""
    with ref.precision("f32"):
        for i, d in enumerate(sets):
            mine = [a for j, a in kept if j == i]
            if not mine:
                continue
            want = ref.grid(d.Xs, d.ys, lambdas(ctx), ctx.cell.traffic["iters"])
            for got in mine:
                checks.worst("grid_gap", ref.gap(got, want))


def control(ctx, checks, chunks: int | None = None) -> None:
    """The reference in TF32 in the program's place, judged by `verify`."""
    sets = fit.datasets(ctx)
    with ref.precision("tf32"):
        kept = [(i, ref.grid(d.Xs, d.ys, lambdas(ctx),
                             ctx.cell.traffic["iters"]))
                for i, d in enumerate(sets)]
    verify(ctx, checks, sets, kept)
