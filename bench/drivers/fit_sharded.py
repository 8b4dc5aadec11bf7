"""`dsml_fit_sharded` across cards: one process a card, each the worker
of its own block of tasks, joined in one process group (NCCL on the
cards). The only exchange of a fit is the paper's one round, an
all-gather of the debiased rows. Weak scaling: every card holds the
configuration's m tasks.

The process the benchmark starts is rank 0. It builds the kernels once,
starts the other ranks (`run.py --rank r`), runs its own share, and
waits for every rank to end. The ranks meet through a `file://`
rendezvous under `TMPDIR`. Each rank makes every task's data from the
seed (the support is shared by all tasks) and keeps its block. After
one warm-up fit they run fits back to back; after each, rank 0
broadcasts whether the window has closed, so every rank runs the same
calls. Each rank then holds its rows to the plain reference of its
block, and the gathered rows and the support to the reference's, through
`compare`; `control` hands the reference's answers in TF32 to the same
`compare`, its ranks' blocks computed in turn on one card.
"""
from __future__ import annotations

import datetime
import os
import shutil
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from bench import datagen, devtrace, harness, roofline
from bench.reference import dsml as ref

WAIT_S = 120.0
# the numbers a rank compares, in the order `compare` returns them
GAPS = ("beta_local_gap", "beta_u_gap", "gathered_gap", "support_diff")


def block_sets(ctx, rank: int, world: int, dev) -> list:
    """Rank `rank`'s (X, y) blocks of the traffic's data sets: every task
    of every rank is drawn from the seed, so the support is shared."""
    m = ctx.cell.config["m"]
    g = datagen.generator(ctx.seed, dev)
    blk = slice(rank * m, (rank + 1) * m)
    sets = []
    for _ in range(ctx.cell.traffic["datasets"]):
        d = datagen.regression(g, ctx.cell.config, m=m * world)
        sets.append((d.Xs[blk].contiguous(), d.ys[blk].contiguous()))
    return sets


def run(ctx: harness.Context) -> harness.Outcome:
    world = ctx.cell.traffic["ranks"]
    if ctx.device == "cuda":
        from repro_torch.kernels import _build
        _build.build()                       # once, before the ranks load
    tmp = tempfile.mkdtemp(prefix="bench-rendezvous-")
    init = os.path.join(tmp, "init")
    procs = [subprocess.Popen(
        [sys.executable, str(harness.BENCH / "run.py"), *ctx.argv,
         "--rank", str(r), "--init", init, "--device", ctx.device])
        for r in range(1, world)]
    try:
        out = rank_run(ctx, 0, world, init)
        codes = [p.wait(timeout=WAIT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    if any(codes):
        raise RuntimeError(f"ranks 1..{world - 1} exited with {codes}")
    return out


def rank_run(ctx: harness.Context, rank: int, world: int, init: str):
    from repro_torch import obs
    from repro_torch.core import dsml_fit_sharded
    from repro_torch.kernels.common import LAUNCHES

    cuda = ctx.device == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"file://{init}", world_size=world,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=WAIT_S))
    try:
        return _rank_body(ctx, rank, world, dev, dsml_fit_sharded, obs,
                          LAUNCHES)
    finally:
        dist.destroy_process_group()


def _rank_body(ctx, rank, world, dev, dsml_fit_sharded, obs, LAUNCHES):
    cfg = ctx.cell.config
    m, n, p = cfg["m"], cfg["n"], cfg["p"]
    li, di = cfg["lasso_iters"], cfg["debias_iters"]
    sets = block_sets(ctx, rank, world, dev)
    args = (cfg["lam"], cfg["mu"], cfg["Lam"])
    calls = [0]

    def step():
        i = calls[0]
        d = i % len(sets)
        with devtrace.mark("fit"):
            r = dsml_fit_sharded(*sets[d], *args, lasso_iters=li,
                                 debias_iters=di)
            harness.sync(ctx.device)
        kept.offer((d, answer(r)))
        calls[0] = i + 1

    kept = harness.Sample(ctx.seed)          # (data set, answer)
    t_data = time.perf_counter()
    step()                                   # warm-up
    t_warm = time.perf_counter()
    calls[0], kept = 0, harness.Sample(ctx.seed)
    harness.release(ctx.device)              # the same start every run
    flag = torch.zeros(1, device=dev)
    dist.barrier()
    obs.reset()
    before = dict(LAUNCHES)
    with devtrace.traced(ctx.trace) as box:
        with devtrace.mark("window"):
            t0 = time.perf_counter()
            while True:
                step()
                if rank == 0:
                    flag.fill_(float(time.perf_counter() - t0
                                     >= ctx.seconds))
                dist.broadcast(flag, 0)
                if flag.item():
                    break
            t1 = time.perf_counter()
    n_calls = calls[0]
    launches = harness.launches_delta(before, LAUNCHES)
    wire = obs.counter_total("collective.bytes", op="all_gather_tasks")
    peak = torch.tensor([float(harness.memory_peak(ctx.device))],
                        dtype=torch.float64, device=dev)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX)

    trace = box["trace"]
    if trace is not None:
        busy = torch.tensor([trace.busy_s], dtype=torch.float64, device=dev)
        dist.all_reduce(busy)
        trace = trace._replace(busy_s=busy.item() / world)

    harness.release(ctx.device)
    gaps = torch.zeros(len(GAPS), dtype=torch.float64, device=dev)
    with ref.precision("f32"):
        for i, (X, y) in enumerate(sets):
            want = ref.local_fit(X, y, args[0], args[1], li, di)
            rows = [torch.empty((m, p), device=dev) for _ in range(world)]
            dist.all_gather(rows, want["beta_u"].contiguous())
            B_all = torch.cat(rows)
            for got in (r for j, r in kept.items if j == i):
                gaps = torch.maximum(gaps, torch.tensor(
                    compare(got, want, B_all, args[2]), dtype=torch.float64,
                    device=dev))
    dist.all_reduce(gaps, op=dist.ReduceOp.MAX)
    if rank:
        return None

    checks = harness.Checks(ctx.cell.limits)
    for name, v in zip(GAPS, gaps.tolist()):
        checks.worst(name, v)
    gemm = roofline.bound_s(roofline.gemm_step_flops(m, p, p),
                            roofline.gemm_step_bytes(m, p, p))
    gemv = roofline.bound_s(roofline.gemv_step_flops(m, p),
                            roofline.gemv_step_bytes(m, p))
    flops = roofline.fit_flops(m, n, p, li, di)
    work = {"gemm_bound_s": n_calls * di * gemm,
            "gemv_bound_s": n_calls * li * gemv, "flops": n_calls * flops}
    window = harness.Window(t1 - t0, n_calls, launches, {}, work, trace)
    notes = [f"ranks {world}, {m} tasks a rank; all_gather_tasks "
             f"{wire / max(n_calls, 1):.0f} bytes on the wire a fit "
             f"(collective.bytes); the rules' plans",
             f"set-up: to the data {t_data - ctx.t_start:.3f} s, the "
             f"warm-up call {t_warm - t_data:.3f} s; answers checked on "
             f"rank 0: {len(kept.items)} of {n_calls} calls"]
    e2e = {"step_ms": (t1 - t0) / n_calls * 1e3,
           "setup_s": t0 - ctx.t_start}
    return harness.Outcome(e2e, window, checks, n_calls, 0,
                           int(peak.item()), notes)


def answer(r) -> dict:
    """What a rank's result is judged by."""
    return {"beta_local": r.beta_local, "beta_u": r.beta_u,
            "beta_u_all": r.beta_u_all, "support": r.support}


def compare(got: dict, want: dict, want_all, Lam: float) -> list:
    """A rank's answer against the reference of its block (`want`) and of
    every block (`want_all`, the gathered rows): the numbers of GAPS."""
    return [ref.gap(got["beta_local"], want["beta_local"]),
            ref.gap(got["beta_u"], want["beta_u"]),
            ref.gap(got["beta_u_all"], want_all),
            ref.mismatches(got["support"], ref.threshold(want_all, Lam))]


def control(ctx, checks, chunks: int | None = None) -> None:
    """The reference in TF32 in the program's place: every rank's block
    fitted in turn on one card, the blocks' rows joined as the all-gather
    joins them, each rank's answer judged by `compare`."""
    cfg = ctx.cell.config
    world = ctx.cell.traffic["ranks"]
    blocks = [block_sets(ctx, r, world, ctx.device) for r in range(world)]
    fit_args = (cfg["lam"], cfg["mu"], cfg["lasso_iters"],
                cfg["debias_iters"])
    for d in range(ctx.cell.traffic["datasets"]):
        outs = {}
        for mode in ("f32", "tf32"):
            with ref.precision(mode):
                outs[mode] = [ref.local_fit(*blocks[r][d], *fit_args)
                              for r in range(world)]
        want_all = torch.cat([o["beta_u"] for o in outs["f32"]])
        got_all = torch.cat([o["beta_u"] for o in outs["tf32"]])
        for want, got in zip(outs["f32"], outs["tf32"]):
            got = dict(got, beta_u_all=got_all,
                       support=ref.threshold(got_all, cfg["Lam"]))
            for name, v in zip(GAPS, compare(got, want, want_all,
                                             cfg["Lam"])):
                checks.worst(name, v)
