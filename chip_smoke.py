#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout

Phases, each of which raises on failure (exit code != 0):

1. the card: name, count, and `nvidia-smi` name and power limit;
2. build the CUDA kernels from `src/repro_torch/kernels/csrc` from scratch
   (nvcc, with `-Xptxas -v`: registers, shared memory and spills per
   kernel; the ranks of phase 8 load these libraries); the
   FISTA/ISTA GEMV and SGEMM (`fista_gemv_kernel`, `fista_gemm_kernel`),
   the rank-n update (`rank_update_kernel`), the logistic gradient
   (`logistic_grad_kernel`, `logistic_grad_rows_kernel`) and its unfused
   pair (`logistic_residual_kernel`, `logistic_backproject_kernel`), the
   group threshold (`group_threshold_kernel`) and the bf16 Hopper flash
   forward (`flash_fwd_wgmma`) must not spill;
3. every kernel against its plain PyTorch version on the card, at the main
   paths' shapes and at ragged ones, max abs error <= 1e-5 * max|plain|
   per output (both accumulate in f32, in another order); the rank-n
   update also at the streaming ingest's (8, 1024, 256), with Sigma
   exactly symmetric, the unfused pair's Sigma bitwise the fused one's,
   and its block tile as its launcher chooses it held to
   `ops.rank_plan`; the logistic
   gradient also at the large-p point m = 4, n = 256, p = 8192, and twice,
   to show that its sample reduction gives the same bits every run, the
   fused kernel's plan as its launcher chooses and launches it held to
   `ops.plan` and printed (a cluster launch where its cluster is above 1),
   its ticket counters at zero after the calls, and also in its two modes
   above p = 19,328, at (4, 256, 19329) (a shared-memory ring) and
   (1, 8, 100003) (X read twice); the unfused pair's launch plan as its
   launcher chooses it held to
   `ops.unfused_plan` and one call of the pair launching each of its two
   kernels once; the
   ISTA steps (batched and single-task), the unfused rank pair and the
   group threshold at their path shapes and at ragged ones (p = 129,
   r = 7, m = 3; (2, 7, 129); (1001, 5)), each twice for the same bits
   (the threshold's lanes a row as its launcher chooses them held to
   `ops.row_lanes`),
   and the GEMV's plan and the SGEMM's block tile as their launchers
   choose them held to `ops.gemv_plan` and `ops.gemm_plan`;
   the flash-attention forward in f32 at (B, S, N, K, H) = (2, 256, 8, 2,
   64), a ragged (1, 200, 4, 1, 128), (1, 512, 4, 1, 256) with window 64
   and a non-causal case, within 2e-5 * max|plain|, and in bf16 at the
   serving path's (4, 2048, 32, 8, 64), at minitron-4b's H = 128
   (4, 2048, 24, 8, 128), at the ragged and windowed
   shapes and at (1, 300, 4, 2, 64) with window 40 (T not a multiple of
   the bf16 kernel's 128-key tile, the window cutting its tiles),
   against the plain version on the f32 upcast of the same
   inputs; in both dtypes each query row's output within a relative l2
   error of the plain row (1e-4 in f32, 1e-2 in bf16: the output's
   scale falls with the row, as 1 / sqrt(row + 1), so a bar on
   max|plain|, set by row 0, would not follow it), each twice for the
   same bits;
4. the regression path at full width: `dsml_fit` (DSML Algorithm 1) on
   m = 16 tasks, n = 512 samples, p = 1024 features, through the kernels
   (launch counts zeroed just before, read just after), then with
   `use_kernel=False` on the card as the reference: beta_u within
   1e-4 * max|beta_u| after 1000 chained FISTA iterations, identical
   support;
4b. the logistic path (paper Section 4) at the same widths:
   `dsml_logistic_fit` on `gen_classification` data, 600 lasso and 600
   debias iterations, launch counts zeroed just before and read just after,
   then the plain path on the card: beta_u and beta_local within
   1e-4 * max|.|, identical support;
4c. the remaining DSML kernels and the regression baselines at the
   configuration of phase 4 (launch counts zeroed just before, read just
   after, every new count > 0): `rank_update_unfused` against
   `rank_update` on the fit's X, y; `group_threshold` of the fit's
   beta_u' at its Lambda, whose keep must be the fit's support and whose
   rows the fit's beta_tilde (the master step, eq. 5-6); `ista_solve` on
   task 0 (400 steps) against its plain path, within 1e-4 * max|beta|
   with an identical support; `ista_step` at r = p and
   `ista_step_batched` at r = 1 and r = p against their plain versions;
   `solve_lasso_eq2_grid` over k = 8 values of lambda (128 tasks) against
   its plain path; `group_lasso`, `icap` and `dirty_model` (400
   iterations each) against their plain paths, with wall time and
   support size;
5. times: each kernel alone (CUDA events, mean of 20 back-to-back
   launches into preallocated outputs after a warm-up; and again with the
   L2 cache flushed before each launch, since back to back an input of up
   to 50 MB stays in L2, as it does in the solver loops) beside its bound,
   its plain version, the nearest PyTorch call, and the wrapper as the
   main path calls it (checks and allocation included), and for the SGEMM,
   rank-n and flash rows the achieved TFLOP/s; the rank-n update also
   weighted (the logistic fit's Hessian launch) and at the streaming
   ingest's (8, 1024, 256), and flash also at H = 128, each beside its
   PyTorch call; for every row also the device time alone of the kernel
   and of its PyTorch call (`graph_ms`, `library_graph_ms`: 20 launches
   captured in one CUDA graph and replayed between CUDA events, so that
   no host issue is timed; `torch.profiler`'s device time where a launch
   cannot be captured, with the reason); an empty kernel's `graph_ms`,
   the floor of any launch, beside the group threshold's row; and each
   fit's wall time on both paths;
6. the serving path at full width, the cell of
   `repro_torch/serving/cell.py`: granite-3-2b (40 layers, d 2048, 32/8
   heads of 64, bf16) from a seeded `torch.Generator`, `greedy_generate`
   on a batch of 4 prompts of 2048 random ids and 16 new tokens, launch
   counts zeroed just before and read just after (`flash_attention` 40
   times, one per layer's prefill, and nothing else), then the same with
   `use_kernel=False` on the card: the prefill's last logits within
   0.1 * max|logits|, the shared tokens counted, prefill and decode
   times, tokens per second and peak memory; then an f32 copy of the same
   widths at 4 layers (batch 2, prompt 2048, 8 new tokens), whose kernel
   and plain paths must give identical tokens and last logits within
   1e-4 * max|logits|;
7. the streaming service (`repro_torch.stream`), each sub-phase with the
   launch counts zeroed just before and read just after:
   7a. phase 4's data ingested in 4 chunks of 128 rows: Sigma and c
       within 1e-5 * max|.| of `sufficient_stats` on all 512 rows; a cold
       `refit` (400 + 600 iterations) with phase 4's support and beta_u
       within 1e-4 * max|beta_u|; `rank_update` 4, GEMV 400 and SGEMM 600
       launches and nothing else;
   7b. `StreamingDsmlService` at m = 16, p = 1024 (refit_every 1024, the
       guard, a checkpoint store) fed 24 chunks of 256 rows of one seeded
       AR(0.5) regime whose support moves at chunk 12, chunk 5 poisoned
       with a NaN row (`repro_torch.testing.apply_batch_fault`), which must
       be quarantined with (Sigma, c, counts) bitwise unchanged, while a
       client thread submits single rows to a `ServingFront(max_batch=64,
       max_delay_ms=2)`: `rank_update` exactly once a chunk, a refit's
       GEMV and SGEMM once an iteration it ran and the health check's ISTA
       step once; the ingest p50 and rows/s, the cold and warm refit
       times, generations and rollbacks, `serve.request_ms` p50/p99
       overall and while a refit runs, a checkpoint save, peak memory;
       every front result scored by a generation that was published
       while its request was in flight, and equal to that generation's
       model; the same chunks with `use_kernel=False` on the card: the
       same generations, cadence and supports, beta_tilde within
       1e-4 * max|.|; `restore()` into a fresh service: the last
       checkpoint's generation and bits;
   7c. `benchmarks/stream_bench.py`'s full configuration, (8, 1024, 256),
       8 chunks, refit_every 1024: `rank_update` once a chunk (row 4i's
       launches), ingest times;
   7d. `refit_logistic` on phase 4b's data, generation 0 (cold) then 1
       (warm), against its plain path on the card (beta_u within
       1e-4 * max|.|, the same support), the cold one also against phase
       4b's fit; `logistic_grad` 600, `rank_update` 2 (the step sizes' and
       the weighted Hessian's), SGEMM 600 launches each.

8. the distributed path (`repro_torch.substrate`), each rank a process
   (`run_probe`, `file://` rendezvous) that loads the kernels phase 2
   built and fails the phase if it compiles any, with launch counts,
   the collective ledger and a count of the `torch.distributed` calls
   (`count_collectives`) zeroed just before each fit or ingest and read
   just after:
   8a. one NCCL rank: `dsml_fit_sharded` on phase 4's data, phase 4's
       bits, one all-gather of 16 x 1024 x 4 bytes, launches 1 / 400 /
       600;
   8b. four gloo ranks on the one card, 4 tasks each: beta_tilde within
       1e-5 * max|.| of phase 4's, its support, one collective a rank,
       launches 1 / 400 / 600 a rank; whether the bits are phase 4's is
       printed (`gemv_plan` depends on m);
   8c. on a 2 x 2 data x task mesh, phase 7a's chunks through
       `feed_chunk` + `ingest_sharded` (Sigma, c within 1e-5 * max|.| of
       7a's; one `rank_update` and two all-reduces a chunk a rank), then
       phase 7b's first 9 chunks through `StreamingDsmlService(mesh=)`:
       7b's generations, intervals and supports at every chunk, beta_tilde
       within 1e-4 * max|.|;
   8d. the sparse probe on granite-3-2b unreduced (phase 6's bf16
       weights from seed 0): `synthetic_probe_tasks` (m 4, n 96, seq 16,
       6 active dims), `sparse_probe_fit` through the kernels against
       `use_kernel=False` on the card (the same support, Lambda within
       1e-4 relative, beta_tilde within 1e-4 * max|.|), then sharded
       over 4 gloo ranks, one task each (the same support,
       1e-5 * max|.|); the recovery
       counts and R^2 printed;
   with each fit's wall time, spawn and rendezvous times, the all-gather
   alone (CUDA events) and each rank's peak memory.

It prints one JSON line of kernels (launches per run from phases 4-4c,
6 and 7c; phase 8's, over its ranks and its own fits, as
`launches_phase8`) and, last, the result line. With no CUDA device it
raises before printing any result.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published H100 SXM peaks (NVIDIA data sheet): f32 FMA outside the tensor
# cores, dense bf16 on the tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

M, N, P, S = 16, 512, 1024, 16          # the main path's configuration
LARGE_P = (4, 256, 8192)                # benchmarks/largep_logistic.py
INGEST = (8, 1024, 256)                 # benchmarks/stream_bench.py
# (B, S, N, K, H): minitron-4b's attention (configs/registry.py) at the
# serving cell's batch and prompt
FLASH_H128 = (4, 2048, 24, 8, 128)
TOL_KERNEL = 1e-5                       # x max|plain|, per output
TOL_FIT = 1e-4                          # x max|.|, after chained FISTA steps
TOL_FLASH = 2e-5                        # x max|plain|, f32
# worst relative l2 error of a query row's output
TOL_FLASH_ROW = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
TOL_SERVE_BF16 = 0.1                    # x max|logits|; a wrong head map: O(1)
CHUNKS_8C = 9                           # 7b's chunks through the sharded service


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def max_err(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(max |a - b|, max |b|)."""
    return (torch.max(torch.abs(a - b)).item(),
            torch.max(torch.abs(b)).item())


def row_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max over rows of ||got_r - ref_r|| / ||ref_r||, a row being the
    last axis."""
    num = torch.linalg.vector_norm(got - ref, dim=-1)
    den = torch.linalg.vector_norm(ref, dim=-1)
    return torch.max(num / torch.clamp_min(den, 1e-30)).item()


def bound(flops: float, nbytes: float,
          peak: float = PEAK_F32_FLOPS) -> tuple[float, str]:
    """Least time on the card in ms, and what sets it, for work done at
    the peak rate `peak` (FLOP/s)."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def ptxas_lines(log: str) -> list[str]:
    """One line per compiled kernel from `nvcc -Xptxas -v`."""
    out, fn, spill = [], "?", ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn, spill = m.group(1), ""
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            used = line.split(":", 1)[1].strip()
            out.append(f"  {fn}: {used}; {spill}")
    return out


def pct(values, q: float) -> float:
    """The q-quantile (0..1) of `values`, linear between order
    statistics, as `repro_torch.obs` computes it."""
    return float(np.quantile(np.asarray(values, dtype=np.float64), q))


def stream_phase(dev, card, data, res, cdata, cres, cfit_args, lam, mu,
                 Lam) -> int:
    """Phase 7: the streaming service (`repro_torch.stream`) on the card.
    Returns the `rank_update` launches of 7c's run (row 4i), and 7a's
    state statistics and 7b's first chunks with the kernel path's outcome
    at each (for phase 8c)."""
    import shutil
    import tempfile
    import threading

    from repro_torch import obs
    from repro_torch.core import sufficient_stats
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.launch.profile_serve import device_report
    from repro_torch.launch.stream_online import draw_chunk, make_regime
    from repro_torch.obs import torchprof
    from repro_torch.stream import (
        ServingFront, StreamingDsmlService, ingest, init_stream_state,
        refit, refit_health, refit_logistic,
    )
    from repro_torch.testing import apply_batch_fault, make_clean_batch

    def only(**counts) -> dict:
        want = dict.fromkeys(LAUNCHES, 0)
        want.update(counts)
        return want

    def delta(before: dict) -> dict:
        return {k: LAUNCHES[k] - before[k] for k in LAUNCHES}

    # ---- 7a. additivity at full width ---------------------------------
    Xs, ys = data.Xs, data.ys
    Sig_all, c_all = sufficient_stats(Xs, ys)
    chunks_a = [(Xs[:, i:i + 128].contiguous(), ys[:, i:i + 128].contiguous())
                for i in range(0, N, 128)]
    torch.cuda.synchronize()
    reset_launches()
    st = init_stream_state(M, P, device=dev)
    for X, y in chunks_a:
        st = ingest(st, X, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, info = refit(st, lam, mu, Lam, lasso_iters=400, debias_iters=600,
                     warm=False)
    torch.cuda.synchronize()
    refit_a_ms = (time.perf_counter() - t0) * 1e3
    launches_a = dict(LAUNCHES)
    check(launches_a == only(rank_update=4, fista_step_gemv=400,
                             fista_step_gemm=600),
          f"7a: launches {launches_a}")
    for name, a, b in (("Sigma", st.Sigmas, Sig_all), ("c", st.cs, c_all)):
        err, scale = max_err(a, b)
        check(err <= TOL_KERNEL * scale, f"7a: chunked {name} err {err} > "
              f"{TOL_KERNEL} * {scale}")
        print(f"stream 7a: {name} of 4 chunks of 128 rows vs sufficient_stats "
              f"of the {N} rows: max abs err {err:.3g} (max {scale:.3g})")
    check(bool(torch.all(st.counts == N)), "7a: counts")
    check(bool(torch.equal(st.support, res.support)),
          "7a: the refit's support differs from phase 4's dsml_fit")
    err, scale = max_err(st.beta_u, res.beta_u)
    check(err <= TOL_FIT * scale, f"7a: refit beta_u err {err} > "
          f"{TOL_FIT} * {scale}")
    print(f"stream 7a: cold refit (400 + 600 iterations) vs phase 4's "
          f"dsml_fit: beta_u max abs err {err:.3g} (max {scale:.3g}), the "
          f"same support ({int(st.support.sum())}); wall {refit_a_ms:.1f} "
          f"ms, no front running; launches {launches_a} {card}")

    # ---- 7b. the service while serving --------------------------------
    gen = torch.Generator(device=dev).manual_seed(7)
    chol, B, _ = make_regime(gen, P, M, S, device=dev)
    chunks = []
    for i in range(24):
        if i == 12:                            # the support moves
            chol, B, _ = make_regime(gen, P, M, S, device=dev)
        chunks.append(draw_chunk(gen, chol, B, 256))
    chunks[5] = apply_batch_fault(*chunks[5], "nan",
                                  np.random.default_rng(5))
    client_rows = np.random.default_rng(11).standard_normal(
        (4096, P)).astype(np.float32)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_stream_")
    kw = dict(lam=lam, mu=mu, Lam=Lam, refit_every=1024, device=dev)
    svc = StreamingDsmlService(M, P, guard=True, ckpt_dir=ckpt_dir, **kw)
    # each generation's publication, bracketed by the host clock
    published = {0: (float("-inf"), float("-inf"),
                     svc.serving().beta_tilde)}
    publish = svc.publish_model

    def timed_publish():
        t0 = time.perf_counter()
        snap = publish()
        published[snap.generation] = (t0, time.perf_counter(),
                                      snap.beta_tilde)
        return snap

    svc.publish_model = timed_publish
    done, futures = [], []
    stop = threading.Event()

    def client(front):
        i = 0
        while not stop.is_set():
            row = client_rows[i % len(client_rows)]
            t0 = time.perf_counter()
            fut = front.submit(row)
            fut.add_done_callback(lambda f, t0=t0, row=row: done.append(
                (t0, time.perf_counter(), row, f.result())))
            futures.append(fut)
            i += 1
            time.sleep(0.0005)

    obs.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    front = ServingFront(svc, max_batch=64, max_delay_ms=2.0).start()
    th = threading.Thread(target=client, args=(front,))
    th.start()
    time.sleep(0.05)                           # traffic before chunk 0
    trail = []                     # per chunk: kernel path's outcome
    for i, (X, y) in enumerate(chunks):
        if i == 5:
            pre = (svc.state.Sigmas, svc.state.cs, svc.state.counts)
            pre_bits = [t.clone() for t in pre]
        before = dict(LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = svc.ingest(X, y)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        d = delta(before)
        trail.append((t0, t1, out, svc.generation, svc._interval,
                      svc.state.support, svc.state.beta_tilde))
        if out is None:
            check(d == only(rank_update=1), f"7b chunk {i}: launches {d}")
        elif out.lasso_iters_run is not None:
            check(d == only(rank_update=1,
                            fista_step_gemv=out.lasso_iters_run,
                            fista_step_gemm=out.debias_iters_run,
                            ista_step_batched_gemv=1),
                  f"7b chunk {i}: refit launches {d}")
        if i == 5:
            check(out is None and svc.guard.total_quarantined == 1
                  and svc.guard.ledger[-1].reason == "nonfinite",
                  "7b: the NaN chunk was not quarantined")
            check(all(torch.equal(a, b) for a, b in zip(
                (svc.state.Sigmas, svc.state.cs, svc.state.counts),
                pre_bits)) and svc.state.Sigmas is pre[0],
                  "7b: the quarantined chunk changed (Sigma, c)")
    time.sleep(0.05)
    stop.set()
    th.join(30)
    check(front.stop(timeout=30) and not th.is_alive(),
          "7b: the front or its client did not stop")
    launches_b = dict(LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(launches_b["rank_update"] == len(chunks),
          f"7b: {launches_b['rank_update']} rank_update launches for "
          f"{len(chunks)} chunks")
    check(all(f.done() and f.exception() is None for f in futures),
          "7b: a request failed or never resolved")
    gens = sorted(published)
    for t_sub, t_done, row, r in done:
        g = r.generation
        check(g in published, f"7b: a result of unpublished generation {g}")
        nxt = [h for h in gens if h > g]
        check(published[g][0] <= t_done
              and (not nxt or published[nxt[0]][1] >= t_sub),
              f"7b: generation {g} was not the published model while a "
              "request was in flight")
        want = published[g][2].cpu().numpy() @ row
        check(np.max(np.abs(r.scores[:, 0] - want))
              <= TOL_KERNEL * max(np.max(np.abs(want)), 1e-30),
              f"7b: a result differs from generation {g}'s model")
    # a request "during a refit" overlaps a `stream.refit` span (the
    # solves and the health check; not the checkpoint after them)
    refit_spans = [(e["ts"] / 1e6, (e["ts"] + e["dur"]) / 1e6)
                   for e in obs.get_registry().trace_events()
                   if e["name"] == "stream.refit"]
    refit_ms = [(b - a) * 1e3 for a, b in refit_spans]
    lat, lat_refit, lat_quiet = [], [], []
    for t0, t1, _, _ in done:
        lat.append((t1 - t0) * 1e3)
        (lat_refit if any(t0 < b and t1 > a for a, b in refit_spans)
         else lat_quiet).append(lat[-1])
    check(len(lat_refit) > 0 and len(lat_quiet) > 0 and len(refit_ms) > 1,
          "7b: no request overlapped a refit, or none did not, or no warm "
          "refit ran")
    ingest_ms = [(t1 - t0) * 1e3 for i, (t0, t1, out, *_) in
                 enumerate(trail) if out is None and i != 5]
    # with the front stopped: guarded ingests into a service that does
    # not refit, a warm refit of the served state and its health check,
    # then one of each under the profiler
    quiet = StreamingDsmlService(M, P, lam=lam, mu=mu, Lam=Lam,
                                 refit_every=10**9, device=dev)
    quiet_ms = []
    for X, y in chunks[6:12]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        quiet.ingest(X, y)
        torch.cuda.synchronize()
        quiet_ms.append((time.perf_counter() - t0) * 1e3)

    def warm_refit():
        cand, _ = refit(svc.state, lam, mu, Lam,
                        lasso_iters=svc.warm_lasso_iters,
                        debias_iters=svc.warm_debias_iters)
        return refit_health(cand, lam)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    check(warm_refit().healthy, "7b: the quiet warm refit is unhealthy")
    quiet_refit_ms = (time.perf_counter() - t0) * 1e3
    prof_dir = tempfile.mkdtemp(prefix="chip_smoke_prof_")
    for label, fn in (("a chunk's ingest", lambda: quiet.ingest(*chunks[12])),
                      ("a warm refit and its health check", warm_refit)):
        with torchprof.profiler_trace(prof_dir) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        device_report(f"stream 7b profile, {label} (front stopped)", prof,
                      wall_s, 1)
    shutil.rmtree(prof_dir)
    t0 = time.perf_counter()
    ckpt_path = svc.checkpoint()
    ckpt_ms = (time.perf_counter() - t0) * 1e3
    ckpt_mib = os.path.getsize(ckpt_path) / 2**20
    fresh = StreamingDsmlService(M, P, ckpt_dir=ckpt_dir, **kw)
    check(fresh.restore() == svc.generation,
          "7b: restore() did not return the last checkpoint's generation")
    check(all(a.device == b.device and torch.equal(a, b)
              for a, b in zip(fresh.state, svc.state)),
          "7b: restore() did not return the last checkpoint's bits")
    del fresh
    shutil.rmtree(ckpt_dir)
    sizes = [int(s.sum()) for _, _, _, _, _, s, _ in trail]
    print(f"stream 7b: {len(chunks)} chunks of (16, 256, 1024), the support "
          f"moved at chunk 12, chunk 5 NaN-poisoned and quarantined with "
          f"(Sigma, c, counts) bitwise unchanged; generations "
          f"{svc.generation}, rollbacks {svc.rollbacks}, refits at chunks "
          f"{[i for i, t in enumerate(trail) if t[2] is not None]}, "
          f"intervals {[t[4] for t in trail]}, support sizes {sizes}; "
          f"launches {launches_b} (rank_update 1 a chunk; a refit: the "
          f"GEMV once a lasso iteration, the SGEMM once a debias "
          f"iteration, ista_step_batched once)")
    print(f"stream 7b times, the front serving: ingest p50 "
          f"{pct(ingest_ms, 0.5):.3f} ms a chunk (to a synchronize; "
          f"{len(ingest_ms)} chunks without a refit), "
          f"{M * 256 / pct(ingest_ms, 0.5) * 1e3:.0f} rows/s; refit cold "
          f"{refit_ms[0]:.1f} ms, warm p50 {pct(refit_ms[1:], 0.5):.1f} ms "
          f"(max {max(refit_ms[1:]):.1f}; stream.refit spans); checkpoint "
          f"save {ckpt_ms:.1f} ms ({ckpt_mib:.1f} MiB); peak memory "
          f"{peak_gib:.2f} GiB {card}")
    print(f"stream 7b times, the front stopped: ingest p50 "
          f"{pct(quiet_ms, 0.5):.3f} ms a chunk ({len(quiet_ms)} chunks, "
          f"{M * 256 / pct(quiet_ms, 0.5) * 1e3:.0f} rows/s); a warm refit "
          f"and its health check {quiet_refit_ms:.1f} ms {card}")
    print(f"stream 7b serving front (max_batch 64, max_delay 2 ms, one "
          f"client, a row every 0.5 ms): {len(lat)} requests, "
          f"serve.request_ms p50 {pct(lat, 0.5):.3f} p99 "
          f"{pct(lat, 0.99):.3f}; during a refit ({len(lat_refit)}): "
          f"p50 {pct(lat_refit, 0.5):.3f} p99 {pct(lat_refit, 0.99):.3f} "
          f"max {max(lat_refit):.3f}; outside refits ({len(lat_quiet)}): "
          f"p50 {pct(lat_quiet, 0.5):.3f} p99 {pct(lat_quiet, 0.99):.3f}; "
          f"batches {obs.counter_total('serve.batches'):.0f}, mean rows "
          f"{obs.hist_stats('serve.batch_rows')['mean']:.2f} {card}")

    # the same chunks on the plain path on the card, with no front
    ref = StreamingDsmlService(M, P, guard=True, use_kernel=False, **kw)
    before = dict(LAUNCHES)
    worst = 0.0
    for i, (X, y) in enumerate(chunks):
        out = ref.ingest(X, y)
        _, _, got, g, interval, support, beta = trail[i]
        check((out is None) == (got is None) and ref.generation == g
              and ref._interval == interval,
              f"7b chunk {i}: the plain path's cadence differs")
        check(bool(torch.equal(ref.state.support, support)),
              f"7b chunk {i}: the plain path's support differs")
        err, scale = max_err(beta, ref.state.beta_tilde)
        check(err <= TOL_FIT * scale, f"7b chunk {i}: beta_tilde err {err} "
              f"> {TOL_FIT} * {scale}")
        worst = max(worst, err)
    check(dict(LAUNCHES) == before, "7b: the plain path launched a kernel")
    print(f"stream 7b plain path (use_kernel=False, on the card): the same "
          f"generations, cadence and supports at every chunk; beta_tilde "
          f"max abs err {worst:.3g}")

    # ---- 7c. the ingest shape of row 4i -------------------------------
    rng = np.random.default_rng(0)
    m_i, n_i, p_i = INGEST
    chunks_i = [make_clean_batch(rng, m_i, n_i, p_i, device=dev)
                for _ in range(8)]
    svc_i = StreamingDsmlService(
        m_i, p_i, lam=0.4, mu=0.2, Lam=1.0, guard=False, refit_every=n_i,
        max_refit_interval=4 * n_i, lasso_iters=200, debias_iters=200,
        refit_tol=1e-5, device=dev)
    torch.cuda.synchronize()
    reset_launches()
    times_i, refits_i = [], []
    for i, (X, y) in enumerate(chunks_i):
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        out = svc_i.ingest(X, y)
        torch.cuda.synchronize()
        (times_i if out is None else refits_i).append(
            (time.perf_counter() - t0) * 1e3)
        check(delta(before)["rank_update"] == 1,
              f"7c chunk {i}: rank_update launched {delta(before)}")
    launches_c = LAUNCHES["rank_update"]
    check(launches_c == len(chunks_i), f"7c: {launches_c} launches")
    # what phase 8c holds its sharded ingest and service against
    carried = {"Sigmas": st.Sigmas, "cs": st.cs, "chunks": chunks[:CHUNKS_8C],
               "trail": [(out is None, g, interval, support, beta)
                         for _, _, out, g, interval, support, beta
                         in trail[:CHUNKS_8C]]}
    print(f"stream 7c ({m_i}, {n_i}, {p_i}) x {len(chunks_i)} chunks, "
          f"refit_every {n_i} (benchmarks/stream_bench.py's full "
          f"configuration): rank_update {launches_c} launches, one a chunk; "
          f"ingest without a refit p50 {pct(times_i, 0.5):.3f} ms "
          f"({len(times_i)} chunks, {m_i * n_i / pct(times_i, 0.5) * 1e3:.0f}"
          f" rows/s), with a refit p50 {pct(refits_i, 0.5):.1f} ms "
          f"({len(refits_i)}); generation {svc_i.generation} {card}")

    # ---- 7d. refit_logistic, cold then warm ---------------------------
    cX, cy, lam_c, mu_c, Lam_c = cfit_args
    st_k = st_p = init_stream_state(M, P, device=dev)
    for g in (0, 1):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        st_k, _ = refit_logistic(st_k, cX, cy, lam_c, mu_c, Lam_c)
        torch.cuda.synchronize()
        k_ms = (time.perf_counter() - t0) * 1e3
        launches_d = dict(LAUNCHES)
        check(launches_d == only(rank_update=2, logistic_grad=600,
                                 fista_step_gemm=600),
              f"7d generation {g}: launches {launches_d}")
        t0 = time.perf_counter()
        st_p, _ = refit_logistic(st_p, cX, cy, lam_c, mu_c, Lam_c,
                                 use_kernel=False)
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - t0) * 1e3
        check(dict(LAUNCHES) == launches_d,
              "7d: the plain path launched a kernel")
        err, scale = max_err(st_k.beta_u, st_p.beta_u)
        check(err <= TOL_FIT * scale, f"7d generation {g}: beta_u err {err} "
              f"> {TOL_FIT} * {scale}")
        check(bool(torch.equal(st_k.support, st_p.support)),
              f"7d generation {g}: supports differ")
        if g == 0:
            e0, s0 = max_err(st_k.beta_u, cres.beta_u)
            check(e0 <= TOL_FIT * s0 and bool(torch.equal(st_k.support,
                                                          cres.support)),
                  "7d: the cold refit differs from phase 4b's fit")
        print(f"stream 7d refit_logistic generation {g} -> {g + 1} "
              f"({'cold' if g == 0 else 'warm'}, 600 + 600 iterations): "
              f"beta_u max abs err vs plain {err:.3g} (max {scale:.3g}), "
              f"the same support ({int(st_k.support.sum())}); launches "
              f"{launches_d} (rank_update: the step sizes' and the weighted "
              f"Hessian's); wall kernels {k_ms:.1f} ms, plain {p_ms:.1f} ms "
              f"{card}")
    return launches_c, carried


# the program every rank of phase 8 runs (`run_probe`: one process a
# rank on the one card, `file://` rendezvous); `@SPEC@` is its JSON spec
RANK_PROGRAM = r"""
import json, time
T0 = time.time()
import torch
import torch.distributed as dist
from repro_torch import obs
from repro_torch.core import dsml_fit_sharded
from repro_torch.kernels import _build
from repro_torch.kernels.common import LAUNCHES, reset_launches
from repro_torch.multitask import ProbeData, sparse_probe_fit
from repro_torch.stream import (
    StreamingDsmlService, ingest_sharded, init_stream_state,
)
from repro_torch.substrate import (
    all_gather_tasks, data_task_mesh, feed_chunk, init_from_env, task_mesh,
)
from repro_torch.testing import count_collectives

spec = json.load(open("@SPEC@"))
dev = torch.device("cuda")
T1 = time.time()
rank, world = init_from_env(device=dev)
T2 = time.time()
_build.build()
out = dict(rank=rank, world=world, backend=dist.get_backend(),
           spawn_s=T0 - spec["t_spawn"], import_s=T1 - T0,
           rendezvous_s=T2 - T1, compiled=sorted(_build.BUILD_SECONDS))
lam, mu, Lam = spec["lam"], spec["mu"], spec["Lam"]
data = torch.load(spec["data"])
Xs, ys = data["Xs"].to(dev), data["ys"].to(dev)


def counted(fn):
    # fn() with launches, the ledger, the wrapped torch.distributed calls
    # and the peak memory zeroed just before and read just after
    torch.cuda.synchronize()
    reset_launches()
    obs.reset()
    torch.cuda.reset_peak_memory_stats()
    with count_collectives() as calls:
        t = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    return r, dict(
        wall_ms=wall * 1e3, launches={k: v for k, v in LAUNCHES.items() if v},
        calls=dict(calls), peak_mib=torch.cuda.max_memory_allocated() / 2**20,
        ledger={op: [obs.counter_total("collective.calls", op=op),
                     obs.counter_total("collective.bytes", op=op)]
                for op in ("all_gather_tasks", "psum_stats", "pmax")})


def gather_ms(x, mesh):
    # the all-gather alone, CUDA events around it on this rank
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    all_gather_tasks(x, mesh)
    torch.cuda.synchronize()
    e0.record()
    all_gather_tasks(x, mesh)
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)


def save(name, obj):
    torch.save(obj, f"{spec['out']}/{name}_rank{rank}.pt")


if "fit" in spec["phases"]:
    mesh = task_mesh()
    ml = Xs.shape[0] // world
    X = Xs[rank * ml:(rank + 1) * ml].contiguous()
    y = ys[rank * ml:(rank + 1) * ml].contiguous()
    dsml_fit_sharded(X, y, lam, mu, Lam, mesh, lasso_iters=2,
                     debias_iters=2)
    res, out["fit"] = counted(lambda: dsml_fit_sharded(X, y, lam, mu, Lam,
                                                       mesh))
    out["fit"]["gather_ms"] = gather_ms(res.beta_u, mesh)
    save("fit", {k: v.cpu() for k, v in res._asdict().items()})

if "ingest" in spec["phases"]:
    mesh2 = data_task_mesh(n_task=2)
    t = mesh2.get_coordinate()[1]
    ml = Xs.shape[0] // 2
    chunks = [(Xs[:, i:i + 128].contiguous(), ys[:, i:i + 128].contiguous())
              for i in range(0, Xs.shape[1], 128)]
    state0 = init_stream_state(ml, Xs.shape[2], device=dev)

    def run():
        st = state0
        for X, y in chunks:
            st = ingest_sharded(st, *feed_chunk(X, y, mesh2), mesh2)
        return st

    run()
    st, out["ingest"] = counted(run)
    ref = torch.load(spec["st7a"])
    rows = slice(t * ml, (t + 1) * ml)
    for name in ("Sigmas", "cs"):
        want = ref[name][rows].to(dev)
        out["ingest"][name] = [
            torch.max(torch.abs(getattr(st, name) - want)).item(),
            torch.max(torch.abs(want)).item()]
    chunks7b = [(X.to(dev), y.to(dev)) for X, y in torch.load(spec["chunks7b"])]
    svc = StreamingDsmlService(Xs.shape[0], Xs.shape[2], lam=lam, mu=mu,
                               Lam=Lam, refit_every=1024, device=dev,
                               guard=True, mesh=mesh2)
    trail = []

    def run_service():
        for X, y in chunks7b:
            info = svc.ingest(X, y)
            trail.append((info is None, svc.generation, svc._interval,
                          svc.state.support.cpu(),
                          svc.state.beta_tilde.cpu()))

    _, out["service"] = counted(run_service)
    out["service"]["pmax"] = out["service"]["ledger"]["pmax"][0]
    save("service", trail)

if "probe" in spec["phases"]:
    probe = torch.load(spec["probe"])
    ml = probe["features"].shape[0] // world
    pdata = ProbeData(
        probe["features"][rank * ml:(rank + 1) * ml].to(dev).contiguous(),
        probe["targets"][rank * ml:(rank + 1) * ml].to(dev).contiguous())
    mesh = task_mesh()
    sparse_probe_fit(pdata, mesh=mesh, lasso_iters=2, debias_iters=2)
    res, out["probe"] = counted(lambda: sparse_probe_fit(pdata, mesh=mesh))
    save("probe", {k: v.cpu() for k, v in res._asdict().items()})

dist.destroy_process_group()
print("RANK8 " + json.dumps(out))
"""


def distributed_phase(dev, card, data, res, carried, lam, mu, Lam) -> dict:
    """Phase 8: the distributed path on the card, each rank a process.
    Returns the launches per kernel of the phase (ranks and parent)."""
    import shutil
    import tempfile

    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.multitask import (
        default_threshold, probe_predict, sparse_probe_fit,
        synthetic_probe_tasks,
    )
    from repro_torch.serving import cell
    from repro_torch.substrate import run_probe

    total: dict[str, int] = {}

    def add(launches: dict) -> None:
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    def fit_launches(gemm: int) -> dict:
        return {"rank_update": 1, "fista_step_gemv": 400,
                "fista_step_gemm": gemm}

    def ranks(world, backend, phases, tmp):
        """Run RANK_PROGRAM as `world` ranks; every rank's JSON line, its
        saved tensors by name, and the wall time of the whole run."""
        spec = dict(lam=lam, mu=mu, Lam=Lam, phases=phases, out=tmp,
                    data=f"{tmp}/data.pt", st7a=f"{tmp}/st7a.pt",
                    chunks7b=f"{tmp}/chunks7b.pt", probe=f"{tmp}/probe.pt",
                    t_spawn=time.time())
        path = f"{tmp}/spec_{backend}_{world}.json"
        Path(path).write_text(json.dumps(spec))
        t0 = time.perf_counter()
        run = run_probe(RANK_PROGRAM.replace("@SPEC@", path), world=world,
                        backend=backend, timeout=600, pg_timeout=300)
        wall = time.perf_counter() - t0
        check(run.ok, f"phase 8 ranks ({backend}, {world}) failed:\n"
              f"{run.report()}")
        lines = []
        for i, r in enumerate(run.ranks):
            found = [ln for ln in r.stdout.splitlines()
                     if ln.startswith("RANK8 ")]
            check(len(found) == 1, f"rank {i}: no result line:\n{r.stdout}")
            line = json.loads(found[0][len("RANK8 "):])
            check(line["compiled"] == [],
                  f"rank {i} recompiled kernels: {line['compiled']}")
            lines.append(line)
        saved = {name: [torch.load(f"{tmp}/{name}_rank{i}.pt")
                        for i in range(world)]
                 for name in ("fit", "service", "probe")
                 if Path(f"{tmp}/{name}_rank0.pt").exists()}
        starts = [ln["spawn_s"] + ln["import_s"] for ln in lines]
        rdv = [ln["rendezvous_s"] for ln in lines]
        print(f"phase 8 {backend} x {world}: the whole run {wall:.1f} s; "
              f"spawn to imports done {min(starts):.1f}-{max(starts):.1f} "
              f"s, rendezvous {min(rdv):.2f}-{max(rdv):.2f} s; no rank "
              f"compiled a kernel {card}")
        return lines, saved

    def fit_checks(label, lines, saved, world, exact):
        ml = M // world
        same_bits, worst = True, 0.0
        for i, (line, got) in enumerate(zip(lines, saved)):
            st = line["fit"]
            check(st["launches"] == fit_launches(600),
                  f"{label} rank {i}: launches {st['launches']}")
            check(sum(st["calls"].values()) == 1,
                  f"{label} rank {i}: collectives {st['calls']}")
            check(st["ledger"]["all_gather_tasks"] ==
                  [1, world * ml * P * 4],
                  f"{label} rank {i}: ledger {st['ledger']}")
            rows = slice(i * ml, (i + 1) * ml)
            for name in ("beta_tilde", "beta_u", "beta_local"):
                want = getattr(res, name)[rows].cpu()
                same_bits &= bool(torch.equal(got[name], want))
                err, scale = max_err(got[name], want)
                check(err <= TOL_KERNEL * scale, f"{label} rank {i} {name}:"
                      f" err {err} > {TOL_KERNEL} * {scale}")
                if name == "beta_tilde":
                    worst = max(worst, err)
            same_bits &= bool(torch.equal(got["beta_u_all"],
                                          res.beta_u.cpu()))
            check(bool(torch.equal(got["support"], res.support.cpu())),
                  f"{label} rank {i}: the support differs from phase 4's")
            add(st["launches"])
        if exact:
            check(same_bits, f"{label}: not phase 4's bits")
        walls = [ln["fit"]["wall_ms"] for ln in lines]
        print(f"phase {label} dsml_fit_sharded ({world} x {ml} tasks, n {N}, "
              f"p {P}, 400 + 600): the same support as phase 4, "
              f"{'the same bits' if same_bits else 'not the same bits'}, "
              f"beta_tilde max abs err {worst:.3g} (max "
              f"{torch.max(torch.abs(res.beta_tilde)).item():.3g}); "
              f"each rank launches {lines[0]['fit']['launches']} and issues "
              f"one collective ({lines[0]['fit']['calls']}), ledger "
              f"{lines[0]['fit']['ledger']['all_gather_tasks']} (calls, "
              f"bytes); fit wall {min(walls):.1f}-{max(walls):.1f} ms; "
              f"all-gather alone "
              f"{[round(ln['fit']['gather_ms'], 4) for ln in lines]} ms; "
              f"peak {[round(ln['fit']['peak_mib']) for ln in lines]} MiB "
              f"{card}")

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    try:
        torch.save({"Xs": data.Xs.cpu(), "ys": data.ys.cpu()},
                   f"{tmp}/data.pt")
        torch.save({"Sigmas": carried["Sigmas"].cpu(),
                    "cs": carried["cs"].cpu()}, f"{tmp}/st7a.pt")
        torch.save([(X.cpu(), y.cpu()) for X, y in carried["chunks"]],
                   f"{tmp}/chunks7b.pt")

        # ---- 8d, this process: granite-3-2b's features and the fits ----
        cfg, params, _ = cell.make_cell(dev)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        pdata, psupport = synthetic_probe_tasks(
            torch.Generator(device=dev).manual_seed(1), params, cfg, m=4,
            n=96, seq=16, s_active=6)
        torch.cuda.synchronize()
        feat_s = time.perf_counter() - t0
        check(not any(LAUNCHES.values()), f"8d features: {dict(LAUNCHES)}")
        del params
        check(pdata.features.shape == (4, 96, cfg.d_model) and bool(
            torch.isfinite(pdata.features).all()), "8d: the features")
        sparse_probe_fit(pdata, lasso_iters=2, debias_iters=2)   # warm-up
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        pk = sparse_probe_fit(pdata)
        torch.cuda.synchronize()
        probe_k_s = time.perf_counter() - t0
        launches_d = {k: v for k, v in LAUNCHES.items() if v}
        check(launches_d == fit_launches(400), f"8d launches {launches_d}")
        add(launches_d)
        t0 = time.perf_counter()
        pp = sparse_probe_fit(pdata, use_kernel=False)
        torch.cuda.synchronize()
        probe_p_s = time.perf_counter() - t0
        check({k: v for k, v in LAUNCHES.items() if v} == launches_d,
              "8d: the plain path launched a kernel")
        lam_k, lam_p = default_threshold(pk.beta_u), \
            default_threshold(pp.beta_u)
        # Lambda is read off beta_u, which the paths sum in another order
        check(abs(lam_k - lam_p) <= TOL_FIT * lam_p,
              f"8d: Lambda {lam_k} against the plain path's {lam_p}")
        check(bool(torch.equal(pk.support, pp.support)),
              "8d: the support differs from the plain path's")
        err, scale = max_err(pk.beta_tilde, pp.beta_tilde)
        check(err <= TOL_FIT * scale, f"8d beta_tilde: err {err} > "
              f"{TOL_FIT} * {scale}")
        tp = int(torch.sum(pk.support & psupport))
        fp = int(torch.sum(pk.support & ~psupport))
        pred = probe_predict(pk, pdata.features)
        r2 = 1 - float(torch.var(pred - pdata.targets, correction=0)
                       / torch.var(pdata.targets, correction=0))
        print(f"phase 8d {cfg.name} unreduced ({cfg.n_layers} layers, d "
              f"{cfg.d_model}, {cfg.compute_dtype}), 4 tasks x 96 sequences "
              f"of 16 tokens: features {feat_s * 1e3:.1f} ms (no flash "
              f"launch: 16 x 16 scores take the dense branch); "
              f"sparse_probe_fit (400 + 400) kernels {probe_k_s * 1e3:.1f} "
              f"ms, plain {probe_p_s * 1e3:.1f} ms; Lambda {lam_k!r} "
              f"(plain {lam_p!r}), the same support "
              f"({int(pk.support.sum())}), "
              f"beta_tilde max abs err {err:.3g} (max {scale:.3g}); "
              f"recovered {tp}/{int(psupport.sum())} true dims, {fp} false "
              f"positives, R^2 {r2:.3f}; launches {launches_d} {card}")
        torch.save({"features": pdata.features.cpu(),
                    "targets": pdata.targets.cpu()}, f"{tmp}/probe.pt")

        # ---- 8a. one rank over NCCL -------------------------------------
        lines, saved = ranks(1, "nccl", ["fit"], tmp)
        check(lines[0]["backend"] == "nccl", "8a backend")
        fit_checks("8a", lines, saved["fit"], 1, exact=True)

        # ---- 8b-8d. four ranks on the one card over gloo ----------------
        lines, saved = ranks(4, "gloo", ["fit", "ingest", "probe"], tmp)
        fit_checks("8b", lines, saved["fit"], 4, exact=False)

        n_chunks = N // 128
        ml = M // 2
        for i, line in enumerate(lines):
            st = line["ingest"]
            check(st["launches"] == {"rank_update": n_chunks},
                  f"8c rank {i}: launches {st['launches']}")
            check(st["calls"] == {"all_reduce": 2 * n_chunks},
                  f"8c rank {i}: collectives {st['calls']}")
            check(st["ledger"]["psum_stats"] == [
                2 * n_chunks, n_chunks * 2 * 4 * (ml * P * P + ml * P)],
                f"8c rank {i}: ledger {st['ledger']}")
            for name in ("Sigmas", "cs"):
                err, scale = st[name]
                check(err <= TOL_KERNEL * scale, f"8c rank {i} {name}: err "
                      f"{err} > {TOL_KERNEL} * {scale}")
            add(st["launches"])
        errs = [(ln["ingest"]["Sigmas"][0], ln["ingest"]["cs"][0])
                for ln in lines]
        print(f"phase 8c ingest_sharded on a 2 x 2 data x task mesh, phase "
              f"7a's {n_chunks} chunks of 128 rows: Sigma, c max abs err vs "
              f"7a {errs} (max {lines[0]['ingest']['Sigmas'][1]:.3g}, "
              f"{lines[0]['ingest']['cs'][1]:.3g}); each rank one "
              f"rank_update and two all-reduces a chunk; wall "
              f"{[round(ln['ingest']['wall_ms'], 1) for ln in lines]} ms "
              f"for the {n_chunks} chunks {card}")

        trail = carried["trail"]
        worst = 0.0
        for i, (line, got) in enumerate(zip(lines, saved["service"])):
            for c, (g, w) in enumerate(zip(got, trail)):
                check(g[:3] == w[:3], f"8c service rank {i} chunk {c}: "
                      f"{g[:3]} != phase 7b's {w[:3]}")
                check(bool(torch.equal(g[3], w[3].cpu())),
                      f"8c service rank {i} chunk {c}: the support differs")
                rows = slice((i % 2) * ml, (i % 2 + 1) * ml)
                err, scale = max_err(g[4], w[4][rows].cpu())
                check(err <= TOL_FIT * scale, f"8c service rank {i} chunk {c}: beta_tilde err {err} > "
                      f"{TOL_FIT} * {scale}")
                worst = max(worst, err)
            st = line["service"]
            check(st["launches"].get("rank_update") == len(trail) - 1,
                  f"8c service rank {i}: launches {st['launches']}")
            check(st["pmax"] == 2 * sum(not w[0] for w in trail),
                  f"8c service rank {i}: {st['pmax']} pmax")
            add(st["launches"])
        print(f"phase 8c StreamingDsmlService(mesh=2 x 2) on phase 7b's "
              f"first {len(trail)} chunks (the NaN chunk 5 quarantined, "
              f"refits at chunks "
              f"{[c for c, w in enumerate(trail) if not w[0]]}): phase 7b's "
              f"generations, intervals and supports at every chunk on every "
              f"rank, beta_tilde max abs err {worst:.3g}; wall "
              f"{[round(ln['service']['wall_ms'], 1) for ln in lines]} ms; "
              f"launches rank 0 {lines[0]['service']['launches']} {card}")

        ml = 1
        for i, (line, got) in enumerate(zip(lines, saved["probe"])):
            st = line["probe"]
            check(st["launches"] == fit_launches(400),
                  f"8d rank {i}: launches {st['launches']}")
            check(sum(st["calls"].values()) == 1,
                  f"8d rank {i}: collectives {st['calls']}")
            check(bool(torch.equal(got["support"], pk.support.cpu())),
                  f"8d rank {i}: the support differs")
            err, scale = max_err(got["beta_tilde"], pk.beta_tilde[i:i + 1]
                                 .cpu())
            check(err <= TOL_KERNEL * scale, f"8d rank {i}: beta_tilde err "
                  f"{err} > {TOL_KERNEL} * {scale}")
            add(st["launches"])
        print(f"phase 8d the probe sharded over 4 ranks, one task each: the "
              f"single-process support, beta_tilde within {TOL_KERNEL} * "
              f"max; one collective a rank; fit wall "
              f"{[round(ln['probe']['wall_ms'], 1) for ln in lines]} ms, "
              f"peak {[round(ln['probe']['peak_mib']) for ln in lines]} MiB "
              f"{card}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 8 launches (ranks and this process): {total}")
    return total


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's kernels "
                         "run only on an NVIDIA card")
    from repro_torch.core import (
        dirty_model, dsml_fit, dsml_logistic_fit, gen_classification,
        gen_regression, group_lasso, hamming, icap, solve_lasso_eq2_grid,
    )
    from repro_torch.core.engine import (
        power_iteration_batched, scaled_identity_m0,
    )
    from repro_torch.kernels import _build
    from repro_torch.configs import get_config
    from repro_torch.launch.timing import graph_ms, time_ms, time_ms_cold
    from repro_torch.kernels.common import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.group_threshold import ops as threshold_ops
    from repro_torch.kernels.group_threshold.ops import group_threshold
    from repro_torch.kernels.group_threshold.ref import group_threshold_ref
    from repro_torch.kernels.ista_step import ops as ista_ops
    from repro_torch.kernels.ista_step.ops import (
        fista_step_batched, ista_solve, ista_step, ista_step_batched,
    )
    from repro_torch.kernels.ista_step.ref import (
        fista_step_batched_ref, ista_step_batched_ref, ista_step_ref,
    )
    from repro_torch.kernels.logistic_grad import ops as logistic_ops
    from repro_torch.kernels.logistic_grad.ops import (
        logistic_grad, logistic_grad_unfused,
    )
    from repro_torch.kernels.logistic_grad.ref import logistic_grad_ref
    from repro_torch.kernels.rank_update import ops as rank_ops
    from repro_torch.kernels.rank_update.ops import (
        rank_update, rank_update_unfused,
    )
    from repro_torch.kernels.rank_update.ref import (
        rank_c_ref, rank_sigma_ref, rank_update_ref,
    )
    from repro_torch.models import Batch, forward_prefill
    from repro_torch.serving import cell
    from repro_torch.serving.engine import greedy_generate

    dev = torch.device("cuda")

    # ---- 1. the card ------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60
    ).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"device: {kind} x{count}; nvidia-smi: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")

    # ---- 2. build ---------------------------------------------------------
    # from scratch, so that every source compiles here and its spills are
    # checked; the ranks of phase 8 load these libraries as they are
    for old in _build.BUILD_DIR.glob("lib*"):
        old.unlink()
    t0 = time.perf_counter()
    _build.build()
    check(sorted(_build.BUILD_LOG) == sorted(
        src.stem for src in _build.CSRC.glob("*.cu")),
        f"phase 2 compiled {sorted(_build.BUILD_LOG)}")
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc per source: {_build.BUILD_SECONDS})")
    for src, log in _build.BUILD_LOG.items():
        print(f"ptxas {src}.cu:")
        for line in ptxas_lines(log):
            print(line)
            if any(k in line for k in ("fista_gemm_kernel",
                                       "fista_gemv_kernel",
                                       "rank_update_kernel",
                                       "logistic_grad_kernel",
                                       "logistic_grad_rows_kernel",
                                       "logistic_residual_kernel",
                                       "logistic_backproject_kernel",
                                       "group_threshold_kernel",
                                       "flash_fwd_wgmma")):
                check(" 0 bytes spill stores" in line,
                      f"a redesigned kernel spills: {line}")

    # ---- 3. kernel vs plain -----------------------------------------------
    g = torch.Generator(device=dev).manual_seed(1)
    errs: dict[str, float] = {}

    def rank_inputs(m, n, p):
        X = torch.randn((m, n, p), generator=g, device=dev)
        y = torch.randn((m, n), generator=g, device=dev)
        w = 0.5 + torch.rand((m, n), generator=g, device=dev)
        return X, y, w

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    smem_optin = torch.cuda.get_device_properties(
        dev).shared_memory_per_block_optin

    def check_rank(label, X, y, w):
        """The fused kernel against its plain version; Sigma exactly
        symmetric and the unfused pair's Sigma bitwise the fused one's;
        the launcher's tile held to `rank_plan`."""
        m, _, p = X.shape
        plan = rank_ops.rank_plan(m, p, sms)
        check(rank_ops.kernel_rank_plan(m, p, dev) ==
              (plan.tile, plan.blocks, sms), f"rank_update tile at {label}: "
              f"the launcher's differs from rank_plan's {plan}")
        got = rank_update(X, y, w, use_kernel=True)
        ref = rank_update(X, y, w, use_kernel=False)
        unf = rank_update_unfused(X, y, w, use_kernel=True)
        torch.cuda.synchronize()
        worst = 0.0
        for name, a, b in zip(("Sigma", "c"), got, ref):
            err, scale = max_err(a, b)
            check(err <= TOL_KERNEL * scale,
                  f"rank_update {label} {name}: err {err} > "
                  f"{TOL_KERNEL} * {scale}")
            worst = max(worst, err)
        check(bool(torch.equal(got[0], got[0].mT)),
              f"rank_update {label}: Sigma not exactly symmetric")
        check(bool(torch.equal(unf[0], got[0])), f"rank_update {label}: the "
              "unfused Sigma differs from the fused one")
        print(f"check rank_update {label}: max abs err {worst:.3g}; Sigma "
              f"exactly symmetric, the unfused Sigma the same bits; "
              f"{plan.tile} x {plan.tile} tiles, {plan.blocks} blocks of "
              f"{plan.threads} threads on {sms} SMs")
        return worst

    X, y, w = rank_inputs(M, N, P)
    errs["rank_update"] = check_rank(f"({M},{N},{P})", X, y, None)
    errs["rank_update_weighted"] = check_rank(f"({M},{N},{P}) weighted",
                                              X, y, w)
    Xr, yr, wr = rank_inputs(3, 500, 1000)
    check_rank("(3,500,1000)", Xr, yr, None)
    check_rank("(3,500,1000) weighted", Xr, yr, wr)
    Xi, yi, _ = rank_inputs(*INGEST)
    errs["rank_update_ingest"] = check_rank("({},{},{})".format(*INGEST), Xi,
                                            yi, None)
    check_rank("(2,7,129) weighted", *rank_inputs(2, 7, 129))

    def fista_inputs(Sigmas, r, lam):
        m, p, _ = Sigmas.shape
        etas = 1.0 / torch.clamp_min(power_iteration_batched(Sigmas), 1e-12)
        z = 0.05 * torch.randn((m, p, r), generator=g, device=dev)
        x = z + 0.01 * torch.randn((m, p, r), generator=g, device=dev)
        c = (torch.eye(p, device=dev).expand(m, p, p).contiguous() if r == p
             else 0.1 * torch.randn((m, p, r), generator=g, device=dev))
        lams = torch.full((m,), lam, device=dev)
        return Sigmas, z, x, c, etas, lams, np.float32(0.7)

    def check_fista(label, args):
        got = fista_step_batched(*args, use_kernel=True)
        ref = fista_step_batched(*args, use_kernel=False)
        torch.cuda.synchronize()
        worst = 0.0
        for name, a, b in zip(("x_next", "z_next"), got, ref):
            err, scale = max_err(a, b)
            check(err <= TOL_KERNEL * scale,
                  f"fista_step_batched {label} {name}: err {err} > "
                  f"{TOL_KERNEL} * {scale}")
            worst = max(worst, err)
        print(f"check fista_step_batched {label}: max abs err {worst:.3g}")
        return worst

    Sig, _ = rank_update(X, y, use_kernel=False)
    lam = 4.0 * float(np.sqrt(np.log(P) / N))
    mu = float(np.sqrt(np.log(P) / N))
    gemv_args = fista_inputs(Sig, 1, 0.5 * lam)
    gemm_args = fista_inputs(Sig, P, mu)
    errs["fista_step_gemv"] = check_fista(f"r=1 p={P}", gemv_args)
    errs["fista_step_gemm"] = check_fista(f"r=p={P}", gemm_args)
    Sig_r, _ = rank_update(Xr, yr, use_kernel=False)
    check_fista("r=1 p=1000", fista_inputs(Sig_r, 1, 0.5 * lam))
    check_fista("r=p=1000", fista_inputs(Sig_r, 1000, mu))
    for shape in ((M, P), (1, P), (3, 1000), (8 * M, P)):
        plan = ista_ops.gemv_plan(*shape, sms)
        check(ista_ops.kernel_gemv_plan(*shape, dev) ==
              (plan.rows_per_warp, plan.warps, sms),
              f"GEMV plan at {shape}: the launcher's differs from "
              f"gemv_plan's {plan}")
        print(f"GEMV plan at {shape}: {plan} on {sms} SMs")
    for shape in ((M, P, P), (1, P, P), (3, 1000, 1000), (3, 129, 7)):
        plan = ista_ops.gemm_plan(*shape, sms)
        check(ista_ops.kernel_gemm_plan(*shape, dev) == (plan.bm, plan.bn,
                                                         sms),
              f"SGEMM tile at {shape}: the launcher's differs from "
              f"gemm_plan's {plan}")
        print(f"SGEMM tile at {shape}: {plan.bm} x {plan.bn}, "
              f"{plan.blocks} blocks of {plan.threads} threads on {sms} SMs")

    def logistic_inputs(m, n, p):
        X = torch.randn((m, n, p), generator=g, device=dev)
        y = torch.where(torch.rand((m, n), generator=g, device=dev) < 0.5,
                        1.0, -1.0)
        B = torch.randn((m, p), generator=g, device=dev) / float(np.sqrt(p))
        return X, y, B

    def check_logistic(label, args):
        """Both kernels against their plain version, twice for the same
        bits; the fused kernel's plan held to `plan` as its launcher
        chooses it and as it launched it; the unfused pair's plan held to
        `unfused_plan`, and one call of it launching each of its two
        kernels once."""
        m_, n_, p_ = args[0].shape
        vec = logistic_ops.vectorized(args[0], args[2])
        fplan = logistic_ops.plan(m_, n_, p_, sms, smem_optin, vec=vec)
        check(logistic_ops.kernel_plan(m_, n_, p_, vec, dev) ==
              (fplan, sms), f"fused plan at {label}: the launcher's "
              f"differs from plan's {fplan}")
        G_ = torch.empty((m_, p_), device=dev)
        ran = logistic_ops.launch(
            *args, G_, torch.empty((m_, fplan.chunks, p_), device=dev),
            logistic_ops.ticket_counters(dev, m_ * fplan.cluster))
        check(ran == fplan, f"fused kernel at {label} ran {ran}, not the "
              f"plan {fplan}")
        print(f"fused plan at {label}: {ran} ("
              + (f"a cluster launch of {ran.cluster} blocks a cluster, "
                 if ran.cluster > 1 else "no cluster, ")
              + f"{m_ * ran.chunks * ran.cluster} blocks)")
        plan = logistic_ops.unfused_plan(m_, n_, p_, sms)
        check(logistic_ops.kernel_unfused_plan(m_, n_, p_, dev) ==
              (plan.rows_per_warp, plan.warps_per_row, plan.cols, sms),
              f"unfused plan at "
              f"{label}: the launcher's differs from unfused_plan's {plan}")
        print(f"unfused plan at {label}: {plan}")
        worst = []
        for name, fn in (("logistic_grad", logistic_grad),
                         ("logistic_grad_unfused", logistic_grad_unfused)):
            before = dict(LAUNCHES)
            got = fn(*args, use_kernel=True)
            if name == "logistic_grad_unfused":
                check(all(LAUNCHES[k] == before[k] + 1 for k in (
                    "logistic_z", "logistic_backproject")),
                    f"{name} {label}: not one launch of each kernel")
            again = fn(*args, use_kernel=True)
            ref = fn(*args, use_kernel=False)
            torch.cuda.synchronize()
            err, scale = max_err(got, ref)
            check(err <= TOL_KERNEL * scale,
                  f"{name} {label}: err {err} > {TOL_KERNEL} * {scale}")
            check(bool(torch.equal(got, again)),
                  f"{name} {label}: two launches gave different bits")
            print(f"check {name} {label}: max abs err {err:.3g} "
                  f"(max|plain| {scale:.3g}), same bits on a second launch")
            worst.append(err)
        return worst

    lg_args = logistic_inputs(M, N, P)
    lg_large = logistic_inputs(*LARGE_P)
    (errs["logistic_grad"],
     errs["logistic_grad_unfused"]) = check_logistic(f"({M},{N},{P})",
                                                     lg_args)
    (errs["logistic_grad_p8192"],
     errs["logistic_grad_unfused_p8192"]) = check_logistic(
         "({},{},{})".format(*LARGE_P), lg_large)
    check_logistic("(3,500,1000)", logistic_inputs(3, 500, 1000))
    check_logistic("(2,7,129)", logistic_inputs(2, 7, 129))
    # the fused kernel's other modes: a shared-memory ring, X read twice
    check_logistic("(4,256,19329)", logistic_inputs(4, 256, 19329))
    check_logistic("(1,8,100003)", logistic_inputs(1, 8, 100003))
    torch.cuda.synchronize()
    check(int(logistic_ops.ticket_counters(dev, 1).abs().sum()) == 0,
          "the fused kernel left a ticket counter above zero")

    def check_kernel(name, label, fn, *args):
        """`fn` launched twice and on its plain path; every float output
        within TOL_KERNEL * max|plain|, every other output equal, and the
        two launches the same bits. Returns the max abs error."""
        def outs(use_kernel):
            out = fn(*args, use_kernel=use_kernel)
            return out if isinstance(out, tuple) else (out,)
        got, again, ref = outs(True), outs(True), outs(False)
        torch.cuda.synchronize()
        worst = 0.0
        for a, b in zip(got, ref):
            check(a.shape == b.shape and a.dtype == b.dtype,
                  f"{name} {label}: shape or dtype")
            if a.is_floating_point():
                err, scale = max_err(a.float(), b.float())
                check(err <= TOL_KERNEL * scale,
                      f"{name} {label}: err {err} > {TOL_KERNEL} * {scale}")
                worst = max(worst, err)
            else:
                check(bool(torch.equal(a, b)), f"{name} {label}: differs")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"{name} {label}: two launches gave different bits")
        print(f"check {name} {label}: max abs err {worst:.3g}, same bits "
              "on a second launch")
        return worst

    def ista_inputs(Sigmas, r, lam):
        m, p, _ = Sigmas.shape
        etas = 1.0 / torch.clamp_min(power_iteration_batched(Sigmas), 1e-12)
        b = 0.05 * torch.randn((m, p, r), generator=g, device=dev)
        c = (torch.eye(p, device=dev).expand(m, p, p).contiguous() if r == p
             else 0.1 * torch.randn((m, p, r), generator=g, device=dev))
        return Sigmas, b, c, etas, torch.full((m,), lam, device=dev)

    def single(args):
        Sigmas, b, c, etas, lams = args
        return Sigmas[0], b[0], c[0], etas[0], lams[0]

    isb_gemv = ista_inputs(Sig, 1, 0.5 * lam)
    isb_gemm = ista_inputs(Sig, P, mu)
    errs["ista_step_batched_gemv"] = check_kernel(
        "ista_step_batched", f"r=1 p={P}", ista_step_batched, *isb_gemv)
    errs["ista_step_batched_gemm"] = check_kernel(
        "ista_step_batched", f"r=p={P}", ista_step_batched, *isb_gemm)
    errs["ista_step_gemv"] = check_kernel(
        "ista_step", f"r=1 p={P}", ista_step, *single(isb_gemv))
    errs["ista_step_gemm"] = check_kernel(
        "ista_step", f"r=p={P}", ista_step, *single(isb_gemm))
    Xg, yg, _ = rank_inputs(3, 200, 129)
    Sig_g, _ = rank_update(Xg, yg, use_kernel=False)
    for r in (1, 7):
        rag = ista_inputs(Sig_g, r, 0.1)
        check_kernel("ista_step_batched", f"m=3 p=129 r={r}",
                     ista_step_batched, *rag)
        check_kernel("ista_step", f"p=129 r={r}", ista_step, *single(rag))
    errs["rank_update_sigma"] = errs["rank_update_c"] = check_kernel(
        "rank_update_unfused", f"({M},{N},{P})", rank_update_unfused, X, y)
    check_kernel("rank_update_unfused", f"({M},{N},{P}) weighted",
                 rank_update_unfused, X, y, w)
    Xs2, ys2, ws2 = rank_inputs(2, 7, 129)
    check_kernel("rank_update_unfused", "(2,7,129)", rank_update_unfused,
                 Xs2, ys2)
    check_kernel("rank_update_unfused", "(2,7,129) weighted",
                 rank_update_unfused, Xs2, ys2, ws2)

    def threshold_input(p, m, dtype=torch.float32):
        scale = 0.1 + 2.0 * torch.rand((p, 1), generator=g, device=dev)
        B = torch.randn((p, m), generator=g, device=dev) * scale
        return (B / float(np.sqrt(m))).to(dtype)

    check(all(threshold_ops.kernel_row_lanes(v) == threshold_ops.row_lanes(v)
              for v in range(1, 70)),
          "group_threshold: the launcher's lanes a row differ from "
          "row_lanes'")
    B_gt = threshold_input(P, M)
    errs["group_threshold"] = check_kernel(
        "group_threshold", f"({P},{M})", group_threshold, B_gt, 0.8)
    check_kernel("group_threshold", f"({P},{M}) bf16", group_threshold,
                 threshold_input(P, M, torch.bfloat16), 0.8)
    check_kernel("group_threshold", "(1001,5)", group_threshold,
                 threshold_input(1001, 5), 0.8)
    check_kernel("group_threshold", "(1001,5) bf16", group_threshold,
                 threshold_input(1001, 5, torch.bfloat16), 0.8)

    def flash_inputs(b, s, n, k, h, dtype):
        return tuple(torch.randn(shape, generator=g, device=dev).to(dtype)
                     for shape in ((b, s, n, h), (b, s, k, h), (b, s, k, h)))

    def check_flash(shape, dtype, causal=True, window=0):
        """The kernel twice and the plain version on the f32 upcast of the
        same inputs; every query row within TOL_FLASH_ROW[dtype] of the
        plain row (relative l2) and, in f32, max abs error <= TOL_FLASH *
        max|plain|."""
        qkv = flash_inputs(*shape, dtype)
        got = flash_attention(*qkv, causal=causal, window=window,
                              use_kernel=True)
        again = flash_attention(*qkv, causal=causal, window=window,
                                use_kernel=True)
        ref = flash_attention(*(t.float() for t in qkv), causal=causal,
                              window=window, use_kernel=False)
        torch.cuda.synchronize()
        label = (f"{shape} {str(dtype).split('.')[-1]} causal={causal} "
                 f"window={window}")
        check(got.shape == ref.shape and got.dtype == dtype,
              f"flash_attention {label}: shape or dtype")
        err, scale = max_err(got.float(), ref)
        rows = row_err(got.float(), ref)
        check(rows <= TOL_FLASH_ROW[dtype], f"flash_attention {label}: a "
              f"row's relative error {rows} > {TOL_FLASH_ROW[dtype]}")
        check(dtype != f32 or err <= TOL_FLASH * scale, f"flash_attention "
              f"{label}: err {err} > {TOL_FLASH} * {scale}")
        check(bool(torch.equal(got, again)),
              f"flash_attention {label}: two launches gave different bits")
        print(f"check flash_attention {label}: worst row relative err "
              f"{rows:.3g} (bar {TOL_FLASH_ROW[dtype]:g}), max abs err "
              f"{err:.3g} (max|plain| {scale:.3g}), same bits on a second "
              "launch")
        return err, qkv

    f32, bf16 = torch.float32, torch.bfloat16
    serve_cfg = get_config(cell.ARCH)
    flash_path = (cell.BATCH, cell.PROMPT, serve_cfg.n_heads,
                  serve_cfg.n_kv_heads, serve_cfg.resolved_head_dim)
    check_flash((2, 256, 8, 2, 64), f32)
    check_flash((1, 200, 4, 1, 128), f32)
    check_flash((1, 512, 4, 1, 256), f32, window=64)
    check_flash((2, 256, 8, 2, 64), f32, causal=False)
    errs["flash_attention"], flash_qkv = check_flash(flash_path, bf16)
    errs["flash_attention_h128"], flash_qkv128 = check_flash(FLASH_H128, bf16)
    check_flash((1, 200, 4, 1, 128), bf16)
    check_flash((1, 512, 4, 1, 256), bf16, window=64)
    check_flash((1, 300, 4, 2, 64), bf16, window=40)
    fb_, fs_, fn_, _, fh_ = flash_path
    print(f"flash launch at {flash_path} bf16: "
          f"{flash_ops.launch_plan(fb_, fs_, fn_, fh_, bf16)}")

    # ---- 4. the main path at full width -----------------------------------
    data = gen_regression(torch.Generator(device=dev).manual_seed(0),
                          m=M, n=N, p=P, s=S, signal_low=0.3, device=dev)
    Lam = 1.0
    fit_args = (data.Xs, data.ys, lam, mu, Lam)
    dsml_fit(*fit_args)                                  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = dsml_fit(*fit_args)
    torch.cuda.synchronize()
    fit_kernel_s = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    print(f"main path launches: {launches}")
    want = dict.fromkeys(LAUNCHES, 0)
    want.update(rank_update=1, fista_step_gemv=400, fista_step_gemm=600)
    check(launches == want,
          f"dsml_fit did not run through the kernels as expected: {launches}")

    t0 = time.perf_counter()
    ref = dsml_fit(*fit_args, use_kernel=False)
    torch.cuda.synchronize()
    fit_plain_s = time.perf_counter() - t0
    check(dict(LAUNCHES) == launches, "the plain path launched a kernel")

    for name, t in zip(res._fields, res):
        check(t.shape == getattr(ref, name).shape, f"{name} shape")
        if t.is_floating_point():
            check(bool(torch.isfinite(t).all()), f"{name} not finite")
    err, scale = max_err(res.beta_u, ref.beta_u)
    check(err <= TOL_FIT * scale,
          f"dsml_fit beta_u: err {err} > {TOL_FIT} * {scale}")
    check(bool(torch.equal(res.support, ref.support)), "supports differ")
    norms = torch.linalg.vector_norm(res.beta_u.T, dim=-1)
    margin = torch.min(torch.abs(norms - Lam)).item()
    ham = int(hamming(res.support, data.support))
    print(f"dsml_fit (m={M}, n={N}, p={P}, s={S}): beta_u max abs err vs "
          f"plain {err:.3g} (max|beta_u| {scale:.3g}); support size "
          f"{int(res.support.sum())}, identical; threshold margin "
          f"{margin:.4g}; hamming to the true support {ham}")
    print(f"dsml_fit wall: kernels {fit_kernel_s * 1e3:.1f} ms, plain "
          f"{fit_plain_s * 1e3:.1f} ms, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB {card}")

    # ---- 4b. the logistic path at full width ------------------------------
    cdata = gen_classification(torch.Generator(device=dev).manual_seed(0),
                               m=M, n=N, p=P, s=S, device=dev)
    lam_c = float(np.sqrt(np.log(P) / N))
    Lam_c = 0.75
    cfit_args = (cdata.Xs, cdata.ys, lam_c, 2.0 * lam_c, Lam_c)
    dsml_logistic_fit(*cfit_args)                        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    cres = dsml_logistic_fit(*cfit_args)
    torch.cuda.synchronize()
    cfit_kernel_s = time.perf_counter() - t0
    claunches = dict(LAUNCHES)
    print(f"logistic path launches: {claunches}")
    want = dict.fromkeys(LAUNCHES, 0)
    want.update(rank_update=2, logistic_grad=600, fista_step_gemm=600)
    check(claunches == want, "dsml_logistic_fit did not run through the "
          f"kernels as expected: {claunches}")

    t0 = time.perf_counter()
    cref = dsml_logistic_fit(*cfit_args, use_kernel=False)
    torch.cuda.synchronize()
    cfit_plain_s = time.perf_counter() - t0
    check(dict(LAUNCHES) == claunches, "the plain path launched a kernel")

    for name, t in zip(cres._fields, cres):
        check(t.shape == getattr(cref, name).shape, f"{name} shape")
        if t.is_floating_point():
            check(bool(torch.isfinite(t).all()), f"{name} not finite")
    for name in ("beta_u", "beta_local"):
        err, scale = max_err(getattr(cres, name), getattr(cref, name))
        check(err <= TOL_FIT * scale,
              f"dsml_logistic_fit {name}: err {err} > {TOL_FIT} * {scale}")
        print(f"dsml_logistic_fit {name}: max abs err vs plain {err:.3g} "
              f"(max|{name}| {scale:.3g})")
    check(bool(torch.equal(cres.support, cref.support)),
          "logistic supports differ")
    norms = torch.linalg.vector_norm(cres.beta_u.T, dim=-1)
    margin = torch.min(torch.abs(norms - Lam_c)).item()
    ham = int(hamming(cres.support, cdata.support))
    print(f"dsml_logistic_fit (m={M}, n={N}, p={P}, s={S}, lam={lam_c:.4g}, "
          f"Lam={Lam_c}): support size {int(cres.support.sum())}, "
          f"identical; threshold margin {margin:.4g}; hamming to the true "
          f"support {ham}")
    print(f"dsml_logistic_fit wall: kernels {cfit_kernel_s * 1e3:.1f} ms, "
          f"plain {cfit_plain_s * 1e3:.1f} ms, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.0f} MiB {card}")

    # ---- 4c. the remaining DSML kernels and the baselines -----------------
    def wall(fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    Xs, ys = data.Xs, data.ys
    Sig0, c0 = rank_update(Xs, ys, use_kernel=False)
    etas0 = 1.0 / torch.clamp_min(power_iteration_batched(Sig0), 1e-12)
    eye = torch.eye(P, device=dev)
    M0 = scaled_identity_m0(Sig0)
    lam_max = 2.0 * torch.max(torch.abs(c0)).item()
    grid = torch.tensor(lam_max * np.geomspace(1.0, 0.01, 8),
                        dtype=torch.float32, device=dev)
    base = float(np.sqrt(np.log(P) / N))      # benchmarks/paper_common.py
    baselines = {"group_lasso": (group_lasso, (Xs, ys, 2.0 * base, 400)),
                 "icap": (icap, (Xs, ys, 4.0 * base, 400)),
                 "dirty_model": (dirty_model, (Xs, ys, 2.0 * base, base,
                                               400))}
    for fn, args in baselines.values():         # warm-up: first-call costs
        fn(*args[:-1], 5)
    torch.cuda.synchronize()
    reset_launches()
    t4c = time.perf_counter()
    unf = rank_update_unfused(Xs, ys)
    fused = rank_update(Xs, ys)
    filtered, keep = group_threshold(res.beta_u.T, Lam)
    sol, sol_s = wall(ista_solve, Sig0[0], c0[0], 0.5 * lam, iters=400)
    step_p = ista_step(Sig0[0], M0[0], eye, etas0[0], mu)
    isb1 = ista_step_batched(Sig0, res.beta_local, c0, etas0, 0.5 * lam)
    isbp = ista_step_batched(Sig0, M0, eye.expand(M, P, P).contiguous(),
                             etas0, mu)
    Bgrid, grid_s = wall(solve_lasso_eq2_grid, Sig0, c0, grid, iters=400)
    base_out = {name: wall(fn, *args) for name, (fn, args)
                in baselines.items()}
    torch.cuda.synchronize()
    t4c = time.perf_counter() - t4c
    launches_4c = dict(LAUNCHES)
    print(f"phase 4c launches: {launches_4c}")
    want = dict.fromkeys(LAUNCHES, 0)
    want.update(rank_update_sigma=1, rank_update_c=1, rank_update=4,
                group_threshold=1, ista_step_gemv=400, ista_step_gemm=1,
                ista_step_batched_gemv=1, ista_step_batched_gemm=1,
                fista_step_gemv=400)
    check(launches_4c == want,
          f"phase 4c did not run through the kernels as expected: "
          f"{launches_4c}")
    new_keys = ("ista_step_batched_gemv", "ista_step_batched_gemm",
                "ista_step_gemv", "ista_step_gemm", "rank_update_sigma",
                "rank_update_c", "group_threshold")
    check(all(launches_4c[k] > 0 for k in new_keys),
          "a new kernel did not launch in phase 4c")

    for name, a, b in zip(("Sigma", "c"), unf, fused):
        err, scale = max_err(a, b)
        check(err <= TOL_KERNEL * scale, f"rank_update_unfused {name} vs "
              f"rank_update: err {err} > {TOL_KERNEL} * {scale}")
        print(f"rank_update_unfused {name} vs rank_update at ({M},{N},{P}): "
              f"max abs err {err:.3g} (max {scale:.3g})")
    check(bool(torch.equal(unf[0], fused[0])),
          "rank_update_unfused Sigma differs from rank_update's")
    check(bool(torch.equal(keep, res.support)),
          "group_threshold keep differs from dsml_fit's support")
    check(bool(torch.equal(filtered.T, res.beta_tilde)),
          "group_threshold rows differ from dsml_fit's beta_tilde")
    print(f"group_threshold of beta_u' at Lam={Lam}: keep equals the fit's "
          f"support ({int(keep.sum())} rows), filtered' equals beta_tilde")

    sol_ref, sol_ref_s = wall(ista_solve, Sig0[0], c0[0], 0.5 * lam,
                              iters=400, use_kernel=False)
    err, scale = max_err(sol, sol_ref)
    check(err <= TOL_FIT * scale,
          f"ista_solve: err {err} > {TOL_FIT} * {scale}")
    check(bool(torch.equal(sol != 0, sol_ref != 0)),
          "ista_solve supports differ")
    print(f"ista_solve (p={P}, 400 steps, lam={0.5 * lam:.4g}): max abs err "
          f"vs plain {err:.3g} (max|beta| {scale:.3g}); support "
          f"{int((sol != 0).sum())}, identical; wall kernels "
          f"{sol_s * 1e3:.1f} ms, plain {sol_ref_s * 1e3:.1f} ms {card}")
    for name, got, ref in (
            ("ista_step r=p", step_p,
             ista_step_ref(Sig0[0], M0[0], eye, etas0[0], mu)),
            ("ista_step_batched r=1", isb1,
             ista_step_batched_ref(Sig0, res.beta_local[..., None],
                                   c0[..., None], etas0, 0.5 * lam)[..., 0]),
            ("ista_step_batched r=p", isbp,
             ista_step_batched_ref(Sig0, M0, eye.expand(M, P, P), etas0,
                                   mu))):
        err, scale = max_err(got, ref)
        check(err <= TOL_KERNEL * scale,
              f"{name}: err {err} > {TOL_KERNEL} * {scale}")
        print(f"{name} on the fit's statistics: max abs err vs plain "
              f"{err:.3g} (max {scale:.3g})")

    Bgrid_ref, grid_ref_s = wall(solve_lasso_eq2_grid, Sig0, c0, grid,
                                 iters=400, use_kernel=False)
    check(Bgrid.shape == (8, M, P) and bool(torch.isfinite(Bgrid).all()),
          "grid shape or values")
    err, scale = max_err(Bgrid, Bgrid_ref)
    check(err <= TOL_FIT * scale,
          f"solve_lasso_eq2_grid: err {err} > {TOL_FIT} * {scale}")
    sizes = [int(b.any(0).sum()) for b in Bgrid]
    print(f"solve_lasso_eq2_grid (k=8, {8 * M} tasks, lam {lam_max:.4g} .. "
          f"{lam_max / 100:.4g}): max abs err vs plain {err:.3g} "
          f"(max|B| {scale:.3g}); union support per lam {sizes}; wall "
          f"kernels {grid_s * 1e3:.1f} ms, plain {grid_ref_s * 1e3:.1f} ms "
          f"{card}")
    for name, (fn, args) in baselines.items():
        out, secs = base_out[name]
        ref_out, ref_s = wall(fn, *args, use_kernel=False)
        out = out if isinstance(out, tuple) else (out,)
        ref_out = ref_out if isinstance(ref_out, tuple) else (ref_out,)
        worst = 0.0
        for a, b in zip(out, ref_out):
            check(a.shape == (P, M) and bool(torch.isfinite(a).all()),
                  f"{name}: shape or values")
            err, scale = max_err(a, b)
            check(err <= TOL_FIT * scale,
                  f"{name}: err {err} > {TOL_FIT} * {scale}")
            worst = max(worst, err)
        rows = int((torch.linalg.vector_norm(out[0], dim=1) > 0).sum())
        ham = int(hamming(torch.linalg.vector_norm(out[0], dim=1) > 1e-3,
                          data.support))
        print(f"{name} (400 iterations): support {rows} rows, hamming "
              f"{ham} to the true support; max abs err vs plain "
              f"{worst:.3g}; "
              f"wall kernels {secs * 1e3:.1f} ms, plain {ref_s * 1e3:.1f} "
              f"ms {card}")
    print(f"phase 4c wall (kernel paths): {t4c * 1e3:.1f} ms {card}")

    # ---- 5. times ---------------------------------------------------------
    m, n, p = M, N, P
    # Sigma is symmetric by construction: its least work is the upper
    # triangle (p (p + 1) / 2 dot products of length n per task) plus c;
    # the output bytes are the whole of Sigma
    def rank_work(m, n, p, weighted=False):
        """The least work of the fused update (Sigma's upper triangle, c,
        and w x where weighted) and its bytes (X, y, w in; Sigma, c out)."""
        return (m * n * p * (p + 1) + 2 * m * n * p + weighted * m * n * p,
                4 * (m * n * p + (1 + weighted) * m * n + m * p * p + m * p))

    rank_bound = bound(*rank_work(m, n, p))
    gemv_bound = bound(2 * m * p * p,
                       4 * (m * p * p + 3 * m * p + 2 * m + 2 * m * p))
    gemm_bound = bound(2 * m * p * p * p,
                       4 * (m * p * p + 3 * m * p * p + 2 * m + 2 * m * p * p))
    Xt = X.transpose(1, 2)
    S_out, c_out = torch.empty_like(Sig), torch.empty((m, p), device=dev)
    gemv_out = (torch.empty_like(gemv_args[1]), torch.empty_like(gemv_args[1]))
    gemm_out = (torch.empty_like(gemm_args[1]), torch.empty_like(gemm_args[1]))
    def flash_flops(shape):
        fb, fs, fn, _, fh = shape
        return 4 * fb * fn * (fs * (fs + 1) // 2) * fh

    def flash_row(name, shape, qkv):
        """The causal triangle on the bf16 tensor cores; q, k, v and out
        once each."""
        fb, fs, fn, fk, fh = shape
        fq, fkk, fv = qkv
        f_out = torch.empty_like(fq)
        return (name, "src/repro_torch/kernels/csrc/flash_attention.cu",
                "src/repro/kernels/flash_attention/kernel.py:83",
                bound(flash_flops(shape),
                      2 * (2 * fb * fs * fn * fh + 2 * fb * fs * fk * fh),
                      PEAK_BF16_FLOPS),
                lambda: flash_ops.launch(fq, fkk, fv, f_out),
                lambda: flash_attention(fq, fkk, fv),
                lambda: flash_attention(fq, fkk, fv, use_kernel=False),
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    fq.transpose(1, 2), fkk.transpose(1, 2),
                    fv.transpose(1, 2), is_causal=True, enable_gqa=True))

    # the weighted launch's yardstick: one bmm on (w X)' computed aside
    Xwt = (X * w[..., None]).transpose(1, 2)
    Xit = Xi.transpose(1, 2)
    Si_out = torch.empty((INGEST[0], INGEST[2], INGEST[2]), device=dev)
    ci_out = torch.empty((INGEST[0], INGEST[2]), device=dev)
    rows = [
        flash_row("flash_attention", flash_path, flash_qkv),
        flash_row("flash_attention_h128", FLASH_H128, flash_qkv128),
        ("rank_update", "src/repro_torch/kernels/csrc/rank_update.cu",
         "src/repro/kernels/rank_update/kernel.py:121", rank_bound,
         lambda: rank_ops.launch(X, y, None, S_out, c_out),
         lambda: rank_update(X, y),
         lambda: rank_update_ref(X, y),
         lambda: torch.bmm(Xt, X)),
        # the logistic fit's Hessian launch: Sigma = X'WX/n, c = X'Wy/n
        ("rank_update_weighted", "src/repro_torch/kernels/csrc/rank_update.cu",
         "src/repro/kernels/rank_update/kernel.py:121",
         bound(*rank_work(m, n, p, weighted=True)),
         lambda: rank_ops.launch(X, y, w, S_out, c_out),
         lambda: rank_update(X, y, w),
         lambda: rank_update_ref(X, y, w),
         lambda: torch.bmm(Xwt, X)),
        # one chunk of the streaming service's ingest
        ("rank_update_ingest", "src/repro_torch/kernels/csrc/rank_update.cu",
         "src/repro/kernels/rank_update/kernel.py:121",
         bound(*rank_work(*INGEST)),
         lambda: rank_ops.launch(Xi, yi, None, Si_out, ci_out),
         lambda: rank_update(Xi, yi),
         lambda: rank_update_ref(Xi, yi),
         lambda: torch.bmm(Xit, Xi)),
        ("fista_step_gemv", "src/repro_torch/kernels/csrc/fista_step.cu",
         "src/repro/kernels/ista_step/kernel.py:108", gemv_bound,
         lambda: ista_ops.launch(*gemv_args, *gemv_out),
         lambda: fista_step_batched(*gemv_args),
         lambda: fista_step_batched_ref(*gemv_args),
         lambda: torch.bmm(Sig, gemv_args[1])),
        ("fista_step_gemm", "src/repro_torch/kernels/csrc/fista_step.cu",
         "src/repro/kernels/ista_step/kernel.py:108", gemm_bound,
         lambda: ista_ops.launch(*gemm_args, *gemm_out),
         lambda: fista_step_batched(*gemm_args),
         lambda: fista_step_batched_ref(*gemm_args),
         lambda: torch.bmm(Sig, gemm_args[1])),
    ]
    for suffix, (Xl, yl, Bl) in (("", lg_args), ("_p8192", lg_large)):
        lm, ln, lp = Xl.shape
        pl = logistic_ops.plan(lm, ln, lp, sms, smem_optin)
        G = torch.empty((lm, lp), device=dev)
        work = torch.empty((lm, pl.chunks, lp), device=dev)
        counters = torch.zeros(lm * pl.cluster, dtype=torch.int32,
                               device=dev)
        rbuf = torch.empty((lm, ln), device=dev)
        rl = yl * torch.sigmoid(-yl * torch.bmm(Xl, Bl[..., None])[..., 0])
        Xlt = Xl.transpose(1, 2)
        # no PyTorch call computes this function: the library row is
        # its two products, X b and X' r, timed together
        lib = (lambda Xl=Xl, Bl=Bl, Xlt=Xlt, rl=rl:
               (torch.bmm(Xl, Bl[..., None]), torch.bmm(Xlt, rl[..., None])))
        rows += [
            ("logistic_grad" + suffix,
             "src/repro_torch/kernels/csrc/logistic_grad.cu",
             "src/repro/kernels/logistic_grad/kernel.py:149",
             bound(4 * lm * ln * lp,
                   4 * (lm * ln * lp + lm * ln + 2 * lm * lp)),
             lambda a=(Xl, yl, Bl, G, work, counters):
                 logistic_ops.launch(*a),
             lambda a=(Xl, yl, Bl): logistic_grad(*a),
             lambda a=(Xl, yl, Bl): logistic_grad_ref(*a),
             lib),
            # its own two-dispatch contract: X read twice, r written and
            # read back through device memory
            ("logistic_grad_unfused" + suffix,
             "src/repro_torch/kernels/csrc/logistic_grad.cu",
             "src/repro/kernels/logistic_grad/kernel.py:198",
             bound(4 * lm * ln * lp,
                   4 * (2 * lm * ln * lp + 2 * lm * lp + 3 * lm * ln)),
             lambda a=(Xl, yl, Bl, rbuf, G): logistic_ops.launch_unfused(*a),
             lambda a=(Xl, yl, Bl): logistic_grad_unfused(*a),
             lambda a=(Xl, yl, Bl): logistic_grad_unfused(*a,
                                                          use_kernel=False),
             lib),
        ]
    # the step without momentum, m tasks and one task (m = 1): Sigma,
    # beta, c and the output, no x and no z'
    def ista_row(name, args, counter):
        Sl, bl, cl, el, ll = args
        tm, tp, tr = bl.shape
        out = torch.empty_like(bl)
        wrapped = args if counter == "ista_step_batched" else \
            (Sl[0], bl[0], cl[0], el[0], ll[0])
        wrapper = ista_step_batched if counter == "ista_step_batched" \
            else ista_step
        plain = ista_step_batched_ref if counter == "ista_step_batched" \
            else ista_step_ref
        return (name, "src/repro_torch/kernels/csrc/fista_step.cu",
                "src/repro/kernels/ista_step/kernel.py:" +
                ("153" if counter == "ista_step_batched" else "196"),
                bound(2 * tm * tp * tp * tr,
                      4 * (tm * tp * tp + 3 * tm * tp * tr + 2 * tm)),
                lambda: ista_ops.launch_ista(*args, out, counter),
                lambda: wrapper(*wrapped),
                lambda: plain(*wrapped),
                lambda: torch.bmm(Sl, bl))

    def one_task(args):
        Sl, bl, cl, el, ll = args
        return (Sl[:1].contiguous(), bl[:1].contiguous(),
                cl[:1].contiguous(), el[:1].contiguous(), ll[:1].contiguous())

    rows += [
        ista_row("ista_step_batched_gemv", isb_gemv, "ista_step_batched"),
        ista_row("ista_step_batched_gemm", isb_gemm, "ista_step_batched"),
        ista_row("ista_step_gemv", one_task(isb_gemv), "ista_step"),
        ista_row("ista_step_gemm", one_task(isb_gemm), "ista_step"),
    ]
    c_out2 = torch.empty((m, p), device=dev)
    yt = y[..., None]
    gt_out = torch.empty_like(B_gt)
    gt_keep = torch.empty(P, dtype=torch.int8, device=dev)
    pg, mg = B_gt.shape
    rows += [
        # Sigma alone: the symmetric least work, X in and Sigma out
        ("rank_update_sigma", "src/repro_torch/kernels/csrc/rank_update.cu",
         "src/repro/kernels/rank_update/kernel.py:162",
         bound(m * n * p * (p + 1), 4 * (m * n * p + m * p * p)),
         lambda: rank_ops.launch_sigma(X, None, S_out),
         lambda: rank_update_unfused(X, y),
         lambda: rank_sigma_ref(X),
         lambda: torch.bmm(Xt, X)),
        # c alone: X, y in, c out
        ("rank_update_c", "src/repro_torch/kernels/csrc/rank_update.cu",
         "src/repro/kernels/rank_update/kernel.py:162",
         bound(2 * m * n * p, 4 * (m * n * p + m * n + m * p)),
         lambda: rank_ops.launch_c(X, y, None, c_out2),
         lambda: rank_update_unfused(X, y),
         lambda: rank_c_ref(X, y),
         lambda: torch.bmm(Xt, yt)),
        # B in, B out, the int8 keep column
        ("group_threshold", "src/repro_torch/kernels/csrc/group_threshold.cu",
         "src/repro/kernels/group_threshold/kernel.py:28",
         bound(2 * pg * mg + pg, 4 * 2 * pg * mg + pg),
         lambda: threshold_ops.launch(B_gt, 0.8, gt_out, gt_keep),
         lambda: group_threshold(B_gt, 0.8),
         lambda: group_threshold_ref(B_gt, 0.8),
         lambda: B_gt * (torch.linalg.vector_norm(B_gt, dim=1,
                                                  keepdim=True) > 0.8)),
    ]
    shapes = {"rank_update": (m, n, p), "fista_step_gemv": (m, p, 1),
              "fista_step_gemm": (m, p, p),
              "logistic_grad": (M, N, P), "logistic_grad_unfused": (M, N, P),
              "logistic_grad_p8192": LARGE_P,
              "logistic_grad_unfused_p8192": LARGE_P,
              "ista_step_batched_gemv": (m, p, 1),
              "ista_step_batched_gemm": (m, p, p),
              "ista_step_gemv": (1, p, 1), "ista_step_gemm": (1, p, p),
              "rank_update_sigma": (m, n, p), "rank_update_c": (m, n, p),
              "group_threshold": (pg, mg), "flash_attention": flash_path,
              "rank_update_weighted": (m, n, p),
              "rank_update_ingest": INGEST,
              "flash_attention_h128": FLASH_H128}
    # the redesigned kernels' least work, for their achieved rate
    row_flops = {"flash_attention": flash_flops(flash_path),
                 "flash_attention_h128": flash_flops(FLASH_H128),
                 "fista_step_gemm": 2 * m * p * p * p,
                 "ista_step_gemm": 2 * p * p * p,
                 "rank_update": rank_work(m, n, p)[0],
                 "rank_update_weighted": rank_work(m, n, p, True)[0],
                 "rank_update_ingest": rank_work(*INGEST)[0],
                 "rank_update_sigma": m * n * p * (p + 1)}
    kernels = []              # launches per run are added after phase 6
    for (name, source, replaces, (bound_ms, bound_by), kern, wrapper, plain,
         lib) in rows:
        ms, wrap_ms = time_ms(kern), time_ms(wrapper)
        plain_ms, lib_ms = time_ms(plain), time_ms(lib)
        cold_ms = time_ms_cold(kern)
        (g_ms, g_how), (lg_ms, lg_how) = graph_ms(kern), graph_ms(lib)
        print(f"time {name}: kernel {ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by}), plain {plain_ms:.4f} ms, library {lib_ms:.4f} "
              f"ms, wrapper {wrap_ms:.4f} ms, kernel with L2 flushed "
              f"{cold_ms:.4f} ms; device only: kernel {g_ms:.4f} ms "
              f"({g_how}), library {lg_ms:.4f} ms ({lg_how}) {card}")
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "shape": list(shapes[name]),
               "max_abs_err": errs[name], "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": lib_ms,
               "cold_ms": cold_ms, "wrapper_ms": wrap_ms,
               "graph_ms": g_ms, "library_graph_ms": lg_ms,
               "graph_method": g_how, "library_graph_method": lg_how}
        if name in row_flops:
            row["tflops"] = row_flops[name] / ms / 1e9
            print(f"rate {name}: kernel {row['tflops']:.1f} TFLOP/s, library "
                  f"{row_flops[name] / lib_ms / 1e9:.1f} TFLOP/s {card}")
        kernels.append(row)
    # the floor of any launch: a kernel that does nothing, timed as the
    # rows are, beside the group threshold (a launch-bound kernel)
    empty = lambda: threshold_ops.launch_empty(dev)       # noqa: E731
    floor_ms, (floor_g, floor_how) = time_ms(empty), graph_ms(empty)
    print(f"time empty kernel (the launch floor): events {floor_ms:.4f} ms; "
          f"device only {floor_g:.4f} ms ({floor_how}) {card}")
    next(r for r in kernels if r["name"] == "group_threshold").update(
        launch_floor_ms=floor_ms, launch_floor_graph_ms=floor_g)

    # ---- 6. the serving path at full width -------------------------------
    def prefill(params, cfg, prompt, steps, use_kernel=None):
        """One prefill, as `greedy_generate` runs it: its last logits (f32)
        and its wall time."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = forward_prefill(params, cfg, Batch(tokens=prompt),
                                         cache_len=prompt.shape[1] + steps,
                                         use_kernel=use_kernel)
        torch.cuda.synchronize()
        del caches
        return logits.float(), time.perf_counter() - t0

    def generate(params, cfg, prompt, steps, use_kernel=None):
        """`greedy_generate` with the launch counts zeroed just before and
        read just after; (tokens, wall seconds, launches)."""
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        out = greedy_generate(params, cfg, prompt, steps=steps,
                              use_kernel=use_kernel)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, dict(LAUNCHES)

    def serve_checks(label, cfg, out, prompt, steps, got, want_flash):
        b, s = prompt.shape
        check(out.shape == (b, s + steps) and out.dtype == prompt.dtype,
              f"{label}: generated shape {tuple(out.shape)}")
        check(bool(torch.equal(out[:, :s], prompt)),
              f"{label}: the prompt changed")
        check(bool(((out >= 0) & (out < cfg.padded_vocab)).all()),
              f"{label}: a token outside the vocabulary")
        want = dict.fromkeys(LAUNCHES, 0)
        want["flash_attention"] = want_flash
        check(got == want, f"{label}: launches {got}, expected "
              f"flash_attention={want_flash} and nothing else")

    steps = cell.NEW_TOKENS
    base_mem = torch.cuda.memory_allocated()
    cfg, params, prompt = cell.make_cell(dev)
    batch, plen = prompt.shape
    weights_gib = (torch.cuda.memory_allocated() - base_mem) / 2**30
    generate(params, cfg, prompt, 2)                     # warm-up
    torch.cuda.reset_peak_memory_stats()
    out, gen_s, serve_launches = generate(params, cfg, prompt, steps)
    peak_total_gib = torch.cuda.max_memory_allocated() / 2**30
    peak_gib = peak_total_gib - base_mem / 2**30
    print(f"serving path launches: {serve_launches}")
    serve_checks(f"{cfg.name} kernels", cfg, out, prompt, steps,
                 serve_launches, cfg.n_layers)
    out_p, gen_plain_s, plain_launches = generate(params, cfg, prompt, steps,
                                                  use_kernel=False)
    serve_checks(f"{cfg.name} plain", cfg, out_p, prompt, steps,
                 plain_launches, 0)
    logits_k, pre_s = prefill(params, cfg, prompt, steps)
    logits_p, pre_plain_s = prefill(params, cfg, prompt, steps,
                                    use_kernel=False)
    check(bool(torch.isfinite(logits_k).all()), "prefill logits not finite")
    err, scale = max_err(logits_k, logits_p)
    check(err <= TOL_SERVE_BF16 * scale, f"{cfg.name} prefill logits: err "
          f"{err} > {TOL_SERVE_BF16} * {scale}")
    shared = int((out[:, plen:] == out_p[:, plen:]).sum())
    decode_ms = (gen_s - pre_s) / (steps - 1) * 1e3
    print(f"{cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.resolved_head_dim}, "
          f"{cfg.compute_dtype}), batch {batch}, prompt {plen}, "
          f"{steps} new tokens: prefill last logits vs plain max abs "
          f"err {err:.4g} = {err / scale:.4g} of max|logits| {scale:.4g}; "
          f"{shared} of {batch * steps} generated tokens shared "
          f"with the plain path")
    print(f"{cfg.name} serving wall: generate {gen_s * 1e3:.1f} ms (plain "
          f"{gen_plain_s * 1e3:.1f}), prefill {pre_s * 1e3:.1f} ms (plain "
          f"{pre_plain_s * 1e3:.1f}), decode {decode_ms:.2f} ms per token "
          f"step ((generate - prefill) / {steps - 1}), "
          f"{batch * steps / gen_s:.1f} tokens/s; weights "
          f"{weights_gib:.2f} GiB; peak during generate {peak_gib:.2f} GiB "
          f"(weights included), {peak_total_gib:.2f} GiB with what earlier "
          f"phases hold {card}")
    del params, logits_k, logits_p

    cfg32, p32, _ = cell.make_cell(dev, n_layers=4, param_dtype="float32",
                                   compute_dtype="float32")
    prompt32 = prompt[:2]
    out32, gen32_s, launches32 = generate(p32, cfg32, prompt32, 8)
    serve_checks(f"{cfg.name} f32 4 layers", cfg32, out32, prompt32, 8,
                 launches32, cfg32.n_layers)
    out32_p, _, _ = generate(p32, cfg32, prompt32, 8, use_kernel=False)
    check(bool(torch.equal(out32, out32_p)),
          "f32 4 layers: kernel and plain paths gave different tokens")
    l32, _ = prefill(p32, cfg32, prompt32, 8)
    l32_p, _ = prefill(p32, cfg32, prompt32, 8, use_kernel=False)
    err, scale = max_err(l32, l32_p)
    check(err <= TOL_FIT * scale, f"f32 4 layers prefill logits: err {err} "
          f"> {TOL_FIT} * {scale}")
    print(f"{cfg.name} f32 at 4 layers (batch 2, prompt {plen}, 8 new "
          f"tokens): identical tokens on both paths; prefill last logits "
          f"max abs err {err:.3g} (max|logits| {scale:.3g}); generate "
          f"{gen32_s * 1e3:.1f} ms {card}")
    del p32

    # ---- 7. the streaming service ------------------------------------------
    launches_ingest, carried = stream_phase(dev, card, data, res, cdata,
                                            cres, cfit_args, lam, mu, Lam)

    # ---- 8. the distributed path ---------------------------------------
    launches_8 = distributed_phase(dev, card, data, res, carried, lam, mu,
                                   Lam)

    # launches per run: the regression rows from phase 4, the logistic
    # rows from phase 4b (the unfused pair is not on either path), the
    # rows of the third slice from phase 4c, flash from phase 6, the
    # ingest shape's row from phase 7c's 8 chunks; a row at another
    # shape than its path's takes its kernel's count
    run_launches = {**launches,
                    "rank_update_weighted": claunches["rank_update"],
                    "rank_update_ingest": launches_ingest,
                    "flash_attention_h128": serve_launches["flash_attention"],
                    "logistic_grad": claunches["logistic_grad"],
                    "logistic_grad_p8192": claunches["logistic_grad"],
                    "logistic_grad_unfused": claunches["logistic_z"],
                    "logistic_grad_unfused_p8192": claunches["logistic_z"],
                    **{k: launches_4c[k] for k in new_keys},
                    "flash_attention": serve_launches["flash_attention"]}
    print(json.dumps({"kernels": [
        {**row, "launches": run_launches[row["name"]],
         "launches_phase8": launches_8.get(row["name"], 0)}
        for row in kernels]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
