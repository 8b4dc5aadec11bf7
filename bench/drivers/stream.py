"""The online service as deployed: `StreamingDsmlService` ingesting
chunks in a closed loop, refitting by its policy, while an open-loop
client sends single-row requests to its `ServingFront` with Poisson
arrivals at the traffic's fixed rate. Ingest, refits and the front
share one card.

Set-up makes a pool of chunks drawn from one model (stationary, as the
configuration's source), starts the service and the front, ingests
until the warm refit path has run, and sends a few bursts through the
front. `verify` then holds every generation the service published to
the plain reference's generation on the same rows, at the cadence the
reference's own policy sets, and every answer to the reference's model
of the generation that scored it. `control` puts the reference in TF32
in the program's place and hands its generations and answers to the
same `verify`.
"""
from __future__ import annotations

import functools
import threading
import time

import numpy as np
import torch

from bench import datagen, devtrace, harness, roofline
from bench.drivers import fit
from bench.reference import dsml as ref


def make_pool(g, cfg, tr):
    """The chunks, in ingest order, and the request rows."""
    m, p, rows = cfg["m"], cfg["p"], tr["chunk_rows"]
    L = datagen.ar_factor(p, cfg["rho"], g.device)
    B, _ = datagen.coefficients(g, m, p, cfg["s"], cfg["signal_low"],
                                cfg["signal_high"], g.device)
    chunks = []
    for _ in range(tr["pool_chunks"]):
        X = datagen.design(g, L, m, rows)
        chunks.append((X, datagen.responses(g, X, B, cfg["sigma"])))
    req = datagen.design(g, L, tr["row_pool"])
    return chunks, req


class Requests:
    """The open-loop client's log: for request k, when it was due and
    sent, when its answer came, the generations published at send and at
    answer, the generation that scored it and its scores."""

    def __init__(self, n: int, m: int):
        self.due = np.zeros(n)
        self.sent_at = np.zeros(n)
        self.done_at = np.zeros(n)
        self.gen_sent = np.zeros(n, dtype=np.int64)
        self.gen_done = np.zeros(n, dtype=np.int64)
        self.scored = np.full(n, -1, dtype=np.int64)
        self.scores = np.zeros((n, m), dtype=np.float32)
        self.ok = np.zeros(n, dtype=bool)
        self.finished = np.zeros(n, dtype=bool)
        self.sent = 0

    def send(self, k: int, due: float, generation: int) -> None:
        self.due[k], self.gen_sent[k] = due, generation
        self.sent_at[k] = time.perf_counter()
        self.sent = k + 1

    def done(self, k: int, svc, fut) -> None:
        """The future's callback, on the front's worker thread."""
        self.done_at[k] = time.perf_counter()
        self.gen_done[k] = svc.serving().generation
        if fut.exception() is None:
            res = fut.result()
            self.scored[k] = res.generation
            self.scores[k] = res.scores[:, 0]
            self.ok[k] = True
        self.finished[k] = True

    def answered(self, ks: np.ndarray, generation: int, scores) -> None:
        """Requests `ks` answered at once by `generation` (the control's):
        `scores` (len(ks), m)."""
        self.gen_sent[ks] = self.gen_done[ks] = self.scored[ks] = generation
        self.scores[ks] = scores
        self.ok[ks] = self.finished[ks] = True
        self.sent = max(self.sent, int(ks.max()) + 1)

    def wait(self, deadline: float) -> None:
        """Until every request sent has its answer, or the deadline."""
        while not self.finished[:self.sent].all() \
                and time.perf_counter() < deadline:
            time.sleep(0.01)


def latency_p(lat_ms: np.ndarray, q: float) -> float:
    return float(np.percentile(lat_ms, q, method="linear"))


def quarters(due, lat, seconds: float) -> list:
    """Mean latency of the requests due in each quarter of the window
    (`due` in seconds from its start)."""
    out = []
    for q in range(4):
        sel = (due >= q * seconds / 4) & (due < (q + 1) * seconds / 4)
        out.append(float(np.mean(lat[sel])) if sel.any() else float("nan"))
    return out


def run(ctx: harness.Context) -> harness.Outcome:
    from repro_torch import obs
    from repro_torch.kernels.common import LAUNCHES
    from repro_torch.stream import ServingFront, StreamingDsmlService

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    m, p, rows = cfg["m"], cfg["p"], tr["chunk_rows"]
    t_import = time.perf_counter()
    g = datagen.generator(ctx.seed, ctx.device)
    chunks, req_dev = make_pool(g, cfg, tr)
    req_host = req_dev.cpu().numpy()
    t_data = time.perf_counter()
    svc = StreamingDsmlService(
        m, p, lam=cfg["lam"], mu=cfg["mu"], Lam=cfg["Lam"],
        device=ctx.device, refit_every=cfg["refit_every"],
        max_refit_interval=cfg["max_refit_interval"],
        drift_threshold=cfg["drift_threshold"], refit_tol=cfg["refit_tol"],
        guard=cfg["guard"], decay=cfg["decay"], lasso_iters=cfg["lasso_iters"],
        debias_iters=cfg["debias_iters"],
        warm_lasso_iters=cfg["warm_lasso_iters"],
        warm_debias_iters=cfg["warm_debias_iters"], chunk_n=rows)
    front = ServingFront(svc, max_batch=cfg["max_batch"],
                         max_delay_ms=cfg["max_delay_ms"]).start()
    published = []           # (chunks ingested, ModelGeneration)
    state = {"chunks": 0}

    def ingest_one():
        i = state["chunks"]
        X, y = chunks[i % len(chunks)]
        with devtrace.mark("ingest"):
            svc.ingest(X, y)
        state["chunks"] = i + 1
        snap = svc.serving()
        last = published[-1][1].generation if published else 0
        if snap.generation != last:
            published.append((i + 1, snap))

    t_service = time.perf_counter()
    try:
        for _ in range(tr["setup_chunks"]):
            ingest_one()
        t_ingest = time.perf_counter()
        for burst in tr["setup_bursts"]:
            futs = [front.submit(req_host[j]) for j in range(burst)]
            for f in futs:
                f.result(timeout=60)
        harness.sync(ctx.device)
        harness.release(ctx.device)          # the same start every run

        n_req = int(tr["rate_per_s"] * ctx.seconds * 1.5) + 100
        gaps = datagen.permuted_gaps(ctx.seed, tr["rate_per_s"], n_req)
        # one slot a request, in arrays: the window's bookkeeping makes
        # no objects that outlive a request (no collector pauses from it)
        log = Requests(n_req, m)
        obs.reset()
        before = dict(LAUNCHES)
        clock = {}

        def client():
            due, t_close = clock["t0"], clock["close"]
            for k, gap in enumerate(gaps):
                due += gap
                if due >= t_close:
                    return
                wait = due - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                log.send(k, due, svc.serving().generation)
                fut = front.submit(req_host[k % len(req_host)])
                fut.add_done_callback(functools.partial(log.done, k, svc))

        with devtrace.traced(ctx.trace) as box:
            with devtrace.mark("window"):
                t0 = time.perf_counter()
                t_close = clock["close"] = t0 + ctx.seconds
                clock["t0"] = t0
                sender = threading.Thread(target=client, name="bench-client")
                sender.start()
                chunks_before = state["chunks"]
                while time.perf_counter() < t_close:
                    ingest_one()
                t1 = time.perf_counter()
                sender.join()
                log.wait(t_close + 60.0)      # answers due in the window
        window_chunks = state["chunks"] - chunks_before
    finally:
        front.stop()
    launches = harness.launches_delta(before, LAUNCHES)
    spans = harness.span_stats(obs, ["stream.refit.ms", "serve.batch.ms",
                                     "serve.batch_rows", "stream.ingest.ms",
                                     "stream.refit.debias_iters",
                                     "stream.refit.lasso_iters"])
    served_rows = obs.counter_total("serve.rows")
    peak = harness.memory_peak(ctx.device)

    n = log.sent
    ok = log.ok[:n]
    failed = int(n - ok.sum())
    # a request that failed or never came counts as missing any limit
    lat = np.where(ok, (log.done_at[:n] - log.due[:n]) * 1e3,
                   (t_close + 60.0 - t0) * 1e3)
    late = (log.sent_at[:n] - log.due[:n]) * 1e3

    debias_steps = spans.get("stream.refit.debias_iters", {}).get("sum", 0)
    lasso_steps = spans.get("stream.refit.lasso_iters", {}).get("sum", 0)
    gemm = roofline.bound_s(roofline.gemm_step_flops(m, p, p),
                            roofline.gemm_step_bytes(m, p, p))
    flops = (window_chunks * roofline.rank_update_flops(m, rows, p)
             + roofline.refit_flops(m, p, lasso_steps, debias_steps)
             + roofline.predict_flops(m, p, served_rows))
    work = {"gemm_bound_s": debias_steps * gemm, "flops": flops}
    window = harness.Window(t1 - t0, window_chunks, launches, spans, work,
                            box["trace"])
    batch_rows = spans.get("serve.batch_rows", {}).get("mean")
    notes = [fit.plans(m, p, rows, ctx.device),
             f"set-up: to the imports {t_import - ctx.t_start:.3f} s, the "
             f"data {t_data - t_import:.3f} s, the service "
             f"{t_service - t_data:.3f} s, {tr['setup_chunks']} chunks "
             f"{t_ingest - t_service:.3f} s, the front's bursts (and a "
             f"trace's start) {t0 - t_ingest:.3f} s",
             f"requests {n} at {tr['rate_per_s']}/s offered, "
             f"{failed} failed; chunks {window_chunks}; refits "
             f"{spans.get('stream.refit.ms', {}).get('count', 0)}",
             f"request ms p50 {latency_p(lat, 50):.4f} p99 "
             f"{latency_p(lat, 99):.4f} max {lat.max():.4f}; "
             f"sender late ms p50 {latency_p(late, 50):.4f} p99 "
             f"{latency_p(late, 99):.4f} max {late.max():.4f}",
             "request ms mean by quarter of the window (a growing backlog "
             "rises): " + " ".join(f"{q:.4f}" for q in quarters(
                 log.due[:n] - t0, lat, ctx.seconds)),
             f"stream.refit.ms mean "
             f"{spans.get('stream.refit.ms', {}).get('mean')}; serve.batch.ms "
             f"mean {spans.get('serve.batch.ms', {}).get('mean')}",
             f"front batch rows mean {batch_rows}; stream.ingest.ms mean "
             f"{spans.get('stream.ingest.ms', {}).get('mean')}"]

    harness.release(ctx.device)
    checks = harness.Checks(ctx.cell.limits)
    verify(ctx, checks, chunks, state["chunks"],
           [(c, snap.generation, snap.beta_tilde, snap.support)
            for c, snap in published], log, req_dev)
    e2e = {"ingest_rows_per_s": m * rows * window_chunks / (t1 - t0),
           "request_p99_ms": latency_p(lat, 99),
           "setup_s": t0 - ctx.t_start}
    return harness.Outcome(e2e, window, checks, n + window_chunks, failed,
                           peak, notes)


def reference_model(cfg: dict, device) -> ref.Stream:
    return ref.Stream(
        cfg["m"], cfg["p"], lam=cfg["lam"], mu=cfg["mu"], Lam=cfg["Lam"],
        lasso_iters=cfg["lasso_iters"], debias_iters=cfg["debias_iters"],
        warm_lasso_iters=cfg["warm_lasso_iters"],
        warm_debias_iters=cfg["warm_debias_iters"],
        refit_every=cfg["refit_every"],
        max_refit_interval=cfg["max_refit_interval"],
        drift_threshold=cfg["drift_threshold"], device=device)


def verify(ctx, checks, pool, n_chunks: int, published: list,
           log: Requests, req_dev) -> None:
    """The comparison that decides `correct`: replay the first `n_chunks`
    chunks of `pool` through the float32 reference, and hold each of its
    generations to the one `published` (chunks ingested, generation,
    beta_tilde, support) after the same chunk, and every answer of `log`
    to the reference's model of the generation that scored it."""
    n = log.sent
    ok = log.ok[:n]
    gens = {g: (c, bt, sup) for c, g, bt, sup in published}
    want_gens = {}
    with ref.precision("f32"):
        model = reference_model(ctx.cell.config, ctx.device)
        missing = 0
        for i in range(n_chunks):
            want = model.ingest(*pool[i % len(pool)])
            if want is None:
                continue
            want_gens[want["generation"]] = want["beta_tilde"]
            got = gens.get(want["generation"])
            if got is None or got[0] != i + 1:
                missing += 1
                continue
            checks.worst("beta_tilde_gap", ref.gap(got[1], want["beta_tilde"]))
            checks.worst("support_diff", ref.mismatches(got[2],
                                                        want["support"]))
        # a refit on one side that the other did not make, or made later
        missing += len(set(gens) - set(want_gens))
        checks.worst("refits_missing", missing)
        err = scale = 0.0
        wrong_gen = 0
        scored_by = log.scored[:n]
        rows_of = np.arange(n) % len(req_dev)
        for g in np.unique(scored_by[ok]):
            sel = np.flatnonzero(ok & (scored_by == g))
            if int(g) not in want_gens:
                wrong_gen += len(sel)
                continue
            X = req_dev[torch.as_tensor(rows_of[sel], device=req_dev.device)]
            want = (X @ want_gens[int(g)].T).cpu().numpy()      # (r, m)
            err = max(err, float(np.max(np.abs(log.scores[sel] - want))))
            scale = max(scale, float(np.max(np.abs(want))))
        gap = err / scale if scale > 0 else (0.0 if err == 0 else np.inf)
        checks.worst("answer_gap", np.inf if wrong_gen else gap)
        checks.worst("answers_missing", int(n - ok.sum()))
        # scored by a generation published while the request was in flight
        checks.worst("answers_stale", int(np.sum(
            ok & ((scored_by < log.gen_sent[:n])
                  | (scored_by > log.gen_done[:n])))))


def control(ctx, checks, chunks: int | None = None) -> None:
    """The reference in TF32 in the program's place: it ingests `chunks`
    chunks (about as many as a run's set-up and window) and publishes its
    generations; as many requests as the window's rate offers are
    answered by its generations in turn, each generation's requests as one
    batch, as the front scores them, in TF32. All of it goes to
    `verify`."""
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    pool, req = make_pool(datagen.generator(ctx.seed, ctx.device), cfg, tr)
    chunks = chunks or len(pool)
    published = []
    with ref.precision("tf32"):
        model = reference_model(cfg, ctx.device)
        for i in range(chunks):
            out = model.ingest(*pool[i % len(pool)])
            if out is not None:
                published.append((i + 1, out["generation"],
                                  out["beta_tilde"], out["support"]))
        n = max(int(tr["rate_per_s"] * ctx.seconds), len(published))
        log = Requests(n, cfg["m"])
        by_gen = np.arange(n) * len(published) // n
        for j, (_, g, bt, _) in enumerate(published):
            ks = np.flatnonzero(by_gen == j)
            X = req[torch.as_tensor(ks % len(req), device=req.device)]
            log.answered(ks, g, (X @ bt.T).cpu().numpy())
    verify(ctx, checks, pool, chunks, published, log, req)
