"""Online DSML over a non-stationary stream: ingest minibatches, let the
drift-aware service decide when to refit, and watch it re-acquire the
support after a mid-stream regime shift.

    PYTHONPATH=src python -m repro_torch.launch.stream_online \
        [--smoke] [--decay 0.7] [--device cpu] [--obs-out PATH]

The port's counterpart of the JAX package's `examples/stream_online.py`,
with its flags and defaults and `--device` (the card unless told
otherwise). The chunks are drawn from seeded `torch.Generator`s, so
their numbers differ from the reference example's; the sharded ingest
over a device mesh is not ported.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import obs
from repro_torch.core import ar_covariance, hamming, sample_coefficients
from repro_torch.stream import StreamingDsmlService


def make_regime(gen, p, m, s, rho=0.5, device="cuda"):
    Sigma = ar_covariance(p, rho, device=device)
    eye = torch.eye(p, dtype=Sigma.dtype, device=device)
    chol = torch.linalg.cholesky(Sigma + 1e-9 * eye)
    B, support = sample_coefficients(gen, p, m, s, low=0.3, high=1.0,
                                     device=device)
    return chol, B, support


def draw_chunk(gen, chol, B, n, sigma=1.0):
    p, m = B.shape
    Z = torch.randn((m, n, p), generator=gen, device=B.device)
    Xs = Z @ chol.T
    ys = torch.einsum("tnp,pt->tn", Xs, B) + sigma * torch.randn(
        (m, n), generator=gen, device=B.device)
    return Xs, ys


def main(argv=None):
    """Run the stream demo; returns the headline metrics dict."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--m", type=int, default=8)
    ap.add_argument("--p", type=int, default=128)
    ap.add_argument("--s", type=int, default=8)
    ap.add_argument("--chunk-size", type=int, default=256)
    ap.add_argument("--chunks", type=int, default=16)
    ap.add_argument("--decay", type=float, default=0.7,
                    help="exponential forgetting per chunk (1.0 = none)")
    ap.add_argument("--shift-at", type=float, default=0.5,
                    help="fraction of the stream after which the true "
                         "support moves")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes for CI")
    ap.add_argument("--obs-out", default=None, metavar="PATH",
                    help="write the telemetry snapshot (and a "
                         ".trace.json Chrome trace next to it)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.smoke:
        args.m, args.p, args.s = 4, 48, 5
        args.chunk_size, args.chunks = 64, 8

    dev = torch.device(args.device)
    base = float(torch.sqrt(torch.log(torch.tensor(float(args.p)))
                            / args.chunk_size))
    svc = StreamingDsmlService(
        args.m, args.p, lam=4 * base, mu=base, Lam=1.0,
        decay=args.decay, refit_every=2 * args.chunk_size,
        lasso_iters=400, debias_iters=400, device=dev)

    gen = torch.Generator(device=dev).manual_seed(0)
    chol, B, support = make_regime(gen, args.p, args.m, args.s, device=dev)
    shift_chunk = int(args.shift_at * args.chunks)
    print(f"stream: m={args.m} tasks, p={args.p}, s={args.s}, "
          f"{args.chunks} chunks x {args.chunk_size} samples, "
          f"decay={args.decay}, shift at chunk {shift_chunk}, on {dev}")

    refits_during_stream = 0
    Xs = None
    for i in range(args.chunks):
        if i == shift_chunk:
            chol, B, support = make_regime(gen, args.p, args.m, args.s,
                                           device=dev)
            print(f"--- regime shift at chunk {i}: new support ---")
        Xs, ys = draw_chunk(gen, chol, B, args.chunk_size)
        t0 = time.perf_counter()
        info = svc.ingest(Xs, ys)
        dt = (time.perf_counter() - t0) * 1e3
        if info is not None:
            h = int(hamming(svc.state.support, support))
            err = float(torch.max(torch.abs(svc.state.beta_tilde - B.T)))
            refits_during_stream += 1
            print(f"[chunk {i:3d} | eff samples {svc.samples_seen:7.0f}] "
                  f"refit gen={int(info.generation)} "
                  f"|S|={int(info.support_size)} "
                  f"jaccard={float(info.jaccard):.2f} hamming={h} "
                  f"est_err={err:.3f} ({dt:.0f} ms incl. ingest)")

    svc.refit()
    h = int(hamming(svc.state.support, support))
    err = float(torch.max(torch.abs(svc.state.beta_tilde - B.T)))
    # serve one scoring round so the trace timeline shows the full
    # ingest -> refit -> predict lifecycle of the service
    svc.predict(Xs).cpu()
    print(f"final: generation {svc.generation}, support hamming vs current "
          f"regime = {h} (decay {'forgets' if args.decay < 1 else 'keeps'} "
          f"the old regime)")

    # telemetry-derived headlines (None-safe: REPRO_OBS=0 zeroes them)
    ing = obs.hist_stats("stream.ingest.ms")
    ref_ms = obs.hist_stats("stream.refit.ms")
    ing_rows = obs.counter_total("stream.ingest.rows")
    obs_rate = (ing_rows / (ing["sum"] * 1e-3)
                if ing and ing["sum"] > 0 else 0.0)
    if args.obs_out:
        from repro_torch.obs import export as obs_export
        obs_export.write_snapshot(
            args.obs_out,
            meta={"example": "stream_online", "smoke": bool(args.smoke),
                  "device": str(dev)})
        stem = args.obs_out[:-5] if args.obs_out.endswith(".json") \
            else args.obs_out
        obs_export.write_chrome_trace(stem + ".trace.json")
        print(f"wrote {args.obs_out} and {stem}.trace.json")
    return {
        "final_hamming": h,
        "final_est_err": err,
        "generations": int(svc.generation),
        "refits_during_stream": refits_during_stream,
        "samples_seen": float(svc.samples_seen),
        "obs_ingest_rows_per_s": obs_rate,
        "obs_refit_latency_ms": ref_ms["mean"] if ref_ms else 0.0,
        "obs_refits_recorded": ref_ms["count"] if ref_ms else 0,
    }


if __name__ == "__main__":
    main()
