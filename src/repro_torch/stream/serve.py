"""Serving front for the streaming DSML service: atomic model
generations and an async microbatched predict path.

The port's counterpart of the JAX package's `repro/stream/serve.py`.
Two pieces, separable on purpose:

* **`ModelGeneration`** — the immutable unit of model publication. A
  snapshot of exactly the fields predict needs (`beta_tilde`, the
  support mask, and the generation stamped as a PYTHON int at publish
  time), built from ONE read of the service's state. The service
  publishes a new snapshot only when the model can actually have
  changed (refit adoption, checkpoint restore, construction) and
  installs it with a single reference assignment — atomic under the
  GIL — so a reader never observes a torn `(beta_tilde, generation)`
  pair no matter how refits interleave. The tensors it holds are never
  written in place, so a held snapshot stays what it was.

* **`ServingFront`** — the admission/microbatching layer. Callers
  `submit()` single rows (or small row blocks) of the SHARED-design
  predict contract and get a future; a daemon worker drains the queue
  into a microbatch (up to `max_batch` rows, waiting at most
  `max_delay_ms` for stragglers), pads it to a power-of-two row bucket
  in a host buffer (pinned where the service is on a card, so the copy
  to the device is one asynchronous transfer per microbatch), and
  issues ONE `_predict_shared` product against ONE `ModelGeneration`
  for the whole batch. Every result carries the generation that scored
  it, so a caller can prove batch-mates were never mixed across a
  refit.

The worker issues on the default CUDA stream, the queue the service's
ingest and refit kernels run on, so a microbatch that arrives during a
refit waits behind the refit's queued kernels (the device has one
queue here, as the JAX package's dispatch has).

Telemetry (worker-thread side): `serve.queue_depth` gauge at each
drain, `serve.batch_fill` and `serve.batch_rows` histograms, a
`serve.batch` span around the product, `serve.request_ms` per-request
enqueue-to-result latency (p50/p99 via `obs.hist_quantiles`), and
`serve.requests` / `serve.rows` / `serve.batches` / `serve.errors`
counters.
"""
from __future__ import annotations

import queue
import threading
import time
import traceback
from concurrent.futures import Future
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch import obs

# microbatches are padded up to a power-of-two row count so the product
# sees a small closed set of shapes, with a floor so tiny batches don't
# each mint a shape
MIN_BUCKET_ROWS = 8


class ModelGeneration(NamedTuple):
    """Immutable published model: everything predict reads, captured
    from one state snapshot. `generation` is a host int (stamped once,
    at publish) so serving-side bookkeeping never syncs on the device
    stream."""
    beta_tilde: torch.Tensor     # (m, p) thresholded debiased estimates
    support: torch.Tensor        # (p,) shared support mask
    generation: int


class ServeResult(NamedTuple):
    """Scores for one request plus the generation that produced them —
    `scores[t, i]` is task t's score for the request's row i."""
    scores: np.ndarray           # (m, rows)
    generation: int


def bucket_rows(rows: int, min_bucket: int = MIN_BUCKET_ROWS) -> int:
    """Smallest power-of-two >= rows (floored at `min_bucket`) — the
    padded row count of a microbatch."""
    if rows < 1:
        raise ValueError(f"microbatch needs >= 1 row, got {rows}")
    b = min_bucket
    while b < rows:
        b *= 2
    return b


class _Request(NamedTuple):
    X: np.ndarray                # (rows, p) normalized shared design
    future: Future
    t_enqueue: float             # perf_counter seconds at admission


class ServingFront:
    """Async microbatched predict over a `StreamingDsmlService`.

        front = ServingFront(svc, max_batch=64, max_delay_ms=2.0)
        front.start()
        fut = front.submit(x_row)          # (p,) or (rows, p)
        res = fut.result()                 # ServeResult
        front.stop()

    The worker never touches the service's mutable fields — it reads
    one published `ModelGeneration` per microbatch via
    `svc.serving()`, so ingest/refit on other threads proceed
    untouched and every result in a batch is scored by the same
    generation. `predict(x)` is the synchronous convenience wrapper
    (submit + wait). The front is also a context manager.

    Lifecycle contract (`_SYNC_POLICY`, checked by repro_lint RL4xx):
    `start()`/`stop()` are driver-thread calls. Each worker owns its
    OWN stop event (passed at spawn, never read back through `self`),
    so a timed-out `stop()` followed by `start()` can never hand a
    half-stopped worker a cleared flag. `stop()` returns False and
    touches nothing when the worker outlives the join timeout — the
    live worker still owns the queue, the carry slot, and every
    admitted future; `_fail_pending` runs only after thread death
    proves exclusive ownership transferred back.
    """

    _SYNC_POLICY = {
        "*": "immutable-after-init",
        "_worker": "atomic-publish:start,stop",
        "_stop": "atomic-publish:start",
        "_carry": "worker-only:_run,_fail_pending",
    }

    def __init__(self, service, *, max_batch: int = 64,
                 max_delay_ms: float = 2.0,
                 min_bucket: int = MIN_BUCKET_ROWS,
                 poll_s: float = 0.1):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.service = service
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_ms) / 1e3
        self.min_bucket = int(min_bucket)
        self.poll_s = float(poll_s)  # idle wake cadence of the worker
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._carry: Optional[_Request] = None  # overflow from last drain
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "ServingFront":
        w = self._worker
        if w is not None:
            if w.is_alive() and not self._stop.is_set():
                return self
            # a previous stop() timed out (or the worker crashed): wait
            # the old worker out for real before spawning a new one, so
            # two workers never race on the same queue
            w.join()
            self._fail_pending()
        stop = threading.Event()
        worker = threading.Thread(
            target=self._run, args=(stop,), name="repro-serving-front",
            daemon=True)
        self._stop = stop
        self._worker = worker
        worker.start()
        return self

    def stop(self, timeout: float = 5.0) -> bool:
        """Drain-and-stop: already-admitted requests still resolve (the
        worker sweeps the queue before exiting). Returns True once the
        worker is confirmed dead; False when it outlived `timeout`, in
        which case NOTHING is reclaimed — the worker still owns the
        queue and every pending future, and a later stop()/start()
        waits it out."""
        w = self._worker
        if w is None:
            return True
        self._stop.set()
        self._q.put(None)            # wake the worker out of its drain
        w.join(timeout)
        if w.is_alive():
            return False
        self._worker = None
        self._fail_pending()
        return True

    def _fail_pending(self) -> None:
        """Fail anything admitted after the dead worker's final sweep.
        Callers must have proven the worker dead (join() returned and
        is_alive() is False) — thread death is the happens-before edge
        that makes this single-owner code."""
        leftovers: List[Optional[_Request]] = []
        if self._carry is not None:
            leftovers.append(self._carry)
            self._carry = None
        while True:
            try:
                leftovers.append(self._q.get_nowait())
            except queue.Empty:
                break
        for req in leftovers:
            if req is not None and not req.future.done():
                req.future.set_exception(
                    RuntimeError("serving front stopped"))

    def __enter__(self) -> "ServingFront":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # -- admission --------------------------------------------------------

    def submit(self, x) -> Future:
        """Admit one shared-design request: x (p,) is one row, (rows, p)
        a small block. Returns a `Future[ServeResult]`."""
        w = self._worker
        if w is None or not w.is_alive():
            raise RuntimeError("serving front is not running "
                               "(call start() or use as a context manager)")
        p = self.service.p
        X = np.asarray(x)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        if X.ndim != 2 or X.shape[-1] != p:
            raise ValueError(f"request must be (p,) or (rows, p) with "
                             f"p={p}; got shape {np.asarray(x).shape}")
        if X.shape[0] > self.max_batch:
            raise ValueError(f"request rows {X.shape[0]} exceed "
                             f"max_batch={self.max_batch}; split it")
        fut: Future = Future()
        self._q.put(_Request(X, fut, time.perf_counter()))
        return fut

    def predict(self, x, timeout: Optional[float] = None) -> ServeResult:
        """Synchronous submit + wait."""
        return self.submit(x).result(timeout)

    # -- the worker -------------------------------------------------------

    def _drain(self) -> List[_Request]:
        """Block for the first request, then gather stragglers until the
        batch is full or `max_delay_ms` has passed since admission of
        the first — the classic admission-latency/batch-fill tradeoff
        knob."""
        if self._carry is not None:
            first, self._carry = self._carry, None
        else:
            try:
                first = self._q.get(timeout=self.poll_s)
            except queue.Empty:
                return []
            if first is None:
                return []
        obs.set_gauge("serve.queue_depth", self._q.qsize())
        batch = [first]
        rows = first.X.shape[0]
        deadline = time.perf_counter() + self.max_delay_s
        while rows < self.max_batch:
            wait = deadline - time.perf_counter()
            if wait <= 0:
                break
            try:
                req = self._q.get(timeout=wait)
            except queue.Empty:
                break
            if req is None:
                break
            if rows + req.X.shape[0] > self.max_batch:
                # does not fit: carried (in order) to lead the next batch
                self._carry = req
                break
            batch.append(req)
            rows += req.X.shape[0]
        return batch

    def _process(self, batch: Sequence[_Request]) -> None:
        """Score one microbatch with ONE product against ONE published
        generation; deterministic and thread-free so tests can call it
        directly on hand-built requests."""
        from repro_torch.stream.service import _predict_shared
        rows = sum(req.X.shape[0] for req in batch)
        snap: ModelGeneration = self.service.serving()
        padded = bucket_rows(rows, self.min_bucket)
        dev = snap.beta_tilde.device
        host = torch.zeros((padded, batch[0].X.shape[1]),
                           dtype=snap.beta_tilde.dtype,
                           pin_memory=dev.type == "cuda")
        X = host.numpy()
        off = 0
        for req in batch:
            X[off:off + req.X.shape[0]] = req.X
            off += req.X.shape[0]
        with obs.span("serve.batch", rows=rows, padded=padded):
            X_dev = host.to(dev, non_blocking=True)
            scores = _predict_shared(snap.beta_tilde, X_dev).cpu().numpy()
        t_done = time.perf_counter()
        off = 0
        for req in batch:
            n_i = req.X.shape[0]
            req.future.set_result(ServeResult(
                scores=scores[:, off:off + n_i],
                generation=snap.generation))
            off += n_i
            obs.observe("serve.request_ms",
                        (t_done - req.t_enqueue) * 1e3)
        obs.inc("serve.batches")
        obs.inc("serve.requests", len(batch))
        obs.inc("serve.rows", rows)
        obs.observe("serve.batch_rows", rows)
        obs.observe("serve.batch_fill", rows / self.max_batch)

    def _drain_remaining(self) -> List[_Request]:
        """Non-blocking gather for the worker's final sweep: carry slot
        first, then whatever is already queued, skipping stop
        sentinels, respecting max_batch (overflow re-parks in the
        carry for the next sweep iteration)."""
        batch: List[_Request] = []
        rows = 0
        if self._carry is not None:
            first, self._carry = self._carry, None
            batch.append(first)
            rows = first.X.shape[0]
        while rows < self.max_batch:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if req is None:
                continue
            if rows + req.X.shape[0] > self.max_batch:
                self._carry = req
                break
            batch.append(req)
            rows += req.X.shape[0]
        return batch

    def _process_safe(self, batch: Sequence[_Request]) -> None:
        try:
            self._process(batch)
        except Exception as e:  # noqa: BLE001 - recorded + propagated
            # a poisoned batch must not kill the worker: the error
            # goes to the batch's callers (their futures, with the
            # worker's traceback as a note) and to telemetry, and the
            # loop keeps serving
            obs.inc("serve.errors", kind=type(e).__name__)
            e.add_note("serving front worker:\n"
                       + "".join(traceback.format_tb(e.__traceback__)))
            for req in batch:
                if not req.future.done():
                    req.future.set_exception(e)

    def _run(self, stop: threading.Event) -> None:
        # `stop` is THIS worker's own event, bound at spawn: the worker
        # never reads self._stop, so a later start() publishing a fresh
        # event cannot un-stop a half-stopped worker
        while not stop.is_set():
            batch = self._drain()
            if batch:
                self._process_safe(batch)
        # final sweep: everything admitted before the stop still
        # resolves (drain-and-stop), batch by batch
        while True:
            batch = self._drain_remaining()
            if not batch:
                break
            self._process_safe(batch)

    # -- introspection ----------------------------------------------------

    def latency_quantiles(self, qs=(0.5, 0.99)) -> Optional[dict]:
        """Windowed request-latency quantiles (ms) from telemetry, None
        before any request resolved (or with obs disabled)."""
        return obs.hist_quantiles("serve.request_ms", qs)
