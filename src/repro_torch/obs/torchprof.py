"""Optional bridge to `torch.profiler`, the port's counterpart of the JAX
package's `jax.profiler` bridge.

Kept out of `repro_torch.obs.__init__` so that the telemetry core
imports nothing outside the standard library. Import this module when
you want the host's and the card's kernels on a timeline beside the obs
spans:

    from repro_torch.obs import torchprof
    with torchprof.profiler_trace("trace-dir") as prof:
        run_workload()
    # trace-dir/trace.<pid>.json opens in Perfetto or chrome://tracing

`span_trace` puts the card's work beside the obs spans instead: it
profiles the card over a block and charges each kernel, through its
correlation id, to the span that held its launch, and each idle gap of
the card to the span that made it (`charge`):

    with torchprof.span_trace() as box:
        dsml_fit(...)
    box["charge"].spans["engine.debias_solve"]   # [self, inclusive] s
"""
from __future__ import annotations

import bisect
import contextlib
import os
import threading
import time
from typing import NamedTuple

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
# runtime calls of the caching allocator: a gap that the host spends in
# one is the allocator refilling, not the program's pace
ALLOC_CALLS = ("cudaMalloc", "cudaFree")


@contextlib.contextmanager
def profiler_trace(log_dir: str, **kwargs):
    """Profile the block with `torch.profiler` (the CPU, and CUDA where a
    card is present) and write its Chrome trace to
    `log_dir/trace.<pid>.json` on exit. Yields the profiler, whose
    `key_averages()` gives time by kernel; `kwargs` go to
    `torch.profiler.profile`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import registry as _registry
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    _registry.inc("obs.torchprof.trace")
    with profile(activities=activities, **kwargs) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace.{os.getpid()}.json"))


class SpanCharge(NamedTuple):
    """A traced block's device work and idle, charged to the obs spans.

    `spans`: span name (or "outside") -> [self, inclusive] device
    seconds of the work launched inside it. `idle`: (kind, span name or
    "outside") -> idle seconds of the card, where kind is
    - "queued": the work that ended the gap was launched before the gap
      began, so the card idled with work queued (launch latency, the
      stream's bubbles); charged to the span that launched that work;
    - "host": the work was launched inside the gap, so the card waited
      for the host; charged to the innermost span open at the gap's
      middle;
    - "alloc": the host spent the gap's middle in the caching
      allocator's `cudaMalloc`/`cudaFree`; charged like "host".
    """
    window_s: float
    busy_s: float
    device_s: float          # the device intervals' lengths, summed
    launched_s: float        # of which matched to their launch
    spans: dict
    idle: dict


def _is_device(ev, cuda) -> bool:
    if ev.device_type() != cuda:
        return False
    kind = getattr(ev, "activity_type", None)
    return kind is None or str(kind()) in DEVICE_KINDS


class _Timeline:
    """The spans, cut thread by thread into pieces that do not overlap,
    each with the spans open over it (outermost first): spans nest on a
    thread as `with` blocks do."""

    def __init__(self, spans):
        self.names, self.length, self.pieces = [], [], {}
        per_thread: dict = {}
        for ev in spans:
            a, d = ev["ts_ns"], ev["dur_ns"]
            if d <= 0:
                continue
            self.names.append(ev["name"])
            self.length.append(d)
            per_thread.setdefault(ev["tid"], []).append(
                (a, a + d, len(self.names) - 1))
        for tid, held in per_thread.items():
            # at a tie a span closes before the next one opens, and an
            # outer span opens before the inner one
            points = sorted([(a, 1, -b, i) for a, b, i in held]
                            + [(b, 0, 0, i) for a, b, i in held])
            starts, pieces, stack, last = [], [], [], None
            for t, opens, _, i in points:
                if stack and t > last:
                    starts.append(last)
                    pieces.append((t, tuple(stack)))
                if opens:
                    stack.append(i)
                else:
                    stack.remove(i)
                last = t
            self.pieces[tid] = (starts, pieces)

    def stack(self, t: int, tid) -> tuple:
        """The spans open on thread `tid` at time t, outermost first."""
        starts, pieces = self.pieces.get(tid, ((), ()))
        i = bisect.bisect_right(starts, t) - 1
        return pieces[i][1] if i >= 0 and t < pieces[i][0] else ()

    def innermost(self, t: int) -> str:
        """The shortest span open at time t on any thread, or
        "outside"."""
        inner = [held[-1] for held in (self.stack(t, tid)
                                       for tid in self.pieces) if held]
        return self.names[min(inner, key=lambda i: self.length[i])] \
            if inner else "outside"


def _call_at(t: int, starts: list, calls: list):
    """The name of a runtime call that holds time t, or None."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 8, -1), -1):
        a, b, name = calls[j]
        if a <= t < b:
            return name
    return None


def charge(events, spans, w0: int, w1: int, threads=None) -> SpanCharge:
    """Charge the profiler's events in the window [w0, w1) (Unix ns) to
    the obs spans (`Registry.trace_events()`). `threads` maps the ids the
    profiler gives a runtime call's thread to OS thread ids, the spans'
    `tid` (`thread_ids`)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    timeline = _Timeline(spans)
    threads = threads or {}
    dev, calls, launches = [], [], {}
    for ev in events:
        a = ev.start_ns()
        b = a + ev.duration_ns()
        if _is_device(ev, cuda):
            if b > w0 and a < w1:
                dev.append((max(a, w0), min(b, w1), ev.correlation_id()))
            continue
        if ev.correlation_id():
            tid = ev.device_resource_id()
            launches[ev.correlation_id()] = (a, threads.get(tid, tid))
        calls.append((a, b, ev.name()))
    calls.sort()
    starts = [a for a, _, _ in calls]

    def launcher(corr):
        call = launches.get(corr)
        return (call[0], timeline.stack(*call)) if call else (None, ())

    by_span: dict = {}
    device = launched = 0
    for a, b, corr in dev:
        t, held = launcher(corr)
        device += b - a
        launched += (b - a) if t is not None else 0
        inner = timeline.names[held[-1]] if held else "outside"
        for name in {timeline.names[i] for i in held} or {inner}:
            entry = by_span.setdefault(name, [0.0, 0.0])
            entry[0] += (b - a) * 1e-9 if name == inner else 0.0
            entry[1] += (b - a) * 1e-9
    dev.sort()
    busy, idle, gaps, end = 0, {}, [], w0
    for a, b, corr in dev:
        if a > end:
            gaps.append((end, a, corr))
        if b > end:
            busy += b - max(a, end)
            end = b
    if w1 > end:
        gaps.append((end, w1, None))
    for a, b, corr in gaps:
        mid = (a + b) // 2
        t, held = launcher(corr)
        call = _call_at(mid, starts, calls) or ""
        if call.startswith(ALLOC_CALLS):
            key = ("alloc", timeline.innermost(mid))
        elif t is not None and t < a:
            key = ("queued",
                   timeline.names[held[-1]] if held else "outside")
        else:
            key = ("host", timeline.innermost(mid))
        idle[key] = idle.get(key, 0.0) + (b - a) * 1e-9
    return SpanCharge((w1 - w0) * 1e-9, busy * 1e-9, device * 1e-9,
                      launched * 1e-9, by_span, idle)


def thread_ids() -> dict:
    """The live threads' ids as the profiler may give them (the thread's
    `pthread_t`, whole or cut to 32 bits, signed or not) -> OS thread
    ids. A trace of the card alone names a runtime call's thread by its
    `pthread_t`."""
    ids = {}
    for th in threading.enumerate():
        if th.ident is None or th.native_id is None:
            continue
        low = th.ident & 0xFFFFFFFF
        for key in (th.ident, low, low - (1 << 32) if low >> 31 else low):
            ids[key] = th.native_id
    return ids


@contextlib.contextmanager
def span_trace():
    """Profile the card over the block (its kernels, copies and runtime
    calls; the CPU's where no card is present) and charge them to the
    obs spans recorded in it: the yielded dict gets the `SpanCharge`
    under "charge" on exit. Synchronise before and inside the block if
    its work is to fall in the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import registry as _registry
    activities = [ProfilerActivity.CUDA] if torch.cuda.is_available() \
        else [ProfilerActivity.CPU]
    box: dict = {"charge": None}
    threads = thread_ids()
    with profile(activities=activities) as prof:
        w0 = time.time_ns()
        yield box
        w1 = time.time_ns()
    threads.update(thread_ids())
    spans = [ev for ev in _registry.get_registry().trace_events()
             if ev["ts_ns"] < w1 and ev["ts_ns"] + ev["dur_ns"] > w0]
    box["charge"] = charge(prof.profiler.kineto_results.events(), spans,
                           w0, w1, threads)
