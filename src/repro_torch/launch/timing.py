"""Times of a call on the card, for `chip_smoke.py` and the comparison
tool (`launch/compare_sgemm.py`).

* `time_ms`: CUDA events around `reps` calls issued back to back from
  Python: the device's time where it exceeds the host's issue time, else
  the host's.
* `time_ms_cold`: the same with the 50 MB L2 flushed before each call.
* `graph_ms`: the device time alone. The `reps` calls are captured in one
  CUDA graph and the graph is replayed between two CUDA events, so no
  host issue is timed. The kernels' C entries launch on PyTorch's current
  stream, which is the capture stream while a graph is captured.
"""
from __future__ import annotations

import torch


def time_ms(fn, reps: int = 20, warm: int = 3) -> float:
    """Mean device time of `fn` over `reps` calls, by CUDA events."""
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_ms_cold(fn, reps: int = 20, warm: int = 3) -> float:
    """Mean device time of `fn` with the 50 MB L2 cache flushed before
    each call (a 64 MB buffer is overwritten), by one pair of CUDA events
    per call."""
    flush = torch.empty(16 * 2**20, device="cuda")
    for _ in range(warm):
        fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def graph_ms(fn, reps: int = 20, replays: int = 5) -> tuple[float, str]:
    """Device time of one call of `fn`, with no host issue in it: `reps`
    calls captured in one CUDA graph, which is replayed `replays` times
    between two CUDA events. Returns (ms per call, "graph"). Where the
    calls cannot be captured, the device time of their kernels from
    `torch.profiler` instead, and the reason beside "profiler"."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                  # warm-up off the capture
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            for _ in range(reps):
                fn()
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        end.synchronize()
        del graph
        return start.elapsed_time(end) / (reps * replays), "graph"
    except RuntimeError as exc:
        reason = str(exc).splitlines()[0]
    torch.cuda.synchronize()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    total_us = sum(getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0))
                   for e in events)
    return total_us / 1e3 / reps, f"profiler (capture failed: {reason})"
