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
* `kernel_launches`: the kernels one call launches on the card, with
  their grid, block and shared memory, from `torch.profiler`'s trace;
  `device_kernel_names`: the names of what one call runs there, from
  the profiler's events.
* `sdpa_yardstick`: PyTorch's `scaled_dot_product_attention` on the
  flash kernel's operands, the library call its times stand beside (never
  on the port's path).
"""
from __future__ import annotations

import json
import tempfile
from pathlib import Path

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


def kernel_launches(fn) -> list[dict]:
    """The kernels one call of `fn` launches on the card and their launch
    shapes, from `torch.profiler`'s trace: name, grid, block and shared
    memory (bytes) each."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="kernel_trace_") as tmp:
        trace = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    return [{"name": e["name"], "grid": e["args"].get("grid"),
             "block": e["args"].get("block"),
             "smem": e["args"].get("shared memory")}
            for e in events if e.get("cat") == "kernel"]


def device_kernel_names(fn) -> list[str]:
    """The names of what one call of `fn` runs on the card (kernels,
    memsets), from `torch.profiler`'s events. Not from `kernel_launches`:
    the exported trace has lacked SDPA's float32 kernel
    (`fmha_cutlassF_f32_*`) after a long run of other work on the card."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.name[:120] for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA})


def sdpa_yardstick(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True, grad: bool = False):
    """SDPA on q (B, S, N, H), k and v (B, T, K, H) as one call: `(fn,
    note)`. With `grad` the operands require a gradient, so that SDPA's
    forward also writes its logsumexp (the training forward's yardstick).
    GQA goes through `enable_gqa`, unless that sends the call to SDPA's
    math path (products and a separate softmax kernel); then k
    and v are expanded to N heads here, outside the timed call, and the
    note says so."""
    def ready(t):
        t = t.transpose(1, 2)
        return t.detach().requires_grad_() if grad else t

    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = ready(q), ready(k), ready(v)

    def gqa():
        return sdpa(qt, kt, vt, is_causal=causal, enable_gqa=True)

    group = q.shape[2] // k.shape[2]
    if group == 1 or not any("softmax" in n.lower()
                             for n in device_kernel_names(gqa)):
        return gqa, "enable_gqa"
    ke, ve = (ready(t.repeat_interleave(group, dim=2)) for t in (k, v))
    return (lambda: sdpa(qt, ke, ve, is_causal=causal),
            f"k and v expanded to {q.shape[2]} heads outside the call "
            "(enable_gqa ran the math path)")
