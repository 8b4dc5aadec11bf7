"""The traced run: `torch.profiler` over the window, reduced to device
time by kernel, the device's busy time and its longest idle gaps.

Only the card's activity is traced (kernels, copies, fills, and the CUDA
runtime calls that issue them), which costs the host far less than
recording every operator: a traced window runs close to an untraced
one. The harness marks its own steps on the host clock (`mark`, in
Unix nanoseconds, the profiler's clock); the window is the `window`
step, and an idle gap is named by the step and the runtime call that
held its middle. The busy time is the union of the device intervals
inside the window.
"""
from __future__ import annotations

import contextlib
import re
import time
from typing import NamedTuple

import torch

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
# the steps of the trace that is on, None while none is
_steps: list | None = None


@contextlib.contextmanager
def mark(name: str):
    """A harness step, recorded while a trace is on."""
    spans = _steps
    if spans is None:
        yield
        return
    t0 = time.time_ns()
    try:
        yield
    finally:
        spans.append((t0, time.time_ns(), name))


class DeviceTrace(NamedTuple):
    window_s: float
    busy_s: float
    kernels: dict            # name -> device seconds in the window
    gaps: list               # [(label, seconds)], longest first

    def kernel_s(self, *parts: str) -> float:
        """Device seconds of the kernels whose name holds any of `parts`."""
        return sum(s for name, s in self.kernels.items()
                   if any(p in name for p in parts))

    def top_ops(self, k: int = 10) -> list:
        return sorted(self.kernels.items(), key=lambda kv: -kv[1])[:k]


def short(name: str) -> str:
    """A kernel's name without its return type, namespace and arguments."""
    name = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    depth = 0
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0:
            return name[:i][:160]
    return name[:160]


def _is_device(ev) -> bool:
    if ev.device_type() != torch.autograd.DeviceType.CUDA:
        return False
    kind = getattr(ev, "activity_type", None)
    return kind is None or str(kind()) in DEVICE_KINDS


def reduce(events, marks: list) -> DeviceTrace:
    """Reduce the profiler's raw events and the harness's steps."""
    window = [m for m in marks if m[2] == "window"]
    if not window:
        raise RuntimeError("the trace holds no window step")
    w0, w1, _ = window[0]
    steps = [m for m in marks if m[2] != "window"]
    dev, host = [], []
    for ev in events:
        a = ev.start_ns()
        b = a + ev.duration_ns()
        if b <= w0 or a >= w1:
            continue
        if _is_device(ev):
            dev.append((max(a, w0), min(b, w1), short(ev.name())))
        else:
            host.append((a, b, ev.name()))
    kernels: dict = {}
    for a, b, name in dev:
        kernels[name] = kernels.get(name, 0.0) + (b - a) * 1e-9
    dev.sort()
    busy, idle, end = 0, [], w0
    for a, b, _ in dev:
        if a > end:
            idle.append((a - end, end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if w1 > end:
        idle.append((w1 - end, end, w1))
    idle.sort(reverse=True)
    gaps = [(_label(a, b, steps, host), d * 1e-9) for d, a, b in idle[:10]]
    return DeviceTrace((w1 - w0) * 1e-9, busy * 1e-9, kernels, gaps)


def _covering(t: int, spans: list):
    """The innermost (shortest) span of `spans` that holds time t."""
    best = None
    for a, b, name in spans:
        if a <= t < b and (best is None or b - a < best[1] - best[0]):
            best = (a, b, name)
    return best


def _label(a: int, b: int, steps: list, host: list) -> str:
    """What the host was doing in the gap [a, b): the harness step and
    the runtime call that held its middle."""
    mid = (a + b) // 2
    step = _covering(mid, steps)
    call = _covering(mid, host)
    return f"{step[2] if step else 'between steps'}: " \
           f"{call[2] if call else 'host'}"


@contextlib.contextmanager
def traced(enabled: bool):
    """Profile the card over the block when `enabled`; the yielded dict
    gets the reduced trace under "trace" on exit."""
    global _steps
    box: dict = {"trace": None}
    if not enabled:
        yield box
        return
    from torch.profiler import ProfilerActivity, profile
    marks: list = []
    _steps = marks
    activities = [ProfilerActivity.CUDA] if torch.cuda.is_available() \
        else [ProfilerActivity.CPU]
    try:
        with profile(activities=activities) as prof:
            yield box
    finally:
        _steps = None
    box["trace"] = reduce(prof.profiler.kineto_results.events(), marks)


def breakdown(trace: DeviceTrace) -> dict:
    return {"device_ops": [[n, s] for n, s in trace.top_ops()],
            "idle_gaps": [[n, s] for n, s in trace.gaps]}
