"""Process-local telemetry core: counters, gauges, histograms, spans.

The port's copy of the JAX package's telemetry core: the same metric
names, labels, semantics and `REPRO_OBS` switch, so the two packages'
snapshots read alike. Pure stdlib: this module (and everything the
`repro_torch.obs` package imports at module scope) imports neither
torch nor anything else outside the standard library, so the snapshot
tooling runs anywhere. The optional `torch.profiler` bridge lives in
`repro_torch.obs.torchprof` behind a lazy import.

Semantics:

* **Counters** are monotonically increasing sums, **gauges** are
  last-write-wins values, **histograms** keep count/sum/min/max plus a
  bounded ring of the most recent `HIST_SAMPLE_CAP` raw observations
  (enough for rates, latency headlines, AND tail quantiles — the
  serving front's p50/p99 come from `hist_quantiles`, computed over
  the retained window, without bucket configuration), and **spans**
  time a `with` block on the monotonic clock, recording both a
  `<name>.ms` histogram observation and a Chrome trace event.
* Every metric takes free-form keyword **labels**; a (name, labels)
  pair is one series. Labels must be low-cardinality Python scalars
  (kernel names, route reasons, axis names — never tensor values).
* **`REPRO_OBS=0`** (or `false`/`off`) in the environment hard-disables
  the process-global registry at import time: every recording call
  becomes a single attribute-check no-op and spans return a shared
  null context manager.
* All mutation happens under one lock — safe for the threaded serving
  paths — and the trace-event buffer is capped (oldest runs drop
  nothing; new events past the cap are counted as dropped instead of
  growing without bound).

A span times the host: CUDA work is asynchronous, so a span around a
launch times its issue unless the block ends in a read of the result
(the stream service's refit span does; its ingest span does where the
guard reads the chunk's health).
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

# cap on buffered Chrome trace events; past it, events are dropped and
# counted (a long-running service must not grow a timeline unbounded)
MAX_TRACE_EVENTS = 65536

# per-series cap on retained raw observations for quantile estimation:
# a sliding window of the newest samples (a serving p99 should reflect
# recent traffic, not the cold-start tail from an hour ago), bounded so
# a long-running service's memory stays fixed per series
HIST_SAMPLE_CAP = 4096

MetricKey = Tuple[str, Tuple[Tuple[str, Any], ...]]


def _env_enabled() -> bool:
    return os.environ.get("REPRO_OBS", "1").strip().lower() not in (
        "0", "false", "off")


def _key(name: str, labels: dict) -> MetricKey:
    return (name, tuple(sorted(labels.items())))


def _quantile(sorted_vals: List[float], q: float) -> float:
    """Linear-interpolated quantile of an ascending-sorted list."""
    if not sorted_vals:
        raise ValueError("quantile of empty sample set")
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    pos = q * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


class _Hist:
    """count/sum/min/max summary plus a bounded ring of recent raw
    samples (newest `HIST_SAMPLE_CAP`) for windowed quantiles."""

    __slots__ = ("count", "total", "min", "max", "samples")

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.samples: deque = deque(maxlen=HIST_SAMPLE_CAP)

    def add(self, value: float) -> None:
        self.count += 1
        self.total += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value
        self.samples.append(value)


class _NullSpan:
    """Shared no-op context manager returned by disabled spans."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_reg", "_name", "_labels", "_t0")

    def __init__(self, reg: "Registry", name: str, labels: dict) -> None:
        self._reg = reg
        self._name = name
        self._labels = labels

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        dur_ns = time.perf_counter_ns() - self._t0
        self._reg._finish_span(self._name, self._labels, self._t0, dur_ns)
        return False


class Registry:
    """One process-local metric store. Library code uses the module
    globals below (`inc`/`set_gauge`/`observe`/`span`); constructing a
    private `Registry` directly is for tests and the disabled-mode
    overhead bench.

    Thread-sharing contract (`_SYNC_POLICY`, checked by repro_lint
    RL4xx): every mutable store is touched only under `_lock`;
    `_enabled` is set once at construction and read lock-free
    thereafter. RL404 additionally proves no blocking call ever runs
    while `_lock` is held, so a recording thread can never stall the
    serving worker on telemetry.
    """

    _SYNC_POLICY = {
        "*": "immutable-after-init",
        "_counters": "lock:_lock",
        "_gauges": "lock:_lock",
        "_hists": "lock:_lock",
        "_events": "lock:_lock",
        "_dropped_events": "lock:_lock",
    }

    def __init__(self, enabled: bool = True) -> None:
        self._enabled = bool(enabled)
        self._lock = threading.Lock()
        self._counters: Dict[MetricKey, float] = {}
        self._gauges: Dict[MetricKey, float] = {}
        self._hists: Dict[MetricKey, _Hist] = {}
        self._events: List[dict] = []
        self._dropped_events = 0

    @property
    def enabled(self) -> bool:
        return self._enabled

    # -- write side -------------------------------------------------------

    def inc(self, name: str, value: float = 1, **labels) -> None:
        if not self._enabled:
            return
        k = _key(name, labels)
        with self._lock:
            self._counters[k] = self._counters.get(k, 0) + value

    def set_gauge(self, name: str, value: float, **labels) -> None:
        if not self._enabled:
            return
        k = _key(name, labels)
        with self._lock:
            self._gauges[k] = value

    def observe(self, name: str, value: float, **labels) -> None:
        if not self._enabled:
            return
        k = _key(name, labels)
        with self._lock:
            h = self._hists.get(k)
            if h is None:
                h = self._hists[k] = _Hist()
            h.add(value)

    def span(self, name: str, **labels):
        """Context manager timing its block on the monotonic clock. On
        exit records a `<name>.ms` histogram observation and buffers a
        Chrome trace event ("X" phase, microsecond timestamps) carrying
        `labels` as the event args."""
        if not self._enabled:
            return _NULL_SPAN
        return _Span(self, name, labels)

    def event(self, name: str, ts_us: float, dur_us: float,
              **labels) -> None:
        """Buffer an explicit Chrome trace event (e.g. reconstructed
        from an external timing) without the histogram side effect."""
        if not self._enabled:
            return
        self._push_event(name, labels, ts_us, dur_us)

    def _finish_span(self, name: str, labels: dict, t0_ns: int,
                     dur_ns: int) -> None:
        self.observe(f"{name}.ms", dur_ns / 1e6, **labels)
        self._push_event(name, labels, t0_ns / 1e3, dur_ns / 1e3)

    def _push_event(self, name: str, labels: dict, ts_us: float,
                    dur_us: float) -> None:
        ev = {"name": name, "ph": "X", "cat": "repro",
              "ts": ts_us, "dur": dur_us,
              "pid": os.getpid(), "tid": threading.get_ident(),
              "args": dict(labels)}
        with self._lock:
            if len(self._events) >= MAX_TRACE_EVENTS:
                self._dropped_events += 1
            else:
                self._events.append(ev)

    # -- read side --------------------------------------------------------

    def counter_total(self, name: str, **match) -> float:
        """Sum of every counter series named `name` whose labels are a
        superset of `match` (no kwargs = all series of that name)."""
        want = set(match.items())
        with self._lock:
            return sum(v for (n, lab), v in self._counters.items()
                       if n == name and want.issubset(lab))

    def hist_stats(self, name: str, **match) -> Optional[dict]:
        """Merged count/sum/min/max/mean over every histogram series
        named `name` whose labels contain `match`; None when no series
        matches."""
        want = set(match.items())
        merged = _Hist()
        with self._lock:
            for (n, lab), h in self._hists.items():
                if n == name and want.issubset(lab):
                    merged.count += h.count
                    merged.total += h.total
                    merged.min = min(merged.min, h.min)
                    merged.max = max(merged.max, h.max)
        if merged.count == 0:
            return None
        return {"count": merged.count, "sum": merged.total,
                "min": merged.min, "max": merged.max,
                "mean": merged.total / merged.count}

    def hist_quantiles(self, name: str, qs=(0.5, 0.99),
                       **match) -> Optional[dict]:
        """Windowed quantiles over the retained samples of every
        histogram series named `name` whose labels contain `match`.
        Returns {q: value} (linear interpolation between order
        statistics) or None when no samples are retained. The window is
        the newest `HIST_SAMPLE_CAP` observations per series — a
        serving tail estimate, not an all-time one."""
        want = set(match.items())
        with self._lock:
            pooled: List[float] = []
            for (n, lab), h in self._hists.items():
                if n == name and want.issubset(lab):
                    pooled.extend(h.samples)
        if not pooled:
            return None
        pooled.sort()
        return {q: _quantile(pooled, q) for q in qs}

    def trace_events(self) -> List[dict]:
        with self._lock:
            return [dict(ev) for ev in self._events]

    def snapshot(self) -> dict:
        """JSON-ready state dump (no trace events — those export via
        `repro_torch.obs.export.chrome_trace`)."""
        with self._lock:
            counters = [{"name": n, "labels": dict(lab), "value": v}
                        for (n, lab), v in sorted(self._counters.items())]
            gauges = [{"name": n, "labels": dict(lab), "value": v}
                      for (n, lab), v in sorted(self._gauges.items())]
            hists = []
            for (n, lab), h in sorted(self._hists.items()):
                if not h.count:
                    continue
                entry = {"name": n, "labels": dict(lab), "count": h.count,
                         "sum": h.total, "min": h.min, "max": h.max,
                         "mean": h.total / h.count}
                if h.samples:
                    srt = sorted(h.samples)
                    entry["p50"] = _quantile(srt, 0.5)
                    entry["p99"] = _quantile(srt, 0.99)
                hists.append(entry)
            return {"enabled": self._enabled, "counters": counters,
                    "gauges": gauges, "histograms": hists,
                    "dropped_trace_events": self._dropped_events}

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self._events.clear()
            self._dropped_events = 0


# -- the process-global registry ------------------------------------------

_REGISTRY = Registry(enabled=_env_enabled())


def get_registry() -> Registry:
    return _REGISTRY


def enabled() -> bool:
    """True unless REPRO_OBS disabled telemetry at import time. Hot
    call sites with per-record setup cost (string formatting, byte
    models) should check this first and skip the work entirely."""
    return _REGISTRY.enabled


def inc(name: str, value: float = 1, **labels) -> None:
    _REGISTRY.inc(name, value, **labels)


def set_gauge(name: str, value: float, **labels) -> None:
    _REGISTRY.set_gauge(name, value, **labels)


def observe(name: str, value: float, **labels) -> None:
    _REGISTRY.observe(name, value, **labels)


def span(name: str, **labels):
    return _REGISTRY.span(name, **labels)


def counter_total(name: str, **match) -> float:
    return _REGISTRY.counter_total(name, **match)


def hist_stats(name: str, **match) -> Optional[dict]:
    return _REGISTRY.hist_stats(name, **match)


def hist_quantiles(name: str, qs=(0.5, 0.99), **match) -> Optional[dict]:
    return _REGISTRY.hist_quantiles(name, qs, **match)


def reset() -> None:
    _REGISTRY.reset()
