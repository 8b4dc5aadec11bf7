"""Exporters for the telemetry registry: JSON snapshot, Prometheus
text exposition, and Chrome trace-event JSON (loadable in Perfetto or
chrome://tracing).

The port's copy of the JAX package's exporters. Pure stdlib, as
`registry.py`.
"""
from __future__ import annotations

import json
import os
import re
from typing import Optional

from . import registry as _registry

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def snapshot(reg: Optional[_registry.Registry] = None,
             meta: Optional[dict] = None) -> dict:
    """Registry state as a JSON-ready dict; `meta` (run metadata such
    as backend/git SHA) is attached under a `"meta"` key when given."""
    reg = reg or _registry.get_registry()
    snap = reg.snapshot()
    if meta is not None:
        snap["meta"] = dict(meta)
    return snap


def write_snapshot(path: str, reg: Optional[_registry.Registry] = None,
                   meta: Optional[dict] = None) -> dict:
    snap = snapshot(reg, meta=meta)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(snap, f, indent=2, sort_keys=True)
        f.write("\n")
    return snap


def load_snapshot(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _prom_name(name: str) -> str:
    return "repro_" + _NAME_RE.sub("_", name)


def _prom_labels(labels: dict) -> str:
    if not labels:
        return ""
    body = ",".join(f'{_NAME_RE.sub("_", str(k))}="{v}"'
                    for k, v in sorted(labels.items()))
    return "{" + body + "}"


def to_prometheus(snap: dict) -> str:
    """Prometheus text exposition (format 0.0.4) of a snapshot dict.
    Counters get a `_total` suffix; histograms expand to
    `_count`/`_sum`/`_min`/`_max` series."""
    lines = []
    for c in snap.get("counters", []):
        lines.append("%s_total%s %s" % (
            _prom_name(c["name"]), _prom_labels(c["labels"]), c["value"]))
    for g in snap.get("gauges", []):
        lines.append("%s%s %s" % (
            _prom_name(g["name"]), _prom_labels(g["labels"]), g["value"]))
    for h in snap.get("histograms", []):
        base = _prom_name(h["name"])
        lab = _prom_labels(h["labels"])
        for suffix in ("count", "sum", "min", "max"):
            lines.append("%s_%s%s %s" % (base, suffix, lab, h[suffix]))
        for suffix in ("p50", "p99"):   # windowed quantiles, when
            if suffix in h:             # samples were retained
                lines.append("%s_%s%s %s" % (base, suffix, lab, h[suffix]))
    return "\n".join(lines) + ("\n" if lines else "")


def chrome_trace(reg: Optional[_registry.Registry] = None) -> dict:
    """Buffered span events as a Chrome trace-event JSON object
    (`{"traceEvents": [...]}`, times in microseconds on the Unix clock,
    as `torch.profiler`'s exported traces have them) — drop the file on
    ui.perfetto.dev or chrome://tracing to see the timeline."""
    reg = reg or _registry.get_registry()
    events = []
    for ev in reg.trace_events():
        ts, dur = ev.pop("ts_ns"), ev.pop("dur_ns")
        events.append({**ev, "ts": ts / 1e3, "dur": dur / 1e3})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str,
                       reg: Optional[_registry.Registry] = None) -> dict:
    trace = chrome_trace(reg)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(trace, f)
        f.write("\n")
    return trace


def summarize(snap: dict, top: int = 20) -> str:
    """Human-oriented text summary of a snapshot (the `python -m
    repro_torch.obs` output): counters sorted by value, gauges, histogram
    headlines (count / mean / max)."""
    lines = []
    meta = snap.get("meta")
    if meta:
        lines.append("meta:")
        for k, v in sorted(meta.items()):
            if k == "telemetry":
                continue
            lines.append(f"  {k}: {v}")
    counters = sorted(snap.get("counters", []),
                      key=lambda c: -c["value"])[:top]
    if counters:
        lines.append("counters:")
        for c in counters:
            lab = _prom_labels(c["labels"])
            lines.append(f"  {c['name']}{lab} = {c['value']:g}")
    gauges = snap.get("gauges", [])[:top]
    if gauges:
        lines.append("gauges:")
        for g in gauges:
            lab = _prom_labels(g["labels"])
            lines.append(f"  {g['name']}{lab} = {g['value']:g}")
    hists = sorted(snap.get("histograms", []),
                   key=lambda h: -h["count"])[:top]
    if hists:
        lines.append("histograms:")
        for h in hists:
            lab = _prom_labels(h["labels"])
            tail = f" p99={h['p99']:.4g}" if "p99" in h else ""
            lines.append(
                f"  {h['name']}{lab}: n={h['count']} "
                f"mean={h['mean']:.4g} max={h['max']:.4g}{tail}")
    dropped = snap.get("dropped_trace_events", 0)
    if dropped:
        lines.append(f"dropped trace events: {dropped}")
    if not lines:
        lines.append("(empty snapshot)")
    return "\n".join(lines)
