"""The port's telemetry (`repro_torch.obs`), on the CPU.

Case for case the registry and exporter cases of the reference's
`tests/test_obs.py` (counters, gauges, histograms, spans, thread
safety, the `REPRO_OBS=0` switch, Prometheus text, Chrome traces, the
snapshot round trip, the CLI) and its stream-timeline case, on the
port's copy and its `stream_online` launcher; the same recording
sequence gives both packages' registries the same snapshot, exposition
and summary; and `torchprof.profiler_trace` writes a Chrome trace.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import pytest
import torch

from repro import obs as jobs
from repro.obs import export as jobs_export
from repro_torch import obs
from repro_torch.obs import export as obs_export
from repro_torch.obs.registry import MAX_TRACE_EVENTS, Registry

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def fresh_registry():
    """Every test starts (and leaves) with an empty global registry."""
    obs.reset()
    yield
    obs.reset()


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep \
        + env.get("PYTHONPATH", "")
    return env


# --- registry units -------------------------------------------------------

def test_counters_labels_and_superset_totals():
    obs.inc("t.calls", kernel="k1", outcome="a")
    obs.inc("t.calls", 2, kernel="k2", outcome="a")
    obs.inc("t.calls", kernel="k1", outcome="b")
    assert obs.counter_total("t.calls") == 4
    assert obs.counter_total("t.calls", kernel="k1") == 2
    assert obs.counter_total("t.calls", kernel="k1", outcome="a") == 1
    assert obs.counter_total("t.calls", kernel="nope") == 0


def test_gauges_and_histograms():
    obs.set_gauge("t.gauge", 1.0, shard="x")
    obs.set_gauge("t.gauge", 7.5, shard="x")     # last write wins
    for v in (1.0, 2.0, 6.0):
        obs.observe("t.lat", v, op="q")
    snap = obs.get_registry().snapshot()
    gauges = {(g["name"], tuple(sorted(g["labels"].items()))): g["value"]
              for g in snap["gauges"]}
    assert gauges[("t.gauge", (("shard", "x"),))] == 7.5
    st = obs.hist_stats("t.lat", op="q")
    assert st["count"] == 3 and st["sum"] == 9.0
    assert st["min"] == 1.0 and st["max"] == 6.0 and st["mean"] == 3.0
    assert obs.hist_stats("t.lat", op="missing") is None


def test_span_records_histogram_and_trace_event():
    with obs.span("t.step", phase="ingest"):
        pass
    st = obs.hist_stats("t.step.ms", phase="ingest")
    assert st is not None and st["count"] == 1 and st["max"] >= 0
    (e,) = obs.get_registry().trace_events()
    assert e["name"] == "t.step" and e["ph"] == "X" and e["cat"] == "repro"
    assert e["dur_ns"] >= 0 and e["args"] == {
        "phase": "ingest", "id": e["args"]["id"], "parent": None}


def test_disabled_registry_is_inert():
    reg = Registry(enabled=False)
    reg.inc("t.calls")
    reg.observe("t.lat", 1.0)
    reg.set_gauge("t.gauge", 1.0)
    with reg.span("t.step"):
        pass
    snap = reg.snapshot()
    assert snap["enabled"] is False
    assert snap["counters"] == [] and snap["histograms"] == []
    assert snap["gauges"] == [] and reg.trace_events() == []


def test_trace_event_cap_drops_and_counts():
    reg = Registry()
    for _ in range(MAX_TRACE_EVENTS + 5):
        with reg.span("t.e"):
            pass
    assert len(reg.trace_events()) == MAX_TRACE_EVENTS
    assert reg.snapshot()["dropped_trace_events"] == 5


def test_span_event_lies_on_the_profilers_clock():
    """A span's event nests inside a `record_function` range opened
    around it, on the profiler's clock (Unix nanoseconds, within 1 ms),
    and carries the OS thread id the profiler gives the range."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("t.warm"):    # the first range's set-up
            pass
        with record_function("t.range"):
            with obs.span("t.step"):
                torch.ones(64, 64).sum()
    (rng,) = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "t.range"]
    (e,) = obs.get_registry().trace_events()
    a, b = e["ts_ns"], e["ts_ns"] + e["dur_ns"]
    assert isinstance(a, int) and isinstance(e["dur_ns"], int)
    r0, r1 = rng.start_ns(), rng.start_ns() + rng.duration_ns()
    assert r0 - 1_000_000 <= a <= b <= r1 + 1_000_000, (r0, a, b, r1)
    assert abs(a - r0) < 1_000_000 and abs(b - r1) < 1_000_000
    # the profiler's OS thread id; `start_thread_id()` is the profiler's
    # own sequential numbering of threads, not the OS's
    assert e["tid"] == rng.device_resource_id() == threading.get_native_id()


def test_nested_spans_carry_parent_ids():
    """Each event's `parent` is the span open on its thread when it
    began: siblings share it, a root and another thread's span have
    None, and ids stay out of the histograms' labels."""
    def other():
        with obs.span("t.thread"):
            pass

    with obs.span("t.root"):
        with obs.span("t.child", k=1):
            with obs.span("t.leaf"):
                pass
        with obs.span("t.child", k=2):
            th = threading.Thread(target=other)
            th.start()
            th.join(60)
    assert not th.is_alive()
    assert obs.get_registry()._thread()[0] == []
    ev = {(e["name"], e["args"].get("k")): e["args"]
          for e in obs.get_registry().trace_events()}
    root = ev[("t.root", None)]
    assert root["parent"] is None and ev[("t.thread", None)]["parent"] is None
    assert ev[("t.child", 1)]["parent"] == root["id"]
    assert ev[("t.child", 2)]["parent"] == root["id"]
    assert ev[("t.leaf", None)]["parent"] == ev[("t.child", 1)]["id"]
    assert len({a["id"] for a in ev.values()}) == len(ev)
    labels = [h["labels"] for h in obs.get_registry().snapshot()["histograms"]]
    assert all(not {"id", "parent"} & set(lab) for lab in labels)
    assert obs.hist_stats("t.child.ms")["count"] == 2


def test_disabled_spans_record_nothing():
    """`REPRO_OBS=0`: a span is the shared null context, nothing is
    buffered and no stack of open spans is kept."""
    code = (
        "from repro_torch import obs\n"
        "from repro_torch.obs import registry\n"
        "with obs.span('x.outer') as a, obs.span('x.inner') as b:\n"
        "    assert a is b is registry._NULL_SPAN\n"
        "reg = obs.get_registry()\n"
        "assert reg.trace_events() == []\n"
        "assert getattr(reg._local, 'stack', None) is None\n"
        "print('DISABLED_SPANS_OK')\n"
    )
    env = dict(_env(), REPRO_OBS="0")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "DISABLED_SPANS_OK" in r.stdout


def test_thread_safety_of_counters():
    n_threads, n_incs = 8, 2500

    def worker():
        for _ in range(n_incs):
            obs.inc("t.parallel", worker="w")

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert obs.counter_total("t.parallel") == n_threads * n_incs


def test_repro_obs_env_kill_switch():
    """REPRO_OBS=0 hard-disables at import; checked in a subprocess
    because the flag is read when `repro_torch.obs` first loads."""
    code = (
        "from repro_torch import obs\n"
        "obs.inc('x.calls')\n"
        "with obs.span('x.step'):\n"
        "    pass\n"
        "assert not obs.enabled()\n"
        "snap = obs.get_registry().snapshot()\n"
        "assert snap['enabled'] is False\n"
        "assert snap['counters'] == [] and snap['histograms'] == []\n"
        "print('DISABLED_OK')\n"
    )
    env = dict(_env(), REPRO_OBS="0")
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "DISABLED_OK" in r.stdout


def test_obs_imports_only_the_standard_library():
    """The telemetry core is pure stdlib: importing it (and its CLI)
    loads neither torch nor numpy."""
    code = ("import sys\n"
            "import repro_torch.obs, repro_torch.obs.__main__\n"
            "bad = [m for m in ('torch', 'numpy', 'jax', 'repro')\n"
            "       if m in sys.modules]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    # repro_torch/__init__.py imports torch; load obs as a namespace
    # without running it, from a path that holds only the obs package
    r = subprocess.run([sys.executable, "-c",
                        "import importlib.util, sys, types\n"
                        "pkg = types.ModuleType('repro_torch')\n"
                        f"pkg.__path__ = [{str(REPO / 'src' / 'repro_torch')!r}]\n"
                        "sys.modules['repro_torch'] = pkg\n" + code],
                       capture_output=True, text=True, timeout=120,
                       env={"PATH": "/usr/bin:/bin"})
    assert r.returncode == 0, r.stdout + r.stderr[-2000:]


# --- exporters ------------------------------------------------------------

def test_prometheus_text_format():
    obs.inc("t.calls", 3, kernel="k")
    obs.observe("t.lat", 2.0)
    text = obs_export.to_prometheus(obs_export.snapshot())
    assert 'repro_t_calls_total{kernel="k"} 3' in text
    assert "repro_t_lat_count 1" in text
    assert "repro_t_lat_sum 2.0" in text


def test_snapshot_write_load_roundtrip(tmp_path):
    obs.inc("t.calls", kernel="k")
    path = tmp_path / "deep" / "snap.json"     # exporter makedirs
    written = obs_export.write_snapshot(str(path), meta={"backend": "cpu"})
    loaded = obs_export.load_snapshot(str(path))
    assert loaded == json.loads(json.dumps(written))
    assert loaded["meta"]["backend"] == "cpu"
    assert loaded["counters"][0]["name"] == "t.calls"


def test_chrome_trace_roundtrip(tmp_path):
    with obs.span("t.step", op="x"):
        pass
    path = tmp_path / "trace.json"
    obs_export.write_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    assert trace["displayTimeUnit"] == "ms"
    (e,) = trace["traceEvents"]
    assert e["name"] == "t.step" and e["ph"] == "X"
    assert set(e) >= {"ts", "dur", "pid", "tid", "args"}
    # microseconds on the Unix clock, from the buffer's nanoseconds
    (raw,) = obs.get_registry().trace_events()
    assert e["ts"] == raw["ts_ns"] / 1e3 and e["dur"] == raw["dur_ns"] / 1e3
    assert not {"ts_ns", "dur_ns"} & set(e)


def test_cli_summary_and_prometheus(tmp_path):
    obs.inc("cli.calls", 5, kernel="k")
    path = tmp_path / "snap.json"
    obs_export.write_snapshot(str(path), meta={"backend": "cpu"})
    r = subprocess.run([sys.executable, "-m", "repro_torch.obs", str(path)],
                       env=_env(), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "cli.calls" in r.stdout and "backend: cpu" in r.stdout
    r2 = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "--prometheus", str(path)],
        env=_env(), capture_output=True, text=True, timeout=120)
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert 'repro_cli_calls_total{kernel="k"} 5' in r2.stdout


def test_same_records_give_the_reference_snapshot_and_exposition():
    """One recording sequence into both packages' registries: the same
    snapshot (spans' times aside), Prometheus text and summary."""
    jobs.reset()
    for reg in (obs, jobs):
        reg.inc("stream.ingest.chunks")
        reg.inc("stream.quarantine", reason="nonfinite")
        reg.inc("stream.ingest.rows", 512)
        reg.set_gauge("stream.generation", 3)
        for v in (1.0, 4.0, 2.5):
            reg.observe("serve.request_ms", v)
    got = obs_export.snapshot(meta={"run": "x"})
    want = jobs_export.snapshot(meta={"run": "x"})
    assert got == want
    assert obs_export.to_prometheus(got) == jobs_export.to_prometheus(want)
    assert obs_export.summarize(got) == jobs_export.summarize(want)
    assert obs.hist_quantiles("serve.request_ms") == \
        jobs.hist_quantiles("serve.request_ms")
    jobs.reset()


# --- the stream service's timeline ----------------------------------------

def test_stream_online_chrome_trace_lifecycle(tmp_path):
    """`python -m repro_torch.launch.stream_online --smoke --device cpu
    --obs-out` writes a Chrome trace whose timeline carries the service's
    ingest, refit and predict spans, and headline metrics consistent
    with the run."""
    from repro_torch.launch.stream_online import main as stream_main
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        out = tmp_path / "obs.json"
        met = stream_main(["--smoke", "--device", "cpu", "--obs-out",
                           str(out)])
    finally:
        torch.set_num_threads(old)
    trace = json.loads((tmp_path / "obs.trace.json").read_text())
    assert trace["displayTimeUnit"] == "ms"
    names = {e["name"] for e in trace["traceEvents"]}
    assert {"stream.ingest", "stream.refit", "stream.predict"} <= names
    for e in trace["traceEvents"]:
        assert e["ph"] == "X" and e["dur"] >= 0 and e["ts"] >= 0
    snap = json.loads(out.read_text())
    assert snap["meta"]["example"] == "stream_online"
    assert snap["meta"]["device"] == "cpu"
    # smoke run: 8 chunks ingested, a refit every 2 chunks + 1 final
    assert obs.counter_total("stream.ingest.chunks") == 8
    assert met["refits_during_stream"] == 4
    assert met["obs_refits_recorded"] == met["refits_during_stream"] + 1
    assert met["generations"] == 5
    assert met["obs_ingest_rows_per_s"] > 0
    assert met["obs_refit_latency_ms"] > 0


def test_torchprof_writes_a_chrome_trace(tmp_path):
    from repro_torch.obs import torchprof
    a = torch.randn(64, 64)
    with torchprof.profiler_trace(str(tmp_path / "prof")) as prof:
        (a @ a).sum()
    assert obs.counter_total("obs.torchprof.trace") == 1
    assert any("mm" in e.key for e in prof.key_averages())
    (path,) = (tmp_path / "prof").iterdir()
    assert path.name == f"trace.{os.getpid()}.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
