"""The card's work and idle charged to the obs spans
(`repro_torch.obs.torchprof.charge`), on synthetic profiler events:
kernels charged through their correlation ids to the span that held
their launch on its own thread, and each idle gap by what kept the card
idle (work already queued, the host, or the caching allocator); and
`span_trace` end to end under CPU-only profiling."""
from __future__ import annotations

import threading
import time

import pytest
import torch

from repro_torch import obs
from repro_torch.obs import torchprof

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
TID, PTHREAD = 4242, -316206336      # an OS thread id, a cut pthread_t
THREADS = {PTHREAD: TID}


@pytest.fixture(autouse=True)
def _fresh_registry():
    obs.reset()
    yield
    obs.reset()


class Event:
    """The part of the profiler's `_KinetoEvent` that `charge` reads."""

    def __init__(self, name, a, b, device, corr, resource):
        self._v = (name, a, b - a, device, corr, resource)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def device_resource_id(self):
        return self._v[5]


def launch(t, corr, name="cudaLaunchKernel"):
    return Event(name, t, t + 5, CPU, corr, PTHREAD)


def kernel(name, a, b, corr):
    return Event(name, a, b, CUDA, corr, 7)


def span(name, a, b, sid, parent, tid=TID):
    return {"name": name, "ph": "X", "cat": "repro", "ts_ns": a,
            "dur_ns": b - a, "pid": 1, "tid": tid,
            "args": {"id": sid, "parent": parent}}


EVENTS = [launch(250, 1), launch(550, 2), launch(850, 3), launch(950, 4),
          kernel("k_lasso", 300, 350, 1), kernel("k_debias", 600, 700, 2),
          kernel("k_master", 860, 870, 3), kernel("k_next", 960, 990, 4),
          kernel("k_unmatched", 10, 20, 99)]
SPANS = [span("dsml.fit", 100, 900, 1, None),
         span("engine.lasso", 200, 400, 2, 1),
         span("engine.debias_solve", 500, 800, 3, 1),
         span("dsml.fit", 930, 1100, 4, None)]


def test_kernels_are_charged_through_their_launch():
    c = torchprof.charge(EVENTS, SPANS, 0, 1000, THREADS)
    assert c.spans["engine.lasso"] == pytest.approx([50e-9, 50e-9])
    assert c.spans["engine.debias_solve"] == pytest.approx([100e-9, 100e-9])
    # the fit's own launches (k_master, k_next) and its phases'
    assert c.spans["dsml.fit"] == pytest.approx([40e-9, 190e-9])
    # a kernel whose launch the trace does not hold
    assert c.spans["outside"] == pytest.approx([10e-9, 10e-9])
    assert c.device_s == pytest.approx(200e-9)
    assert c.launched_s == pytest.approx(190e-9)
    assert c.busy_s == pytest.approx(200e-9)
    assert c.window_s == pytest.approx(1e-6)


def test_runtime_calls_on_another_thread_are_not_charged():
    """A span holds only the launches made on its own thread."""
    other = [span("dsml.fit", 0, 1000, 9, None, tid=TID + 1)]
    c = torchprof.charge(EVENTS, other, 0, 1000, THREADS)
    assert set(c.spans) == {"outside"}
    assert c.spans["outside"] == pytest.approx([200e-9, 200e-9])


def test_idle_is_charged_by_what_kept_the_card_idle():
    """A gap that ends on work launched inside it is the host's, charged
    to the span open at its middle; one that ends on work queued before
    it is the launching span's; the window's tail is the host's."""
    c = torchprof.charge(EVENTS, SPANS, 0, 1000, THREADS)
    # 0-10: middle in no span, k_unmatched has no launch -> host outside;
    # 20-300 ended on k_lasso launched at 250 -> host, middle 160 in the
    # fit; 350-600 on k_debias launched at 550 -> host, middle 475 in the
    # fit; 700-860 on k_master launched at 850 -> host, middle 780 in
    # the debias solve; 870-960 on k_next launched at 950 -> host,
    # middle 915 in no span; 990-1000, the tail, middle in the second fit
    assert c.idle == pytest.approx({
        ("host", "outside"): 100e-9, ("host", "dsml.fit"): 540e-9,
        ("host", "engine.debias_solve"): 160e-9})


def test_queued_and_allocator_gaps_stand_apart():
    events = [launch(150, 1), launch(160, 2), launch(700, 3),
              Event("cudaMalloc", 500, 700, CPU, 0, PTHREAD),
              kernel("k1", 200, 400, 1), kernel("k2", 450, 500, 2),
              kernel("k3", 720, 730, 3)]
    spans = [span("dsml.fit", 100, 800, 1, None),
             span("engine.lasso", 140, 170, 2, 1)]
    c = torchprof.charge(events, spans, 0, 1000, THREADS)
    # 400-450 ended on k2, queued at 160 inside the lasso; 500-720 has
    # its middle in the cudaMalloc; 0-200 and 730-1000 are the host's
    assert c.idle == pytest.approx({
        ("queued", "engine.lasso"): 50e-9, ("alloc", "dsml.fit"): 220e-9,
        ("host", "outside"): 200e-9 + 70e-9, ("host", "dsml.fit"): 200e-9})


def test_thread_ids_map_the_profilers_ids():
    me = threading.current_thread()
    ids = torchprof.thread_ids()
    low = me.ident & 0xFFFFFFFF
    signed = low - (1 << 32) if low >> 31 else low
    assert ids[me.ident] == ids[low] == ids[signed] == me.native_id


def test_span_trace_charges_the_block_to_its_spans():
    """Under CPU-only profiling there is no device work: the block's idle
    is the host's, charged to the span open over most of it."""
    with torchprof.span_trace() as box:
        with obs.span("t.outer"):
            time.sleep(0.02)
    c = box["charge"]
    assert c.device_s == 0.0 and c.spans == {}
    assert c.window_s >= 0.02
    assert set(c.idle) == {("host", "t.outer")}
    assert c.idle[("host", "t.outer")] == pytest.approx(c.window_s)
