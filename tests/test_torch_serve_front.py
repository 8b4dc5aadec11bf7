"""The port's serving front (`repro_torch.stream.serve`) and the
service's predict contract, on the CPU.

Case for case the reference's `tests/test_serve.py` (without the
substrate-feed cases, which belong to the sharded paths) and the
fixed-front cases of `tests/test_interleave.py`, run on the port: atomic
generation swaps checked bitwise with real threads racing ingest and
refit, the microbatch admission layer, the predict input contract, the
`stop()`/`start()` ownership rules under a gated schedule and 200
seeded adversarial ones (the port's copy of the interleave harness).
The front's scores are also held against the reference service's
predictions on the same published model.
"""
from __future__ import annotations

import os
import random
import threading
import time
from concurrent.futures import Future

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.stream as jstream
from repro_torch import obs
from repro_torch.obs.registry import Registry, _quantile
from repro_torch.stream import (
    ModelGeneration, ServeResult, ServingFront, StreamingDsmlService,
    bucket_rows,
)
from repro_torch.stream.serve import _Request
from repro_torch.stream.service import _predict_shared
from repro_torch.testing import Gates, InterleaveScheduler, instrument

LAM, MU, THR = 0.05, 0.1, 0.02
M, P, CHUNK = 4, 32, 128
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _service(**kw):
    kw.setdefault("refit_every", CHUNK)
    kw.setdefault("lasso_iters", 150)
    kw.setdefault("debias_iters", 150)
    kw.setdefault("refit_tol", 1e-5)
    kw.setdefault("guard", False)
    kw.setdefault("device", CPU)
    return StreamingDsmlService(M, P, lam=LAM, mu=MU, Lam=THR, **kw)


def _chunk(rng, n=CHUNK):
    X = rng.standard_normal((M, n, P)).astype(np.float32)
    w = rng.standard_normal((M, P)).astype(np.float32) / np.sqrt(P)
    y = (np.einsum("tnp,tp->tn", X, w)
         + 0.05 * rng.standard_normal((M, n))).astype(np.float32)
    return torch.from_numpy(X), torch.from_numpy(y)


def _reference(beta, X) -> np.ndarray:
    """The verification oracle: the SAME product at the SAME shapes on
    that generation's recorded weights — bitwise equal to what serving
    must have computed if (and only if) it read one coherent
    snapshot."""
    return _predict_shared(torch.as_tensor(beta), torch.as_tensor(X)).numpy()


# -- units ----------------------------------------------------------------

def test_bucket_rows_powers_of_two():
    assert [bucket_rows(r) for r in (1, 7, 8, 9, 63, 64, 65)] == \
        [8, 8, 8, 16, 64, 64, 128]
    assert bucket_rows(3, min_bucket=4) == 4
    with pytest.raises(ValueError):
        bucket_rows(0)


def test_obs_quantiles():
    assert _quantile([5.0], 0.99) == 5.0
    vals = sorted(float(v) for v in range(1, 101))
    assert _quantile(vals, 0.5) == pytest.approx(50.5)
    assert _quantile(vals, 0.99) == pytest.approx(99.01)
    reg = Registry()
    for v in range(1, 101):
        reg.observe("lat.ms", float(v), route="a" if v % 2 else "b")
    q = reg.hist_quantiles("lat.ms")
    assert q[0.5] == pytest.approx(50.5)
    assert q[0.99] == pytest.approx(99.01)
    assert reg.hist_quantiles("lat.ms", route="a")[0.5] == pytest.approx(50.0)
    assert reg.hist_quantiles("missing") is None
    snap = reg.snapshot()
    hist = [h for h in snap["histograms"] if h["labels"] == {"route": "a"}][0]
    assert hist["p50"] == pytest.approx(50.0)
    assert "p99" in hist


def test_disabled_registry_retains_nothing():
    reg = Registry(enabled=False)
    reg.observe("lat.ms", 1.0)
    assert reg.hist_quantiles("lat.ms") is None
    assert reg.snapshot()["histograms"] == []


# -- predict contract -----------------------------------------------------

def test_predict_rank1_is_one_shared_row():
    svc = _service()
    rng = np.random.default_rng(0)
    svc.ingest(*_chunk(rng))
    row = rng.standard_normal(P).astype(np.float32)
    out = svc.predict(row)
    assert out.shape == (M, 1)
    assert torch.equal(out, svc.predict(row.reshape(1, P)))


def test_predict_rows_counter_counts_normalized_rows():
    svc = _service()
    rng = np.random.default_rng(1)
    svc.ingest(*_chunk(rng))
    before = obs.counter_total("stream.predict.rows")
    svc.predict(rng.standard_normal(P).astype(np.float32))
    assert obs.counter_total("stream.predict.rows") - before == 1  # not P
    svc.predict(rng.standard_normal((5, P)).astype(np.float32))
    svc.predict(rng.standard_normal((M, 3, P)).astype(np.float32))
    assert obs.counter_total("stream.predict.rows") - before == 1 + 5 + 3


def test_predict_rejects_malformed_inputs():
    svc = _service()
    rng = np.random.default_rng(2)
    for bad in (rng.standard_normal(P + 1),
                rng.standard_normal((5, P + 1)),
                rng.standard_normal((M + 1, 5, P)),
                rng.standard_normal((M, 5, P + 1)),
                rng.standard_normal((2, 2, 2, 2))):
        with pytest.raises(ValueError):
            svc.predict(bad.astype(np.float32))


def test_predict_matches_reference_service():
    """Both packages' services on the same chunks publish the same model
    and score the shared and per-task contracts alike, to 1e-5."""
    svc = _service()
    ref = jstream.StreamingDsmlService(
        M, P, lam=LAM, mu=MU, Lam=THR, refit_every=CHUNK, lasso_iters=150,
        debias_iters=150, refit_tol=1e-5, guard=False)
    rng = np.random.default_rng(12)
    for _ in range(3):
        X, y = _chunk(rng)
        svc.ingest(X, y)
        ref.ingest(jnp.asarray(X.numpy()), jnp.asarray(y.numpy()))
    assert svc.serving().generation == ref.serving().generation >= 2
    for shape in ((P,), (5, P), (M, 3, P)):
        X = rng.standard_normal(shape).astype(np.float32)
        np.testing.assert_allclose(svc.predict(X).numpy(),
                                   np.array(ref.predict(jnp.asarray(X))),
                                   rtol=0, atol=1e-5)


# -- generation snapshots -------------------------------------------------

def test_snapshot_survives_adoption_and_publish_sites():
    svc = _service()
    rng = np.random.default_rng(3)
    held = svc.serving()
    assert isinstance(held, ModelGeneration) and held.generation == 0
    held_beta = held.beta_tilde.clone()
    svc.ingest(*_chunk(rng))                       # triggers a refit
    assert svc.generation == 1
    assert svc.serving().generation == 1
    # the snapshot captured before adoption is untouched
    assert held.generation == 0
    assert torch.equal(held.beta_tilde, held_beta)


def test_restore_republishes(tmp_path):
    svc = _service(ckpt_dir=str(tmp_path))
    rng = np.random.default_rng(4)
    svc.ingest(*_chunk(rng))
    fitted = svc.serving().beta_tilde
    assert svc.serving().generation == 1
    fresh = _service(ckpt_dir=str(tmp_path))
    assert fresh.serving().generation == 0
    fresh.restore()
    assert fresh.serving().generation == 1
    assert torch.equal(fresh.serving().beta_tilde, fitted)


def test_ingest_while_predict_interleaving_bitwise():
    """Predictions taken between chunk folds must equal post-hoc
    predictions from the same generation's model, bitwise."""
    svc = _service()
    rng = np.random.default_rng(5)
    X0 = torch.from_numpy(rng.standard_normal((6, P)).astype(np.float32))
    betas = {0: svc.serving().beta_tilde}
    observed = []
    for _ in range(6):
        scores, gen = svc.predict(X0, return_generation=True)
        observed.append((scores, gen))
        svc.ingest(*_chunk(rng))
        snap = svc.serving()
        betas[snap.generation] = snap.beta_tilde
    assert svc.generation >= 3        # refits really happened mid-stream
    for scores, gen in observed:
        np.testing.assert_array_equal(scores.numpy(),
                                      _reference(betas[gen], X0))


def test_threaded_generation_swap_stress():
    """Predict hammered from threads while ingest adopts generation
    after generation: every observed (scores, generation) pair must
    reproduce bitwise from that generation's model, and generations
    must be nondecreasing per thread (a reader can lag the swap, never
    un-see it)."""
    svc = _service(max_refit_interval=CHUNK)       # adopt every chunk
    rng = np.random.default_rng(6)
    X0 = torch.from_numpy(rng.standard_normal((4, P)).astype(np.float32))
    betas = {0: svc.serving().beta_tilde}
    chunks = [_chunk(rng) for _ in range(12)]
    done = threading.Event()
    results, errors = [], []
    lock = threading.Lock()

    def ingest_loop():
        try:
            for X, y in chunks:
                svc.ingest(X, y)
                snap = svc.serving()
                betas[snap.generation] = snap.beta_tilde
        finally:
            done.set()

    def predict_loop():
        mine = []
        try:
            while not done.is_set():
                scores, gen = svc.predict(X0, return_generation=True)
                mine.append((scores.numpy(), gen))
        except Exception as e:  # noqa: BLE001 - surfaced to the assert
            errors.append(e)
        with lock:
            results.append(mine)

    workers = [threading.Thread(target=predict_loop) for _ in range(4)]
    for t in workers:
        t.start()
    feeder = threading.Thread(target=ingest_loop)
    feeder.start()
    feeder.join(120)
    for t in workers:
        t.join(120)
    assert not feeder.is_alive() and not any(t.is_alive() for t in workers)

    assert not errors, errors
    assert svc.generation == len(chunks)
    total = 0
    refs = {}
    for mine in results:
        gens = [g for _, g in mine]
        assert gens == sorted(gens)               # never un-adopts
        for scores, gen in mine:
            assert gen in betas
            if gen not in refs:
                refs[gen] = _reference(betas[gen], X0)
            np.testing.assert_array_equal(scores, refs[gen])
            total += 1
    assert total > 0


# -- the microbatch front -------------------------------------------------

def test_front_process_single_dispatch_parity():
    """_process on hand-built requests (no threads): one padded product,
    per-request slices bitwise equal to scoring the padded batch
    directly, one shared generation stamp."""
    svc = _service()
    rng = np.random.default_rng(7)
    svc.ingest(*_chunk(rng))
    front = ServingFront(svc, max_batch=16)
    rows = [rng.standard_normal((n, P)).astype(np.float32)
            for n in (1, 3, 2)]
    reqs = [_Request(x, Future(), time.perf_counter()) for x in rows]
    front._process(reqs)

    padded = np.zeros((bucket_rows(6), P), np.float32)
    padded[:1], padded[1:4], padded[4:6] = rows[0], rows[1], rows[2]
    snap = svc.serving()
    expect = _reference(snap.beta_tilde, padded)
    off = 0
    for req, x in zip(reqs, rows):
        res = req.future.result(timeout=1)
        assert res.generation == snap.generation
        np.testing.assert_array_equal(res.scores,
                                      expect[:, off:off + x.shape[0]])
        off += x.shape[0]


def test_front_threaded_serving_during_ingest():
    """Threaded smoke: submits race a live ingest/refit loop; every
    result's generation is a real published generation and its scores
    match that generation's model (allclose — the padded bucket shape
    varies with batch fill, which may change the reduction order)."""
    svc = _service()
    rng = np.random.default_rng(8)
    betas = {0: svc.serving().beta_tilde.numpy()}
    chunks = [_chunk(rng) for _ in range(6)]
    row = rng.standard_normal(P).astype(np.float32)
    with ServingFront(svc, max_batch=8, max_delay_ms=1.0) as front:
        front.predict(row, timeout=10)
        done = threading.Event()

        def ingest_loop():
            try:
                for X, y in chunks:
                    svc.ingest(X, y)
                    snap = svc.serving()
                    betas[snap.generation] = snap.beta_tilde.numpy()
            finally:
                done.set()

        feeder = threading.Thread(target=ingest_loop)
        feeder.start()
        futs = []
        while not done.is_set():
            futs.append(front.submit(row))
            time.sleep(0.001)
        feeder.join(120)
        res = [f.result(timeout=10) for f in futs]

    assert svc.generation >= 3
    for r in res:
        assert r.generation in betas
        want = betas[r.generation] @ row           # (m,) float32
        np.testing.assert_allclose(r.scores[:, 0], want, atol=1e-4)


def test_front_submit_validation_and_stop():
    svc = _service()
    front = ServingFront(svc, max_batch=4)
    with pytest.raises(RuntimeError):              # not started
        front.submit(np.zeros(P, np.float32))
    front.start()
    with pytest.raises(ValueError):                # wrong feature count
        front.submit(np.zeros(P + 1, np.float32))
    with pytest.raises(ValueError):                # oversized block
        front.submit(np.zeros((5, P), np.float32))
    fut = front.submit(np.zeros(P, np.float32))
    assert fut.result(timeout=10).scores.shape == (M, 1)
    assert front.stop() is True
    with pytest.raises(RuntimeError):              # stopped
        front.submit(np.zeros(P, np.float32))


def test_front_error_reaches_the_callers_with_the_worker_traceback():
    """A batch that fails resolves every caller's future with the error,
    carrying the worker's traceback as a note; the worker keeps
    serving and counts the error."""
    svc = _service()

    class Broken:
        p = P

        def serving(self):
            raise ArithmeticError("poisoned model")

    front = ServingFront(Broken(), max_batch=4)
    before = obs.counter_total("serve.errors", kind="ArithmeticError")
    reqs = [_Request(np.zeros((1, P), np.float32), Future(),
                     time.perf_counter()) for _ in range(2)]
    front._process_safe(reqs)
    for req in reqs:
        exc = req.future.exception(timeout=1)
        assert isinstance(exc, ArithmeticError)
        assert any("serving front worker" in n for n in exc.__notes__)
    assert obs.counter_total("serve.errors",
                             kind="ArithmeticError") == before + 1
    with ServingFront(svc, max_batch=4) as good:
        assert good.predict(np.zeros(P, np.float32),
                            timeout=10).generation == 0


@pytest.mark.serve_perf
@pytest.mark.skipif(not os.environ.get("REPRO_SERVE_PERF"),
                    reason="set REPRO_SERVE_PERF=1 for the latency smoke")
def test_front_p99_latency_smoke():
    """Opt-in latency gate, as in the reference: a loaded front must
    hold a loose p99 on the CPU."""
    svc = _service()
    rng = np.random.default_rng(9)
    svc.ingest(*_chunk(rng))
    row = rng.standard_normal(P).astype(np.float32)
    with ServingFront(svc, max_batch=32, max_delay_ms=1.0) as front:
        front.predict(row, timeout=10)
        futs = [front.submit(row) for _ in range(400)]
        for f in futs:
            f.result(timeout=30)
        q = front.latency_quantiles()
    assert q is not None and q[0.99] < 250.0, q


# -- the lifecycle under scripted and seeded schedules -----------------------

GENERATION = 7


class _TinyService:
    """The minimal `.p` + `.serving()` surface `ServingFront` needs,
    publishing one fixed `ModelGeneration`. With `gates`, every
    `serving()` call parks at the named gate so a test can hold the
    worker mid-`_process` at an exact, named point."""

    def __init__(self, gates: Gates | None = None, gate: str = "serving"):
        beta = torch.arange(3 * 5, dtype=torch.float32).reshape(3, 5) * 0.1 \
            + 1.0
        self.p = 5
        self._snap = ModelGeneration(beta, torch.ones(5, dtype=torch.bool),
                                     GENERATION)
        self._gates = gates
        self._gate = gate

    def serving(self) -> ModelGeneration:
        if self._gates is not None:
            self._gates.reach(self._gate)
        return self._snap


X0 = np.linspace(-1.0, 1.0, 5).astype(np.float32)


def _reference_column(svc: _TinyService) -> np.ndarray:
    """The exact (m, 1) scores a single-row X0 request must carry: every
    microbatch of X0 rows pads to the same (8, 5) shape, and each output
    column depends only on its own input row."""
    X = np.zeros((8, 5), dtype=np.float32)
    X[0] = X0
    return _reference(svc._snap.beta_tilde, X)[:, :1]


def test_fixed_front_survives_the_stop_race_schedule():
    """Submit A (the worker parks mid-batch), submit B, stop with a
    too-short timeout, restart: the timed-out stop() reclaims nothing,
    B still resolves (drain-and-stop), the restart waits the old worker
    out and mints fresh lifecycle state, and exactly one worker
    remains."""
    gates = Gates()
    svc = _TinyService(gates=gates)
    front = ServingFront(svc, max_batch=1, max_delay_ms=0.5, poll_s=0.01)
    ref = _reference_column(svc)

    front.start()
    zombie = front._worker
    ev0 = front._stop
    fut_a = front.submit(X0)
    gates.wait_reached("serving")
    fut_b = front.submit(X0)

    assert front.stop(timeout=0.05) is False
    assert front._worker is zombie
    assert not fut_b.done()
    assert front._stop is ev0 and ev0.is_set()

    gates.release("serving", 2)        # batch A, then B in the last sweep

    front.start()                      # joins the zombie out, then spawns
    assert not zombie.is_alive()
    assert front._worker is not zombie and front._worker.is_alive()
    assert front._stop is not ev0 and ev0.is_set()
    assert not front._stop.is_set()

    for fut in (fut_a, fut_b):
        res: ServeResult = fut.result(timeout=5)
        assert res.generation == GENERATION
        np.testing.assert_array_equal(res.scores, ref)

    assert front.stop() is True
    assert front._worker is None


def test_stopped_front_rejects_new_submissions():
    front = ServingFront(_TinyService(), max_batch=1, poll_s=0.01)
    front.start()
    assert front.stop() is True
    with pytest.raises(RuntimeError, match="not running"):
        front.submit(X0)


def test_gates_timeout_is_loud():
    with pytest.raises(TimeoutError, match="never released"):
        Gates().reach("nobody-home", timeout=0.01)


@pytest.mark.parametrize("seed_block", range(8))
def test_seeded_schedules_stay_bitwise_coherent(seed_block):
    """200 seeded schedules (25 per block), each forcing context switches
    at every `_worker`/`_stop`/`_carry` touch while a seeded op script
    submits, stops and restarts the front. Every admitted future
    terminates, EITHER with the stop error OR with bitwise-exact scores
    under the published generation."""
    svc = _TinyService()
    ref = _reference_column(svc)

    for seed in range(seed_block * 25, (seed_block + 1) * 25):
        sched = InterleaveScheduler(seed, max_wait_s=0.02)
        Front = instrument(ServingFront, ("_worker", "_stop", "_carry"),
                           sched)
        front = Front(svc, max_batch=4, max_delay_ms=0.5, poll_s=0.005)
        sched.register()
        rng = random.Random(seed)
        futures = []
        front.start()
        for _ in range(8):
            op = rng.choice(("submit", "submit", "submit", "stop",
                             "start"))
            if op == "submit":
                try:
                    futures.append(front.submit(X0))
                except RuntimeError:
                    pass               # front stopped — legal refusal
            elif op == "stop":
                front.stop(timeout=rng.choice((0.0, 0.01)))
            else:
                front.start()
        sched.close()
        while front.stop(timeout=1.0) is False:
            pass
        assert front._worker is None

        for fut in futures:
            exc = fut.exception(timeout=5)   # also proves it terminated
            if exc is not None:
                assert isinstance(exc, RuntimeError), (seed, exc)
                assert "serving front stopped" in str(exc)
                continue
            res: ServeResult = fut.result()
            assert res.generation == GENERATION, seed
            np.testing.assert_array_equal(res.scores, ref,
                                          err_msg=f"seed={seed}")
