"""Deterministic interleaving harness: the dynamic half of the
concurrency contract.

A copy of the JAX package's `repro/testing/interleave.py` (pure stdlib;
the port imports nothing of that package). The static checker
(`tools/repro_lint`, RL4xx) proves code *honors* its declared
`_SYNC_POLICY`; this module proves the policies are the *right* ones,
by forcing the thread schedules a production box would only hit under
load. Three instruments:

* **`InterleaveScheduler`** — a seeded cooperative scheduler. Threads
  `register()` and then call `yield_point(tag)` at interesting moments;
  each yield hands the "token" to a seeded-RNG-chosen registered thread
  and blocks until the token comes back. Running the same seed replays
  the same schedule bit-for-bit; sweeping seeds explores adversarial
  interleavings systematically instead of hoping the OS scheduler gets
  hostile. Threads that block in real primitives (joins, queue gets)
  while holding the token would deadlock a strict token ring, so a
  blocked handoff self-reclaims after `max_wait_s` (counted in
  `stalls` — determinism of the *replayed decisions* is preserved; the
  reclaim only un-wedges threads the harness cannot see inside).

* **`Gates`** — named rendezvous points for fully scripted schedules.
  A thread calls `reach(name)` and parks; the test calls
  `wait_reached(name)` to know it is parked and `release(name)` to let
  it through. Where the seeded scheduler explores, gates *pin*: a
  `ServingFront.stop()` race replays as one exact schedule with no
  randomness at all.

* **`instrument(cls, attrs, scheduler)`** — subclass `cls` so that
  every get/set of the named attributes passes through a scheduler
  yield point. This plants context switches exactly at the shared-state
  touches the static checker reasons about, without editing the class
  under test.
"""
from __future__ import annotations

import random
import threading
from typing import Dict, Iterable, List, Optional, Tuple, Type

__all__ = ["InterleaveScheduler", "Gates", "instrument"]


class InterleaveScheduler:
    """Seeded token-passing scheduler over registered threads.

    Exactly one registered thread "holds the token" (runs) at a time;
    `yield_point` donates it to a seeded-random registered thread
    (possibly itself) and waits for it back. `close()` releases
    everyone and turns every subsequent yield into a no-op, so tests
    can fall back to real concurrency for cleanup joins.
    """

    _SYNC_POLICY = {
        "*": "immutable-after-init",
        "_threads": "lock:_lock",
        "_active": "lock:_lock",
        "preemptions": "lock:_lock",
        "stalls": "lock:_lock",
        "schedule": "lock:_lock",
    }

    def __init__(self, seed: int, *, max_wait_s: float = 0.1,
                 auto_register: bool = True):
        self._rng = random.Random(seed)
        self.seed = seed
        self.max_wait_s = float(max_wait_s)
        self.auto_register = bool(auto_register)
        self._lock = threading.Lock()
        self._threads: Dict[int, threading.Event] = {}
        self._active = True
        self.preemptions = 0     # yields that handed the token away
        self.stalls = 0          # reclaims from a blocked token holder
        self.schedule: List[Tuple[str, int]] = []  # (tag, chosen ident)

    def register(self, thread: Optional[threading.Thread] = None) -> None:
        """Enroll a thread (default: the calling one) in the token
        ring. Unregistered threads run freely, un-scheduled."""
        ident = thread.ident if thread is not None \
            else threading.get_ident()
        if ident is None:
            raise ValueError("register() needs a started thread")
        with self._lock:
            self._threads.setdefault(ident, threading.Event())

    def unregister(self) -> None:
        with self._lock:
            self._threads.pop(threading.get_ident(), None)

    def yield_point(self, tag: str = "") -> None:
        """Donate the token to a seeded-random registered thread and
        wait for it back. No-op once closed or for lone threads."""
        me = threading.get_ident()
        with self._lock:
            if not self._active:
                return
            if me not in self._threads:
                if not self.auto_register:
                    return
                self._threads.setdefault(me, threading.Event())
            others = [i for i in self._threads if i != me]
            if not others:
                return
            chosen = self._rng.choice(others)
            self.schedule.append((tag, chosen))
            self.preemptions += 1
            my_ev = self._threads[me]
            my_ev.clear()
            self._threads[chosen].set()
        # wait for the token back; a holder blocked inside a real
        # primitive (join, queue get) can't donate, so reclaim after
        # max_wait_s rather than deadlocking the ring
        if not my_ev.wait(self.max_wait_s):
            with self._lock:
                if self._active:
                    self.stalls += 1

    def close(self) -> None:
        """End scheduling: wake every parked thread, make every further
        yield a no-op. Call before cleanup joins."""
        with self._lock:
            self._active = False
            for ev in self._threads.values():
                ev.set()


class Gates:
    """Named scripted rendezvous: `reach` parks, `release` frees.

    Each gate is a semaphore (starts at 0) plus an arrival event, so a
    test can both *know* a thread is parked at a named point and decide
    exactly when it proceeds — the fully deterministic complement to
    the seeded scheduler."""

    _SYNC_POLICY = {
        "*": "immutable-after-init",
        "_gates": "lock:_lock",
    }

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._gates: Dict[str, Tuple[threading.Event,
                                     threading.Semaphore]] = {}

    def _gate(self, name: str) -> Tuple[threading.Event,
                                        threading.Semaphore]:
        with self._lock:
            if name not in self._gates:
                self._gates[name] = (threading.Event(),
                                     threading.Semaphore(0))
            return self._gates[name]

    def reach(self, name: str, timeout: Optional[float] = 10.0) -> None:
        """Park at `name` until the test `release()`s it."""
        arrived, sem = self._gate(name)
        arrived.set()
        if not sem.acquire(timeout=timeout):
            raise TimeoutError(f"gate '{name}' never released")

    def wait_reached(self, name: str, timeout: float = 10.0) -> None:
        """Block until some thread is parked at (or has passed) `name`."""
        arrived, _ = self._gate(name)
        if not arrived.wait(timeout):
            raise TimeoutError(f"no thread reached gate '{name}'")

    def release(self, name: str, n: int = 1) -> None:
        _, sem = self._gate(name)
        for _ in range(n):
            sem.release()


def instrument(cls: Type, attrs: Iterable[str],
               scheduler: InterleaveScheduler) -> Type:
    """Subclass `cls` with scheduler yield points on every get/set of
    the named attributes — context switches forced exactly at the
    shared-state touches the static checker (RL4xx) reasons about."""
    watched = frozenset(attrs)

    def __getattribute__(self, name):
        if name in watched:
            scheduler.yield_point(f"get:{name}")
        return object.__getattribute__(self, name)

    def __setattr__(self, name, value):
        if name in watched:
            scheduler.yield_point(f"set:{name}")
        object.__setattr__(self, name, value)

    return type(f"Interleaved{cls.__name__}", (cls,), {
        "__getattribute__": __getattribute__,
        "__setattr__": __setattr__,
    })
