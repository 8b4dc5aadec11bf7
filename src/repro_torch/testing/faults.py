"""Deterministic fault injection for the streaming DSML service.

The port's counterpart of the JAX package's `repro/testing/faults.py`:
the same schedules and corruptions, drawn from the same numpy
generators, so a seed gives both packages the same chunks. Every fault
the resilience layer claims to survive is scriptable here, seeded and
replayable:

* **poisoned batches** — `apply_batch_fault` corrupts a clean chunk
  with NaN rows, Inf entries, or a magnitude outburst, at positions
  drawn from a caller-seeded generator;
* **fault schedules** — `build_schedule` lays those corruptions out
  over an ingest timeline (`FaultSchedule.fault_for(step)`), so a chaos
  run is a pure function of its seed;
* **refit divergence** — `DivergenceInjector` installs itself into the
  service's `_refit_impl` seam and NaN-poisons the *candidate* state of
  the next N refit attempts, exercising the health-check/rollback path
  without needing numerically divergent data;
* **torn writes** — `truncate_file` chops the tail off a checkpoint to
  simulate a crash mid-write on a filesystem without atomic rename
  (or a corrupted disk block), driving the manifest fallback path.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

BATCH_FAULT_KINDS = ("nan", "inf", "outlier")


class FaultEvent(NamedTuple):
    step: int      # ingest step (0-based) the fault fires on
    kind: str      # one of BATCH_FAULT_KINDS, or "diverge" / "truncate"


class FaultSchedule(NamedTuple):
    seed: int
    n_steps: int
    events: Tuple[FaultEvent, ...]

    def fault_for(self, step: int) -> Optional[str]:
        for ev in self.events:
            if ev.step == step:
                return ev.kind
        return None

    def by_kind(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for ev in self.events:
            out[ev.kind] = out.get(ev.kind, 0) + 1
        return out


def build_schedule(n_steps: int, seed: int, *,
                   kinds: Sequence[str] = BATCH_FAULT_KINDS,
                   per_kind: int = 2, start: int = 0) -> FaultSchedule:
    """A seeded schedule: `per_kind` events of each kind, at distinct
    steps drawn without replacement from `[start, n_steps)`. Same
    arguments -> identical schedule, every run. `start` reserves the
    first steps as guaranteed-clean (e.g. so a relative-magnitude
    guard has accepted traffic to learn its reference scale from)."""
    need = per_kind * len(kinds)
    if need > n_steps - start:
        raise ValueError(f"{need} events do not fit in steps "
                         f"[{start}, {n_steps})")
    rng = np.random.default_rng(seed)
    steps = rng.choice(np.arange(start, n_steps), size=need, replace=False)
    events = tuple(
        FaultEvent(int(step), kind)
        for step, kind in zip(sorted(int(s) for s in steps),
                              list(kinds) * per_kind))
    return FaultSchedule(seed=seed, n_steps=n_steps, events=events)


# -- batch corruption ------------------------------------------------------

def make_clean_batch(rng: np.random.Generator, m: int, n: int, p: int,
                     dtype=torch.float32, device="cuda"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A healthy standardized chunk: X ~ N(0,1), y a noisy linear read,
    drawn in float64 on the host and cast to `dtype` on `device`."""
    X = rng.standard_normal((m, n, p))
    w = rng.standard_normal((m, p)) / np.sqrt(p)
    y = np.einsum("tnp,tp->tn", X, w) + 0.1 * rng.standard_normal((m, n))
    return (torch.as_tensor(X, dtype=dtype, device=device),
            torch.as_tensor(y, dtype=dtype, device=device))


def apply_batch_fault(X, y, kind: str, rng: np.random.Generator,
                      *, outlier_scale: float = 1e6):
    """Corrupt one chunk with fault `kind`; returns new (X, y) tensors
    on the chunk's device, with its dtype (the inputs are untouched).

    "nan"      one full row of one task becomes NaN;
    "inf"      a handful of scattered entries become +/-Inf;
    "outlier"  the whole chunk is scaled by `outlier_scale` (finite,
               so only the relative-magnitude gate can catch it).
    """
    Xc = X.detach().cpu().numpy().astype(np.float64)
    yc = y.detach().cpu().numpy().astype(np.float64)
    m, n, p = Xc.shape
    if kind == "nan":
        t, i = int(rng.integers(m)), int(rng.integers(n))
        Xc[t, i, :] = np.nan
        yc[t, i] = np.nan
    elif kind == "inf":
        for _ in range(max(3, p // 16)):
            t, i, j = (int(rng.integers(m)), int(rng.integers(n)),
                       int(rng.integers(p)))
            Xc[t, i, j] = np.inf if rng.integers(2) else -np.inf
    elif kind == "outlier":
        Xc *= outlier_scale
        yc *= outlier_scale
    else:
        raise ValueError(f"unknown batch fault kind '{kind}' "
                         f"(want one of {BATCH_FAULT_KINDS})")
    return (torch.as_tensor(Xc, dtype=X.dtype, device=X.device),
            torch.as_tensor(yc, dtype=y.dtype, device=y.device))


# -- refit divergence ------------------------------------------------------

class DivergenceInjector:
    """Forces the next N refit attempts of a service to produce a
    NaN-poisoned candidate, via the `_refit_impl` seam.

    The real refit still runs (warm-start bookkeeping, generation
    bump on the candidate) — only its OUTPUT model fields are poisoned,
    so the rollback path under test sees exactly what a numerically
    diverged solve would hand it.

        inj = DivergenceInjector(svc)
        inj.arm(2)          # next two attempts diverge
        ...
        inj.uninstall()     # restore the pristine impl
    """

    def __init__(self, service):
        self.service = service
        self._orig = service._refit_impl
        self.calls = 0
        self.injected = 0
        self._armed = 0
        service._refit_impl = self._wrapped

    def arm(self, n: int = 1) -> None:
        self._armed += int(n)

    def uninstall(self) -> None:
        self.service._refit_impl = self._orig

    def _wrapped(self, state, lam, mu, Lam, *, lasso_iters, debias_iters,
                 warm, **kw):
        self.calls += 1
        candidate, info = self._orig(state, lam, mu, Lam,
                                     lasso_iters=lasso_iters,
                                     debias_iters=debias_iters, warm=warm,
                                     **kw)
        if self._armed > 0:
            self._armed -= 1
            self.injected += 1
            nan = torch.full_like(candidate.beta_tilde, float("nan"))
            candidate = candidate._replace(
                beta_local=torch.full_like(candidate.beta_local,
                                           float("nan")),
                beta_tilde=nan)
        return candidate, info


# -- torn writes -----------------------------------------------------------

def truncate_file(path: str, *, keep_fraction: float = 0.5) -> int:
    """Chop the tail off `path` in place (a simulated torn write).
    Returns the number of bytes kept. `keep_fraction=0` empties it."""
    import os
    size = os.path.getsize(path)
    keep = int(size * keep_fraction)
    with open(path, "r+b") as f:
        f.truncate(keep)
    return keep
