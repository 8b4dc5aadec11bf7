"""Guarded ingest: the validation gate in front of `(Sigma, c)`.

The port's counterpart of the JAX package's `repro/stream/guard.py`.
The streaming state's statistics are additive and *irreversible*: once
a chunk folds into the running `(Sigma, c)` means there is no inverse
update that removes it (the decayed/windowed variants only forget
slowly). A single NaN row therefore poisons every future refit, and a
fat-fingered 1e12 feature swamps the covariance for as long as the
decay horizon. `IngestGuard` rejects such chunks *before* the fold:

* **non-finite** — any NaN/Inf in X or y quarantines the chunk;
* **magnitude** — an optional absolute ceiling on max|x| (off by
  default: scale is workload-specific);
* **outlier** — a relative gate: once `warmup_chunks` chunks have been
  accepted, a chunk whose RMS exceeds `outlier_factor` x the
  exponential moving average RMS of accepted traffic is quarantined.
  The reference scale only learns from *accepted* chunks, so a burst
  of garbage cannot drag the gate open.

The service's dense path fuses the probe into the fold (`_guarded_fold`):
the health comes from the chunk's own statistics, and its read — three
numbers — is the one host synchronisation of a guarded ingest. The
admission *decision* is a host branch, the honest price of refusing
to fold a chunk you have not looked at.

Rejected chunks land in a bounded quarantine ledger (newest
`ledger_capacity` records; older ones drop with a counter, never
unbounded growth) and are counted per reason under
`stream.quarantine{reason}`.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.engine import sufficient_stats
from repro_torch.stream.state import StreamState, ingest_stats


class QuarantineRecord(NamedTuple):
    seq: int                 # ingest sequence number of the rejected chunk
    reason: str              # "nonfinite" | "magnitude" | "outlier"
    shape: Tuple[int, ...]   # (m, n, p) of the offending chunk
    stat: float              # the statistic that tripped the gate
    threshold: float         # the bound it violated


def _chunk_health(X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """[all_finite, rms, max_abs] as a (3,) f32 — two reductions over
    the raw chunk.

    NaN and Inf both propagate through `max(|.|)`, so the single
    `isfinite(max_abs)` scalar covers the whole finiteness check with
    no extra pass. A non-finite chunk's rms may itself be NaN; every
    consumer checks the finite flag (or compares NaN-safely) first.
    """
    rms = torch.sqrt(torch.mean(torch.square(X.to(torch.float32))))
    max_abs = torch.maximum(torch.max(torch.abs(X)),
                            torch.max(torch.abs(y))).to(torch.float32)
    finite = torch.isfinite(max_abs)
    return torch.stack([finite.to(torch.float32), rms, max_abs])


def _guarded_fold(state: StreamState, X: torch.Tensor, y: torch.Tensor,
                  decay, *, use_kernel: bool | None = None):
    """Speculative fold + health derived from the fold's OWN chunk
    statistics: one `rank_update` launch and O(m·p) probe work.

    The host classifies the pulled health and simply keeps the old
    state object when the chunk is rejected — the folded (possibly
    poisoned) state is discarded unassigned, so rejection is bitwise
    exact by construction (the fold writes only new tensors).

    The health costs next to nothing because it reads the chunk
    statistics the fold computes regardless, never the raw chunk:

    * `diag(Sigma_b)[t, j] = mean_i X[t,i,j]^2` — every element of X
      appears squared in its own diagonal entry, so one NaN/Inf
      anywhere makes `sum(diag)` non-finite, and
      `sqrt(mean(diag)) == rms(X)` up to rounding;
    * `c_b = X^T y / n` catches the y side: a non-finite y[t, i]
      reaches every c_b[t, :] entry it touches (IEEE `0 * Inf = NaN`,
      so even an all-zero X row cannot launder it).

    max|x| is NOT derivable from the fold's statistics, so the fused
    path carries no absolute-magnitude verdict (health[2] = NaN); a
    guard configured with `max_abs=` routes through the standalone
    `admit` probe instead and pays its separate reductions.
    """
    n = X.shape[1]
    Sigma_b, c_b = sufficient_stats(X, y, use_kernel=use_kernel)
    count_b = torch.full(state.counts.shape, n, dtype=state.counts.dtype,
                         device=state.counts.device)
    folded = ingest_stats(state, Sigma_b, c_b, count_b, decay)
    diag = torch.diagonal(Sigma_b, dim1=1, dim2=2)
    ss, cs_ss = torch.sum(diag), torch.sum(torch.square(c_b))
    finite = torch.isfinite(ss) & torch.isfinite(cs_ss)
    rms = torch.sqrt(torch.mean(diag))
    health = torch.stack([finite.to(torch.float32), rms.to(torch.float32),
                          torch.full((), float("nan"), dtype=torch.float32,
                                     device=rms.device)])
    return folded, health


class IngestGuard:
    """Admission gate for streaming minibatches.

    `admit(X, y)` returns `(ok, reason)`; on `ok=False` the caller must
    not fold the chunk (the service path simply skips `ingest`, leaving
    `(Sigma, c)` bitwise untouched). The guard is host-side state — it
    is not part of the checkpointed tree; a restarted service starts
    with a fresh (warming-up) reference scale.
    """

    def __init__(self, *, max_abs: Optional[float] = None,
                 outlier_factor: Optional[float] = 10.0,
                 warmup_chunks: int = 5,
                 ema_decay: float = 0.99,
                 ledger_capacity: int = 256):
        if outlier_factor is not None and outlier_factor <= 1.0:
            raise ValueError(f"outlier_factor must be > 1 (or None to "
                             f"disable), got {outlier_factor}")
        if not 0.0 < ema_decay < 1.0:
            raise ValueError(f"ema_decay must be in (0, 1), got {ema_decay}")
        self.max_abs = max_abs
        self.outlier_factor = outlier_factor
        self.warmup_chunks = int(warmup_chunks)
        self.ema_decay = float(ema_decay)
        self.ledger: Deque[QuarantineRecord] = deque(maxlen=ledger_capacity)
        self.dropped_records = 0     # quarantines evicted past capacity
        self.total_quarantined = 0
        self.accepted = 0
        self._seq = 0
        self._ema_rms: Optional[float] = None

    # -- admission --------------------------------------------------------

    def limits(self) -> Tuple[float, float]:
        """Current (rms_limit, abs_limit) for the device-side verdict,
        +inf where a gate is disabled or still warming up. Rounded to
        f32 so the fused fold's comparison and `record`'s host
        classification see the same thresholds."""
        abs_limit = self.max_abs if self.max_abs is not None \
            else float("inf")
        if (self.outlier_factor is not None and self._ema_rms is not None
                and self.accepted >= self.warmup_chunks):
            rms_limit = float(np.float32(self.outlier_factor
                                         * self._ema_rms))
        else:
            rms_limit = float("inf")
        return rms_limit, float(np.float32(abs_limit))

    def admit(self, X_batch, y_batch) -> Tuple[bool, Optional[str]]:
        """Decide one chunk standalone (its own probe reductions; the
        dense service path fuses the probe into the fold and calls
        `record` with the health directly). Returns (True, None) or
        (False, reason)."""
        health = _chunk_health(X_batch, y_batch).tolist()
        return self.record(health, tuple(int(s) for s in X_batch.shape))

    def record(self, health, shape) -> Tuple[bool, Optional[str]]:
        """Classify one chunk's `[finite, rms, max_abs]` probe result:
        ledger + counters on reject, EMA reference update on accept."""
        self._seq += 1
        rms_limit, abs_limit = self.limits()
        finite = bool(health[0])
        rms, max_abs = float(health[1]), float(health[2])
        if not finite:
            self._quarantine("nonfinite", shape, max_abs, float("inf"))
            return False, "nonfinite"
        if max_abs > abs_limit:
            self._quarantine("magnitude", shape, max_abs, abs_limit)
            return False, "magnitude"
        if not rms <= rms_limit:     # NaN-safe: an unreadable rms rejects
            self._quarantine("outlier", shape, rms, rms_limit)
            return False, "outlier"
        self.accepted += 1
        if np.isfinite(rms):     # an overflowed (inf) rms must never
            if self._ema_rms is None:   # poison the reference scale
                self._ema_rms = rms
            else:
                d = self.ema_decay
                self._ema_rms = d * self._ema_rms + (1.0 - d) * rms
        return True, None

    def _quarantine(self, reason: str, shape, stat: float,
                    threshold: float) -> None:
        if len(self.ledger) == self.ledger.maxlen:
            self.dropped_records += 1
            obs.inc("stream.quarantine_dropped")
        self.ledger.append(QuarantineRecord(self._seq, reason, shape,
                                            stat, threshold))
        self.total_quarantined += 1
        obs.inc("stream.quarantine", reason=reason)

    # -- introspection ----------------------------------------------------

    @property
    def reference_rms(self) -> Optional[float]:
        """EMA RMS of accepted traffic (None until the first accept)."""
        return self._ema_rms

    def summary(self) -> dict:
        by_reason: dict = {}
        for rec in self.ledger:
            by_reason[rec.reason] = by_reason.get(rec.reason, 0) + 1
        return {"accepted": self.accepted,
                "quarantined": self.total_quarantined,
                "ledger": len(self.ledger),
                "dropped_records": self.dropped_records,
                "by_reason_in_ledger": by_reason,
                "reference_rms": self._ema_rms}
