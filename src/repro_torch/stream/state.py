"""Streaming sufficient-statistics state (checkpointable tensor tree).

The port's counterpart of the JAX package's `repro/stream/state.py`.
The DSML estimator never touches raw samples after the reduction to
`(Sigma, c)`, and those statistics are *additive over samples*. A
stream of minibatches therefore folds into a fixed-size `StreamState`
— per-task running covariance/correlation means plus an effective
sample count — and the full pipeline (lasso, debias, threshold) can be
re-run at any time from the state alone. Three ingestion regimes:

  * plain (`decay=1`):   exact running means; ingesting a dataset in
                          any chunking reproduces `sufficient_stats`
                          on the concatenation (to float roundoff).
  * exponential decay:    `decay<1` multiplies the *old* effective
                          count per ingested chunk, so a chunk that is
                          j chunks old carries weight decay^j — cheap
                          forgetting for non-stationary traffic.
  * sliding window:       `WindowState` keeps the last w chunk stats
                          in a ring buffer; `window_stats` aggregates
                          exactly the surviving chunks.

Every function is pure: it returns new tensors and writes none it was
given (no `add_`, no `out=`, no `copy_` into a state's tensor), so a
caller that keeps the old state keeps it bit for bit — the guarded
ingest discards a rejected fold that way, and adoption swaps whole
states. A chunk's reduction is one `sufficient_stats` call: one launch
of the `rank_update` kernel on CUDA tensors.

The counters the host branches on — `StreamState.generation`,
`WindowState.head` and `seen` — are 0-d int32 tensors on the host
whatever the device of the statistics, so reading one never waits for
the card. `StreamState` round-trips through `checkpoint.io.save_pytree`
in the JAX package's layout.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.engine import sufficient_stats


class StreamState(NamedTuple):
    Sigmas: torch.Tensor      # (m, p, p) running weighted-mean covariance
    cs: torch.Tensor          # (m, p)    running weighted-mean correlation
    counts: torch.Tensor      # (m,)      effective sample count (decays)
    beta_local: torch.Tensor  # (m, p)    last step-1 lasso (refit warm start)
    Ms: torch.Tensor          # (m, p, p) last debias M (refit warm start)
    beta_u: torch.Tensor      # (m, p)    last debiased estimates
    beta_tilde: torch.Tensor  # (m, p)    current servable estimates
    support: torch.Tensor     # (p,) bool current shared support
    generation: torch.Tensor  # ()   int32 refit generation, on the host


def _host_int(v: int) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32)


def init_stream_state(m: int, p: int, dtype=torch.float32,
                      device="cuda") -> StreamState:
    """Empty state for m tasks in p dimensions (zero samples seen)."""
    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return StreamState(
        Sigmas=zeros(m, p, p), cs=zeros(m, p), counts=zeros(m),
        beta_local=zeros(m, p), Ms=zeros(m, p, p), beta_u=zeros(m, p),
        beta_tilde=zeros(m, p), support=zeros(p, dt=torch.bool),
        generation=_host_int(0))


def ingest_stats(state: StreamState, Sigma_b: torch.Tensor,
                 c_b: torch.Tensor, count_b, decay=1.0) -> StreamState:
    """Fold one chunk's *mean* statistics into the running means.

    Sigma_b (m, p, p) and c_b (m, p) are chunk means weighted by
    `count_b` (scalar or (m,) effective samples). `decay` scales the
    old effective count first, so with decay d and chunk counts n_k the
    state equals  sum_k d^{K-k} n_k stats_k / sum_k d^{K-k} n_k.
    """
    dt = state.Sigmas.dtype
    count_b = torch.as_tensor(count_b, dtype=dt,
                              device=state.counts.device)
    count_b = count_b.reshape(-1).expand(state.counts.shape)
    w_old = torch.as_tensor(decay, dtype=dt) * state.counts
    total = w_old + count_b
    denom = torch.clamp_min(total, torch.finfo(dt).tiny)
    Sigmas = (w_old[:, None, None] * state.Sigmas
              + count_b[:, None, None] * Sigma_b) / denom[:, None, None]
    cs = (w_old[:, None] * state.cs + count_b[:, None] * c_b) \
        / denom[:, None]
    return state._replace(Sigmas=Sigmas, cs=cs, counts=total)


def ingest(state: StreamState, X_batch: torch.Tensor, y_batch: torch.Tensor,
           weights: torch.Tensor | None = None, decay=1.0, *,
           use_kernel: bool | None = None) -> StreamState:
    """Rank-n update from a raw minibatch. X (m, n, p), y (m, n).

    The chunk reduction is `sufficient_stats`: Sigma_b and c_b from ONE
    launch of the fused `rank_update` kernel on CUDA tensors (its plain
    version on the CPU, or anywhere with `use_kernel=False`).

    `weights` (m, n) importance-weights samples within the chunk (the
    chunk's effective count becomes sum(weights) per task); `decay`
    applies exponential forgetting to everything already ingested.
    """
    n = X_batch.shape[1]
    Sigma_b, c_b = sufficient_stats(X_batch, y_batch, weights,
                                    use_kernel=use_kernel)
    dt = state.counts.dtype
    if weights is None:
        count_b = torch.full(state.counts.shape, n, dtype=dt,
                             device=state.counts.device)
    else:
        count_b = torch.sum(weights, dim=1).to(dt)
        # sufficient_stats normalizes by n, not sum(w): rescale the chunk
        # means so count_b * mean recovers the weighted sums.
        scale = n / torch.clamp_min(count_b, torch.finfo(dt).tiny)
        Sigma_b = Sigma_b * scale[:, None, None]
        c_b = c_b * scale[:, None]
    return ingest_stats(state, Sigma_b, c_b, count_b, decay)


def merge(a: StreamState, b: StreamState) -> StreamState:
    """Additive merge of two states' statistics (shards of one stream).

    Model fields (beta/support/generation) follow `a`; only the
    sufficient statistics and counts combine.
    """
    return ingest_stats(a, b.Sigmas, b.cs, b.counts)


# ---------------------------------------------------------------------------
# sliding window
# ---------------------------------------------------------------------------

class WindowState(NamedTuple):
    Sigmas: torch.Tensor   # (w, m, p, p) per-slot chunk mean covariance
    cs: torch.Tensor       # (w, m, p)    per-slot chunk mean correlation
    counts: torch.Tensor   # (w, m)       per-slot sample counts (0 = empty)
    head: torch.Tensor     # ()  int32    next slot to overwrite, on the host
    seen: torch.Tensor     # ()  int32    total chunks ever ingested, host


def init_window(window: int, m: int, p: int, dtype=torch.float32,
                device="cuda") -> WindowState:
    return WindowState(
        Sigmas=torch.zeros((window, m, p, p), dtype=dtype, device=device),
        cs=torch.zeros((window, m, p), dtype=dtype, device=device),
        counts=torch.zeros((window, m), dtype=dtype, device=device),
        head=_host_int(0),
        seen=_host_int(0),
    )


def _set_slot(ring: torch.Tensor, h: int, value: torch.Tensor):
    """A new ring with slot `h` replaced by `value` (the old ring kept)."""
    return torch.cat([ring[:h], value.to(ring.dtype)[None], ring[h + 1:]])


def window_ingest(win: WindowState, X_batch: torch.Tensor,
                  y_batch: torch.Tensor, *,
                  use_kernel: bool | None = None) -> WindowState:
    """Write one chunk's stats into the ring buffer (evicts the oldest)."""
    n = X_batch.shape[1]
    Sigma_b, c_b = sufficient_stats(X_batch, y_batch, use_kernel=use_kernel)
    w = win.counts.shape[0]
    h = int(win.head)
    return WindowState(
        Sigmas=_set_slot(win.Sigmas, h, Sigma_b),
        cs=_set_slot(win.cs, h, c_b),
        counts=_set_slot(win.counts, h, torch.full(
            win.counts.shape[1:], n, dtype=win.counts.dtype,
            device=win.counts.device)),
        head=_host_int((h + 1) % w),
        seen=_host_int(int(win.seen) + 1),
    )


def window_stats(win: WindowState
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Aggregate the surviving chunks: (Sigmas (m,p,p), cs (m,p), counts (m,)).

    Equals `sufficient_stats` on the concatenation of the last
    min(seen, window) chunks.
    """
    total = torch.sum(win.counts, dim=0)                      # (m,)
    denom = torch.clamp_min(total, torch.finfo(win.counts.dtype).tiny)
    Sigmas = torch.einsum("wm,wmij->mij", win.counts, win.Sigmas) \
        / denom[:, None, None]
    cs = torch.einsum("wm,wmi->mi", win.counts, win.cs) / denom[:, None]
    return Sigmas, cs, total
