"""StreamingDsmlService: the online DSML loop as a servable driver.

The port's counterpart of the JAX package's `repro/stream/service.py`,
on the card by default (`device="cuda"`). Ties the streaming pieces
together around one `StreamState`:

    ingest loop     raw minibatches fold into the state (host path,
                    decayed, sliding-window, or sharded over a data x
                    task mesh via `stream.accumulate`); each chunk is
                    one launch of the `rank_update` kernel on the card
                    (on each rank, for its block, when sharded);
    guarded ingest  an `IngestGuard` in front of the fold quarantines
                    non-finite / magnitude-outlier chunks BEFORE they
                    can poison the irreversible `(Sigma, c)` statistics
                    (`stream/guard.py`; pass `guard=False` to opt out);
    refit policy    a refit runs every `refit_every` ingested samples;
                    when the refreshed support has not drifted
                    (jaccard >= 1 - drift_threshold) the interval
                    doubles, up to `max_refit_interval` — stationary
                    traffic converges to rare refits, a support shift
                    snaps the cadence back to the base rate;
    refit health    every candidate refit passes the `stream/health.py`
                    invariants (finite model, support sanity, KKT
                    residual ceiling) before it is adopted; a failing
                    candidate is ROLLED BACK — the service keeps
                    serving the last good generation, the retry waits
                    out a capped exponential backoff and runs with an
                    escalated iteration budget;
    warm starts     generation-0 refits run the full cold budget,
                    later ones warm-start both solves (lasso from
                    `beta_local`, debias from `Ms`) with the
                    `warm_*_iters` budgets (default: a quarter);
    serving         `predict` scores against ONE immutable
                    `ModelGeneration` snapshot captured per call (always
                    the last HEALTHY generation) — adoption installs a
                    new snapshot with a single atomic reference swap, so
                    a predict racing a refit can never observe a torn or
                    mixed-generation model; `stream/serve.py` builds the
                    async microbatched front on the same snapshots;
    persistence     `save`/`load` round-trip the state through
                    `checkpoint/io` (atomic npz in the JAX package's
                    layout; `load` validates (m, p, dtype) compatibility
                    before touching live state), and `ckpt_dir=`
                    upgrades persistence to the crash-safe
                    `CheckpointStore` — checksummed manifest, retained
                    generations, `restore()` falling back past a
                    corrupted head.

With `mesh=` (a `DeviceMesh` with dims `data_axis` and `task_axis`, on
`torch.distributed`) every rank of the mesh runs the service over its
block of tasks, m / size(task) of them, and is fed every chunk whole:
the guard probes the whole chunk (the same verdict on every rank, with
no communication), `feed_chunk` takes the rank's block and
`ingest_sharded` sums it over `data` (two all-reduces a chunk). A refit
runs on the rank's statistics and gathers the debiased rows over `task`
once (`refit(mesh=...)`), so the support is global; its health verdict
is the max over the mesh (one `pmax` per mesh dim), so all ranks
adopt or roll back together and their generations never part.
`predict` scores this rank's tasks; checkpoints hold this rank's state.

Not ported: the autotune cache warm-up (the port's kernels choose
their tiles by plan functions).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import obs
from repro_torch.checkpoint.io import (
    CheckpointError, load_npz, npz_safe_dtype, restore_pytree, save_pytree,
)
from repro_torch.checkpoint.manifest import CheckpointStore
from repro_torch.stream.accumulate import ingest_sharded
from repro_torch.stream.guard import IngestGuard, _guarded_fold
from repro_torch.stream.health import RefitHealth, refit_health
from repro_torch.stream.refit import RefitInfo, refit
from repro_torch.stream.serve import ModelGeneration
from repro_torch.substrate.feed import feed_chunk
from repro_torch.stream.state import (
    init_stream_state, init_window, ingest, window_ingest, window_stats,
)

# consecutive-failure escalation of the retry iteration budget is
# capped: past 2 failures more iterations stop being the cure and the
# backoff (waiting for more data) carries the recovery instead
MAX_ITER_ESCALATION = 4


def _predict_tasks(beta_tilde: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    return torch.einsum("tnp,tp->tn", X, beta_tilde)


def _predict_shared(beta_tilde: torch.Tensor,
                    X: torch.Tensor) -> torch.Tensor:
    return torch.einsum("np,tp->tn", X, beta_tilde)


class StreamingDsmlService:
    """Online DSML over continuously arriving multi-task traffic.

    Thread-sharing contract (`_SYNC_POLICY`, checked by repro_lint
    RL4xx): all mutation — ingest/refit/rollback/load/restore — belongs
    to ONE driver thread; its public entry points are the `worker-only`
    roots below. Reader threads (predict, the serving front) touch
    only `_serving`, which is republished exclusively by whole-object
    atomic reference swap inside `publish_model` — so a reader can race
    any number of refits and never observe a torn model. `_refit_impl`
    is the fault-injection seam (`repro_torch.testing.faults`) and is
    likewise swapped only by whole-reference assignment.

    Chunks may be tensors or numpy arrays; they are moved to the
    service's `device` as contiguous tensors of its `dtype`.
    `use_kernel` goes to every kernel wrapper the service calls
    (`kernels/common.py`): on a CUDA device the default launches the
    kernels, `False` runs their plain versions there (the on-card
    reference).
    """

    _SYNC_POLICY = {
        "*": "immutable-after-init",
        "state": "worker-only:ingest,refit,load,restore,save,"
                 "checkpoint,generation,samples_seen",
        "window": "worker-only:ingest,refit,load,restore,save,"
                  "checkpoint,generation,samples_seen",
        "_interval": "worker-only:ingest,refit,load,restore,save,"
                     "checkpoint,generation,samples_seen",
        "_since_refit": "worker-only:ingest,refit,load,restore,save,"
                        "checkpoint,generation,samples_seen",
        "_refit_failures": "worker-only:ingest,refit,load,restore,save,"
                           "checkpoint,generation,samples_seen",
        "rollbacks": "worker-only:ingest,refit,load,restore,save,"
                     "checkpoint,generation,samples_seen",
        "last_info": "worker-only:ingest,refit,load,restore,save,"
                     "checkpoint,generation,samples_seen",
        "last_health": "worker-only:ingest,refit,load,restore,save,"
                       "checkpoint,generation,samples_seen",
        "_refit_impl": "atomic-publish",
        "_serving": "atomic-publish:publish_model",
    }

    def __init__(self, m: int, p: int, *, lam, mu, Lam,
                 dtype=torch.float32,
                 device="cuda",
                 use_kernel: bool | None = None,
                 decay: float = 1.0,
                 window: Optional[int] = None,
                 refit_every: int = 2048,
                 drift_threshold: float = 0.05,
                 max_refit_interval: Optional[int] = None,
                 lasso_iters: int = 400,
                 debias_iters: int = 600,
                 warm_lasso_iters: Optional[int] = None,
                 warm_debias_iters: Optional[int] = None,
                 refit_tol: Optional[float] = None,
                 guard=True,
                 refit_health_checks: bool = True,
                 refit_kkt_ceiling: float = 1.0,
                 max_support: Optional[int] = None,
                 ckpt_dir: Optional[str] = None,
                 ckpt_keep: int = 3,
                 checkpoint_on_refit: bool = True,
                 mesh=None, data_axis: str = "data",
                 task_axis: str = "task"):
        if window is not None and mesh is not None:
            raise ValueError("sliding-window ingestion is host-only; "
                             "pass decay= for sharded non-stationarity")
        if window is not None and decay != 1.0:
            raise ValueError("decay and window are alternative forgetting "
                             "schemes; the window path aggregates its "
                             "chunks unweighted, so pass one or the other")
        self.m, self.p = m, p
        self.mesh, self.data_axis, self.task_axis = mesh, data_axis, task_axis
        self.m_local = m
        if mesh is not None:
            n_task = mesh.size(mesh.mesh_dim_names.index(task_axis))
            if m % n_task:
                raise ValueError(f"m={m} tasks not divisible by "
                                 f"{task_axis}={n_task}")
            self.m_local = m // n_task
        self.dtype = dtype
        self.device = torch.device(device)
        self.use_kernel = use_kernel
        self.lam, self.mu, self.Lam = lam, mu, Lam
        self.decay = float(decay)
        self.lasso_iters = lasso_iters
        self.debias_iters = debias_iters
        self.warm_lasso_iters = warm_lasso_iters if warm_lasso_iters \
            is not None else max(lasso_iters // 4, 25)
        self.warm_debias_iters = warm_debias_iters if warm_debias_iters \
            is not None else max(debias_iters // 4, 25)
        # refit latency budget: with a tol, every iteration count above
        # becomes a CEILING — the solves early exit on their KKT
        # residuals, so a warm refit costs what the statistics drift
        # demands and the ceiling bounds the refit's worst-case latency
        self.refit_tol = refit_tol if refit_tol is None else float(refit_tol)
        self.refit_every = refit_every
        self.drift_threshold = float(drift_threshold)
        self.max_refit_interval = max_refit_interval \
            if max_refit_interval is not None else 16 * refit_every
        # guarded ingest: True -> default gate, False/None -> off, or an
        # IngestGuard instance for tuned thresholds
        if guard is True:
            self.guard: Optional[IngestGuard] = IngestGuard()
        elif guard is False or guard is None:
            self.guard = None
        else:
            self.guard = guard
        self.refit_health_checks = refit_health_checks
        self.refit_kkt_ceiling = float(refit_kkt_ceiling)
        self.max_support = max_support
        self.ckpt_store = CheckpointStore(ckpt_dir, keep=ckpt_keep) \
            if ckpt_dir is not None else None
        self.checkpoint_on_refit = checkpoint_on_refit
        self.state = init_stream_state(self.m_local, p, dtype, self.device)
        self.window = init_window(window, m, p, dtype, self.device) \
            if window else None
        self._interval = refit_every
        self._since_refit = 0
        self._refit_failures = 0     # consecutive rejected candidates
        self.rollbacks = 0           # total rejected candidates, ever
        self.last_info: Optional[RefitInfo] = None
        self.last_health: Optional[RefitHealth] = None
        # injectable refit seam: the fault-injection harness
        # (repro_torch.testing.faults) swaps this to script divergence; the
        # production path never touches it
        self._refit_impl = refit
        # the published model: ONE immutable snapshot, replaced only by
        # whole-reference assignment (atomic under the GIL) at the
        # closed set of model-changing sites — adoption, load/restore,
        # and explicit publish_model(). predict never reads live state.
        self._serving: ModelGeneration = self.publish_model()

    # -- ingestion --------------------------------------------------------

    def _on_device(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=self.dtype,
                               device=self.device).contiguous()

    def ingest(self, X_batch, y_batch) -> Optional[RefitInfo]:
        """Fold one (m, n, p)/(m, n) minibatch in; maybe refit.

        Returns the `RefitInfo` when this chunk triggered a refit
        attempt, None otherwise (including when the guard quarantined
        the chunk — a rejected chunk neither folds nor advances the
        refit cadence, so `(Sigma, c)` stay bitwise unchanged).

        The `stream.ingest` span times the host-side fold: on the card
        the fold is asynchronous, so without a guard it times the
        issue (rows/sec headlines from it are an upper bound on
        sustained throughput); the fused guard's health read waits for
        the fold inside the span. A triggered refit is timed by its
        own `stream.refit` span, not this one.
        """
        X_batch, y_batch = self._on_device(X_batch), self._on_device(y_batch)
        # dense path: probe fused into the fold (one rank_update launch,
        # one host read); the window and sharded paths — and a guard
        # with an absolute max_abs ceiling, which the fused
        # statistics-derived probe cannot evaluate — probe standalone in
        # front of the fold (sharded: every rank probes the whole chunk,
        # so all ranks reach the same verdict)
        fused = (self.guard is not None and self.window is None
                 and self.mesh is None and self.guard.max_abs is None)
        if self.guard is not None and not fused:
            ok, _reason = self.guard.admit(X_batch, y_batch)
            if not ok:
                obs.inc("stream.ingest.quarantined_chunks")
                return None
        n = int(X_batch.shape[1])
        with obs.span("stream.ingest"):
            if fused:
                folded, health = _guarded_fold(
                    self.state, X_batch, y_batch, self.decay,
                    use_kernel=self.use_kernel)
                ok, _reason = self.guard.record(
                    health.tolist(), tuple(int(s) for s in X_batch.shape))
                if not ok:
                    # the speculative fold is discarded unassigned:
                    # (Sigma, c) stay bitwise the pre-chunk arrays
                    obs.inc("stream.ingest.quarantined_chunks")
                    return None
                self.state = folded
            elif self.window is not None:
                self.window = window_ingest(self.window, X_batch, y_batch,
                                            use_kernel=self.use_kernel)
            elif self.mesh is not None:
                Xd, yd = feed_chunk(X_batch, y_batch, self.mesh,
                                    data_axis=self.data_axis,
                                    task_axis=self.task_axis)
                self.state = ingest_sharded(self.state, Xd, yd, self.mesh,
                                            decay=self.decay,
                                            data_axis=self.data_axis,
                                            task_axis=self.task_axis,
                                            use_kernel=self.use_kernel)
            else:
                self.state = ingest(self.state, X_batch, y_batch,
                                    decay=self.decay,
                                    use_kernel=self.use_kernel)
        obs.inc("stream.ingest.chunks")
        obs.inc("stream.ingest.rows", self.m * n)
        self._since_refit += n
        if self._since_refit >= self._interval:
            return self.refit()
        return None

    # -- refit policy -----------------------------------------------------

    def refit(self) -> RefitInfo:
        """Attempt a DSML refresh now; adopt it only if healthy.

        A healthy candidate advances the generation and adapts the
        cadence exactly as before. An UNHEALTHY candidate (non-finite
        model, oversized support, KKT residual past the ceiling) is
        discarded: the service keeps serving the last good generation,
        the next attempt waits out a capped exponential backoff
        (base_interval * 2^failures, capped at `max_refit_interval`)
        and runs with an escalated iteration budget (cold budgets x
        2^failures, capped at x4). The returned `RefitInfo` then
        describes the KEPT state (unchanged generation, jaccard 1.0).

        The `stream.refit` span is TRUE latency (unlike the async
        ingest span): the health verdict and drift read block on the
        refreshed model inside the span.
        """
        with obs.span("stream.refit"):
            if self.window is not None and int(self.window.seen) > 0:
                # an empty ring buffer (fresh service, or state restored
                # without its window) must not wipe the stats with zeros
                Sigmas, cs, counts = window_stats(self.window)
                self.state = self.state._replace(Sigmas=Sigmas, cs=cs,
                                                 counts=counts)
            warm = int(self.state.generation) > 0
            if self._refit_failures == 0:
                l_iters = self.warm_lasso_iters if warm else self.lasso_iters
                d_iters = self.warm_debias_iters if warm \
                    else self.debias_iters
            else:
                # retry after rollback: escalated budget, warm-started
                # from the last GOOD generation (the rejected candidate
                # never touched the state)
                esc = min(2 ** self._refit_failures, MAX_ITER_ESCALATION)
                l_iters = self.lasso_iters * esc
                d_iters = self.debias_iters * esc
            candidate, info = self._refit_impl(
                self.state, self.lam, self.mu, self.Lam,
                lasso_iters=l_iters, debias_iters=d_iters, warm=warm,
                tol=self.refit_tol, use_kernel=self.use_kernel,
                mesh=self.mesh, axis=self.task_axis)
            if self.refit_health_checks:
                health = refit_health(candidate, self.lam,
                                      kkt_ceiling=self.refit_kkt_ceiling,
                                      max_support=self.max_support,
                                      use_kernel=self.use_kernel,
                                      mesh=self.mesh)
            else:
                health = RefitHealth(True, None, float("nan"), -1)
            self.last_health = health
            if not health.healthy:
                return self._rollback(health)
            # adoption = two atomic reference swaps: the live state for
            # the ingest loop, then the published snapshot for readers.
            # A concurrent predict holds whichever snapshot it grabbed —
            # entirely old or entirely new, never a mixture.
            self.state = candidate
            self.publish_model()
            drift = 1.0 - float(info.jaccard)
            if warm and self._refit_failures == 0 \
                    and drift <= self.drift_threshold:
                self._interval = min(2 * self._interval,
                                     self.max_refit_interval)
            else:
                self._interval = self.refit_every
            self._refit_failures = 0
        obs.inc("stream.refit.count")
        obs.observe("stream.refit.jaccard", float(info.jaccard))
        obs.observe("stream.refit.support_size", float(info.support_size))
        obs.observe("stream.refit.kkt_residual", health.kkt_residual)
        if info.lasso_iters_run is not None:
            obs.observe("stream.refit.lasso_iters", int(info.lasso_iters_run))
            obs.observe("stream.refit.debias_iters",
                        int(info.debias_iters_run))
        obs.set_gauge("stream.generation", int(info.generation))
        obs.set_gauge("stream.refit.interval_samples", self._interval)
        obs.set_gauge("stream.refit.failures", 0)
        self._since_refit = 0
        self.last_info = info
        if self.ckpt_store is not None and self.checkpoint_on_refit:
            self.checkpoint()
        return info

    def _rollback(self, health: RefitHealth) -> RefitInfo:
        """Discard an unhealthy candidate; keep serving the last good
        generation and schedule the escalated retry."""
        self._refit_failures += 1
        self.rollbacks += 1
        self._interval = min(self.refit_every * 2 ** self._refit_failures,
                             self.max_refit_interval)
        self._since_refit = 0
        obs.inc("stream.refit.rejected", reason=health.reason)
        obs.set_gauge("stream.refit.failures", self._refit_failures)
        obs.set_gauge("stream.refit.interval_samples", self._interval)
        info = RefitInfo(
            jaccard=torch.ones((), dtype=self.state.cs.dtype,
                               device=self.device),
            support_size=torch.sum(self.state.support).to(torch.int32),
            generation=self.state.generation)
        self.last_info = info
        return info

    # -- serving ----------------------------------------------------------

    def publish_model(self) -> ModelGeneration:
        """Snapshot the current model into a fresh `ModelGeneration` and
        install it as the published snapshot (one reference assignment —
        atomic under the GIL). Called automatically at every site where
        the model can change (adoption, load/restore, construction);
        code that mutates `state` directly must call it afterwards."""
        st = self.state  # ONE read: the snapshot's fields stay coherent
        snap = ModelGeneration(beta_tilde=st.beta_tilde,
                               support=st.support,
                               generation=int(st.generation))
        self._serving = snap
        return snap

    def serving(self) -> ModelGeneration:
        """The published model, as one immutable snapshot. Hold it for
        as long as a unit of work needs model coherence (a predict
        call, a serving-front microbatch): refits adopting a new
        generation swap the reference under you without ever mutating
        the snapshot you hold."""
        return self._serving

    def _normalize_predict_input(self, X):
        """The predict input contract, enforced in one place.

        (p,)       one shared-design row       -> (1, p), shared
        (n, p)     shared design, n rows       -> unchanged, shared
        (m, n, p)  per-task designs            -> unchanged, per-task

        Returns `(X, shared)`. Anything else — wrong feature count,
        wrong task count, other ranks — raises instead of silently
        broadcasting. The input moves to the service's device as its
        dtype."""
        X = self._on_device(X)
        if X.ndim == 1:
            if X.shape[0] != self.p:
                raise ValueError(f"rank-1 predict input must be one "
                                 f"({self.p},) row; got {tuple(X.shape)}")
            return X.reshape(1, self.p), True
        if X.ndim == 2:
            if X.shape[1] != self.p:
                raise ValueError(f"shared design must be (n, {self.p}); "
                                 f"got {tuple(X.shape)}")
            return X, True
        if X.ndim == 3:
            if X.shape[0] != self.m_local or X.shape[2] != self.p:
                raise ValueError(f"per-task designs must be "
                                 f"({self.m_local}, n, {self.p}); got "
                                 f"{tuple(X.shape)}")
            return X, False
        raise ValueError(f"predict input must be rank 1, 2, or 3; "
                         f"got rank {X.ndim} {tuple(X.shape)}")

    def predict(self, X, *, return_generation: bool = False) -> torch.Tensor:
        """Scores under the published model.

        X (m, n, p) gives per-task designs -> (m, n); X (n, p) is one
        shared design scored by every task's estimate -> (m, n); a
        single row (p,) is scored as a 1-row shared design -> (m, 1).

        Each call captures ONE `ModelGeneration` snapshot and scores
        the whole input against it — a refit adopting (or rolling
        back) mid-call cannot tear the model out from under the
        einsum. `return_generation=True` also returns the generation
        that scored, so callers can prove which model answered.

        The `stream.predict` span times the host-side issue (on the
        card the product is asynchronous), which is the admission
        latency a serving front would see.
        """
        X, shared = self._normalize_predict_input(X)
        snap = self.serving()
        with obs.span("stream.predict"):
            if shared:
                out = _predict_shared(snap.beta_tilde, X)
            else:
                out = _predict_tasks(snap.beta_tilde, X)
        obs.inc("stream.predict.requests")
        obs.inc("stream.predict.rows", int(X.shape[-2]))
        return (out, snap.generation) if return_generation else out

    @property
    def generation(self) -> int:
        return int(self.state.generation)

    @property
    def samples_seen(self) -> float:
        """Effective per-task sample count (decayed if decay < 1)."""
        return float(torch.max(self.state.counts))

    # -- persistence ------------------------------------------------------

    def _ckpt_tree(self):
        # window mode keeps the authoritative statistics in the ring
        # buffer, so it must round-trip alongside the state
        if self.window is not None:
            return {"state": self.state, "window": self.window}
        return {"state": self.state}

    def save(self, path: str) -> None:
        """Atomic single-file snapshot (tmp + fsync + rename); see
        `checkpoint()` for the retained-generation store."""
        save_pytree(path, self._ckpt_tree())

    def _validate_ckpt_compat(self, data, where: str) -> None:
        """Reject a checkpoint that was not produced by a service of
        this (m, p, dtype) BEFORE any live state is overwritten."""
        key = "state/Sigmas"
        if key not in data.files:
            raise CheckpointError(
                f"{where} is not a StreamingDsmlService checkpoint "
                f"(no '{key}' leaf; found e.g. {list(data.files)[:3]})")
        arr = data[key]
        want = (self.m_local, self.p, self.p)
        if arr.shape != want:
            raise CheckpointError(
                f"{where} was saved by an incompatible service: "
                f"state/Sigmas shape {arr.shape} != {want} "
                f"(m={self.m}, p={self.p})")
        exp = npz_safe_dtype(self.dtype)
        if arr.dtype != exp:
            raise CheckpointError(
                f"{where} dtype {arr.dtype} != this service's {exp}")

    def load(self, path: str) -> None:
        """Restore a checkpointed state. The checkpoint's (m, p, dtype)
        and window-ness are validated against this service BEFORE live
        state is overwritten, so a wrong-path load cannot clobber a
        serving model. Loading a window-mode checkpoint into a
        non-window service (or vice versa) raises rather than silently
        changing the forgetting semantics."""
        fname = path if path.endswith(".npz") else path + ".npz"
        with load_npz(fname) as data:
            has_window = any(k.startswith("window/") for k in data.files)
            if self.window is None and has_window:
                raise ValueError(
                    "checkpoint was saved by a window-mode service; "
                    "construct with window= to restore it")
            if self.window is not None and not has_window:
                raise ValueError(
                    "checkpoint was saved by a non-window service; its "
                    "ring buffer is absent — construct without window= "
                    "to restore it")
            self._validate_ckpt_compat(data, f"checkpoint '{fname}'")
        restored = restore_pytree(path, self._ckpt_tree())
        self.state = restored["state"]
        if self.window is not None:
            self.window = restored["window"]
        self._since_refit = 0
        self._refit_failures = 0
        self.publish_model()

    def checkpoint(self) -> Optional[str]:
        """Persist the current generation to the crash-safe store
        (requires `ckpt_dir=`). Returns the payload path."""
        if self.ckpt_store is None:
            raise ValueError("no ckpt_dir configured on this service")
        path = self.ckpt_store.save(self._ckpt_tree(), self.generation)
        return path

    def restore(self) -> int:
        """Load the newest HEALTHY retained generation from the store,
        falling back past corrupted checkpoints (requires `ckpt_dir=`).
        Returns the restored generation."""
        if self.ckpt_store is None:
            raise ValueError("no ckpt_dir configured on this service")
        tree, generation = self.ckpt_store.load(self._ckpt_tree())
        self.state = tree["state"]
        if self.window is not None:
            self.window = tree["window"]
        self._since_refit = 0
        self._refit_failures = 0
        self.publish_model()
        obs.set_gauge("stream.generation", self.generation)
        return generation
