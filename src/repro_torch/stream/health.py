"""Post-refit invariant checks: is a refreshed model fit to serve?

The port's counterpart of the JAX package's `repro/stream/health.py`.
A refit that diverged — a warm start gone stale after a regime shift,
an escalated lambda interacting badly with a short iteration budget —
must never silently replace a good `beta_tilde`. `refit_health` runs
three invariants on a *candidate* state before the service adopts it:

* **finiteness** — `beta_local`, `Ms`, `beta_u`, `beta_tilde` all
  finite (a single NaN anywhere condemns the candidate);
* **support sanity** — `|S_hat| <= max_support` when a ceiling is
  configured (a full support on a sparse workload is a classic
  divergence signature);
* **KKT residual** — the engine's own prox-gradient fixed-point
  residual (the quantity `tol=`/`return_iters` early exit checks,
  here evaluated once post-hoc in the eq.-2 convention `refit` solves
  under) must sit under a ceiling. A NaN residual fails the check
  (the comparison is `not (kkt <= ceiling)`), so divergence cannot
  hide behind NaN-poisoned comparisons.

The residual's prox-gradient step is one `ista_step_batched` call: on
CUDA tensors one launch of the ISTA step kernel at r = 1. The three
statistics come back to the host in one read. On a sharded service
(`mesh=`) each rank judges its own tasks, and the verdict is the max
over the mesh (one `pmax` per mesh dim, before the read), so every rank
reaches the same one.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.engine import power_iteration_batched
from repro_torch.kernels.ista_step.ops import ista_step_batched
from repro_torch.stream.state import StreamState
from repro_torch.substrate.collectives import pmax


class RefitHealth(NamedTuple):
    healthy: bool
    reason: Optional[str]    # None | "nonfinite_model" | "support_size"
                             # | "kkt_residual"
    kkt_residual: float      # prox-gradient residual of beta_local
    support_size: int        # |S_hat| of the candidate


def _model_health(candidate: StreamState, lam,
                  use_kernel: bool | None) -> torch.Tensor:
    """[all_finite, kkt_residual, support_size] as a (3,) f32.

    The residual replicates `solve_lasso_eq2`'s convention: step sizes
    2/max(2*lam_max, eps) and threshold weight lam/2, so a candidate
    that satisfies the eq.-2 optimality condition has residual ~0
    regardless of how many iterations the refit actually ran.
    """
    c = candidate
    finite = (torch.isfinite(c.beta_local).all()
              & torch.isfinite(c.Ms).all()
              & torch.isfinite(c.beta_u).all()
              & torch.isfinite(c.beta_tilde).all())
    lam_max = power_iteration_batched(c.Sigmas)
    etas = 2.0 / torch.clamp_min(2.0 * lam_max, 1e-12)
    B = torch.nan_to_num(c.beta_local)
    B_fp = ista_step_batched(c.Sigmas, B, c.cs, etas, 0.5 * lam,
                             use_kernel=use_kernel)
    kkt = torch.max(torch.abs(B_fp - B))
    return torch.stack([finite.to(torch.float32), kkt.to(torch.float32),
                        torch.sum(c.support).to(torch.float32)])


def refit_health(candidate: StreamState, lam, *,
                 kkt_ceiling: float = 1.0,
                 max_support: Optional[int] = None,
                 use_kernel: bool | None = None,
                 mesh=None) -> RefitHealth:
    """Judge a candidate refit against the serve-fitness invariants.

    `kkt_ceiling` bounds the eq.-2 prox-gradient residual of the
    candidate's `beta_local` on the candidate's own statistics: a
    converged-ish refit on standardized traffic sits orders of
    magnitude below 1.0, while a diverged one is non-finite or huge.
    `max_support=None` disables the support ceiling. `use_kernel` as in
    `kernels/common.py`. With `mesh` (a `DeviceMesh`) the candidate is
    this rank's tasks and the statistics are taken over every rank of
    the mesh: all finite, the largest residual (a NaN one counts as
    infinite), the support size (replicated).
    """
    stats = _model_health(candidate, lam, use_kernel)
    if mesh is not None:
        # as maxima: [not finite, residual, support size]
        flags = torch.stack([1.0 - stats[0],
                             torch.nan_to_num(stats[1], nan=float("inf")),
                             stats[2]])
        for axis in mesh.mesh_dim_names:
            flags = pmax(flags, mesh, axis)
        stats = torch.stack([1.0 - flags[0], flags[1], flags[2]])
    finite, kkt, support_size = stats.tolist()
    finite, support_size = bool(finite), int(support_size)
    if not finite:
        return RefitHealth(False, "nonfinite_model", kkt, support_size)
    if max_support is not None and support_size > max_support:
        return RefitHealth(False, "support_size", kkt, support_size)
    if not (kkt <= kkt_ceiling):     # NaN residual must fail, not pass
        return RefitHealth(False, "kkt_residual", kkt, support_size)
    return RefitHealth(True, None, kkt, support_size)
