"""Incremental DSML refresh from streaming sufficient statistics.

The port's counterpart of the JAX package's `repro/stream/refit.py`. A
refit re-runs Algorithm 1's compute (local lasso -> debias ->
group-threshold) on the state's current `(Sigma, c)` — identical math
to `dsml_fit` on the data the state has absorbed, but with both solves
warm-started from the previous solution. Consecutive refits see nearly
identical statistics, so the iterates start at (numerically) the
previous optimum and a fraction of the cold iteration budget reaches
the same tolerance.

On CUDA tensors every FISTA iteration is one launch of the fused step
kernel: the lasso's r = 1 GEMV and the debias solve's r = p SGEMM
(`kernels/ista_step`); `refit_logistic`'s gradient is one launch of
`logistic_grad` and its Hessian one weighted `rank_update`.

`RefitInfo.jaccard` reports support drift against the previous
generation so callers can refit lazily: an unchanged support (jaccard
== 1) means the served model has not moved and the next refit can wait.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.engine import (
    debias_batched, inverse_hessian_batched, power_iteration_batched,
    scaled_identity_m0, solve_lasso_eq2, solve_logistic_lasso_batched,
)
from repro_torch.core.logistic import debias_logistic_batched
from repro_torch.core.prox import support_from_rows
from repro_torch.stream.state import StreamState
from repro_torch.substrate.collectives import all_gather_tasks


class RefitInfo(NamedTuple):
    jaccard: torch.Tensor        # () similarity of new vs previous support
    support_size: torch.Tensor   # () int32 |S_hat| after thresholding
    generation: torch.Tensor     # () int32 generation of the NEW state (host)
    # iterations the two solves actually ran (== the ceilings unless a
    # tol was set); None on paths that never count (e.g. rollback infos)
    lasso_iters_run: int | None = None
    debias_iters_run: int | None = None


def jaccard_support(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a & b| / |a | b|, defined as 1.0 when both supports are empty."""
    inter = torch.sum(a & b)
    union = torch.sum(a | b)
    ratio = inter / torch.clamp_min(union, 1)
    return torch.where(union > 0, ratio, torch.ones_like(ratio))


def _advance(state: StreamState, beta_hat, Ms, beta_u, Lam, mesh=None,
             axis: str = "task"):
    """The master's threshold and the new generation's state and info.
    With `mesh`, `state` holds this rank's tasks, and the threshold reads
    every task's debiased rows: one all-gather over `axis`."""
    B_all = beta_u if mesh is None else all_gather_tasks(beta_u, mesh, axis)
    support = support_from_rows(B_all.T, Lam)
    beta_tilde = beta_u * support[None, :]
    new_state = state._replace(
        beta_local=beta_hat, Ms=Ms, beta_u=beta_u, beta_tilde=beta_tilde,
        support=support, generation=state.generation + 1)
    info = RefitInfo(
        jaccard=jaccard_support(support, state.support).to(state.cs.dtype),
        support_size=torch.sum(support).to(torch.int32),
        generation=new_state.generation)
    return new_state, info


def refit(state: StreamState, lam, mu, Lam, lasso_iters: int = 400,
          debias_iters: int = 600, warm: bool = True, tol=None, *,
          use_kernel: bool | None = None, mesh=None,
          axis: str = "task") -> Tuple[StreamState, RefitInfo]:
    """One DSML refresh on the state's statistics.

    Returns the new state (updated beta/M/support, generation + 1) and
    a `RefitInfo`. With `warm=True` both solves restart from the
    previous generation: the lasso from `beta_local` (an empty state's
    zeros make the first warm refit identical to a cold one) and the
    debias M solve from `Ms` (generation 0 falls back to the engine's
    scaled-identity start: a branch on the host's generation counter,
    which reads nothing from the card).

    `tol=` turns the iteration counts into CEILINGS: both solves early
    exit on their KKT residuals (read back once every 25 iterations),
    so a warm refit under a tol costs only the iterations the
    statistics drift demands. The iterations run come back on the info
    (`lasso_iters_run`/`debias_iters_run`). `use_kernel` as in
    `kernels/common.py`.

    With `mesh` (a `DeviceMesh` with a dim `axis`, or a process group)
    the refit is the sharded fit's on statistics: `state` holds this
    rank's tasks, the solves run on them, and the master's threshold
    reads the rows of every task through one all-gather, so the support
    is global.
    """
    beta0 = state.beta_local if warm else None
    M0 = None
    if warm:
        M0 = state.Ms if int(state.generation) > 0 \
            else scaled_identity_m0(state.Sigmas)
    lam_max = power_iteration_batched(state.Sigmas)
    beta_hat, lasso_run = solve_lasso_eq2(
        state.Sigmas, state.cs, lam, iters=lasso_iters, beta0=beta0,
        lam_max=lam_max, tol=tol, return_iters=True, use_kernel=use_kernel)
    Ms, debias_run = inverse_hessian_batched(
        state.Sigmas, mu, iters=debias_iters, M0=M0, lam_max=lam_max,
        tol=tol, return_iters=True, use_kernel=use_kernel)
    beta_u = debias_batched(state.Sigmas, state.cs, beta_hat, Ms)
    new_state, info = _advance(state, beta_hat, Ms, beta_u, Lam, mesh, axis)
    return new_state, info._replace(lasso_iters_run=lasso_run,
                                    debias_iters_run=debias_run)


def refit_logistic(state: StreamState, Xs: torch.Tensor, ys: torch.Tensor,
                   lam, mu, Lam, lasso_iters: int = 600,
                   debias_iters: int = 600, warm: bool = True, *,
                   use_kernel: bool | None = None
                   ) -> Tuple[StreamState, RefitInfo]:
    """One Section-4 (classification) DSML refresh, warm-started from
    the previous generation exactly like the regression `refit`.

    The logistic loss is not a function of the state's `(Sigma, c)`
    statistics, so the gradient re-touches a retained raw window
    `Xs (m, n, p)` / `ys (m, n) in {-1, +1}` — but the state still
    carries everything that makes consecutive refits cheap: with
    `warm=True` the batched l1-logistic solve restarts from
    `beta_local` and the weighted-Hessian debias solve from the
    previous `Ms` (generation 0 falls back to the engine's
    scaled-identity start). The state's regression statistics fields
    are left untouched; the model fields (`beta_local`, `Ms`,
    `beta_u`, `beta_tilde`, `support`, `generation`) advance one
    generation.
    """
    beta0 = state.beta_local if warm else None
    beta_hat = solve_logistic_lasso_batched(Xs, ys, lam, iters=lasso_iters,
                                            beta0=beta0,
                                            use_kernel=use_kernel)
    beta_u, Ms = debias_logistic_batched(
        Xs, ys, beta_hat, mu, iters=debias_iters,
        M0=state.Ms if warm else None,
        M0_valid=int(state.generation) > 0 if warm else None,
        use_kernel=use_kernel)
    return _advance(state, beta_hat, Ms, beta_u, Lam)
