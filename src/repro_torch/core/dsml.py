"""DSML — Distributed debiased Sparse Multi-task Lasso (paper Algorithm 1).

Two implementations of the same algorithm:

  * `dsml_fit`          — single-host.
  * `dsml_fit_sharded`  — one rank per group of tasks on
    `torch.distributed` (a `DeviceMesh` dim named "task", or a process
    group). Each rank plays one worker (or a group of workers); the ONLY
    communication is a single all-gather of the debiased p-vectors of
    its tasks — O(p) per task, exactly the paper's one round. The
    master's group hard threshold is computed replicated (identical on
    every rank), which is equivalent to master + broadcast.

Both run steps 1-2 through the batched sufficient-statistics engine
(core/engine.py): the m local lassos are ONE batched solve, and the m
debias M-matrix estimations are ONE batched multi-RHS solve, each
iteration one launch of the fused FISTA kernel on CUDA tensors.

Spans (`repro_torch.obs`): `dsml.fit` (or `dsml.fit_sharded`, a rank's
worker) holds a whole fit and the engine's phase spans under it;
`dsml.allgather` the one round; `dsml.master` the master step (the
group threshold and the workers' filter or refit).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import obs
from repro_torch.core.engine import (
    debias_batched,
    inverse_hessian_batched,
    power_iteration_batched,
    solve_lasso_eq2,
    sufficient_stats,
)
from repro_torch.core.prox import support_from_rows
from repro_torch.core.solvers import refit_ols_masked_stats
from repro_torch.substrate.collectives import all_gather_tasks


class DsmlResult(NamedTuple):
    beta_tilde: torch.Tensor   # (m, p) final filtered estimates
    beta_u: torch.Tensor       # (m, p) debiased estimates (communicated)
    support: torch.Tensor      # (p,) bool, \hat S(Lambda)
    beta_local: torch.Tensor   # (m, p) local lasso estimates (step 1)


class ShardedDsmlResult(NamedTuple):
    """One rank's share of a sharded fit: its own tasks' rows, the
    replicated support, and the gathered debiased rows of all tasks (what
    the one round moved, the same on every rank)."""
    beta_tilde: torch.Tensor   # (m_local, p) this rank's filtered rows
    beta_u: torch.Tensor       # (m_local, p) this rank's debiased rows
    support: torch.Tensor      # (p,) bool, replicated
    beta_local: torch.Tensor   # (m_local, p) this rank's lasso rows
    beta_u_all: torch.Tensor   # (m, p) every task's debiased rows


def _local_work_stats(Sigmas, cs, lam, mu, lasso_iters, debias_iters, *,
                      use_kernel=None):
    """Steps 1-2 of Algorithm 1 on sufficient statistics, batched over
    the m local tasks. No communication. One shared power iteration
    feeds both solves' step sizes."""
    lam_max = power_iteration_batched(Sigmas)
    beta_hat = solve_lasso_eq2(Sigmas, cs, lam, iters=lasso_iters,
                               lam_max=lam_max, use_kernel=use_kernel)
    Ms = inverse_hessian_batched(Sigmas, mu, iters=debias_iters,
                                 lam_max=lam_max, use_kernel=use_kernel)
    beta_u = debias_batched(Sigmas, cs, beta_hat, Ms)
    return beta_hat, beta_u


def dsml_fit(
    Xs: torch.Tensor,
    ys: torch.Tensor,
    lam,
    mu,
    Lam,
    lasso_iters: int = 400,
    debias_iters: int = 600,
    refit: bool = False,
    *,
    use_kernel: bool | None = None,
) -> DsmlResult:
    """Single-host Algorithm 1. Xs: (m, n, p), ys: (m, n), float32, on
    the device the fit runs on. `use_kernel` as in `kernels/common.py`:
    the CUDA kernels for CUDA tensors by default, `False` for the plain
    PyTorch path on any device."""
    with obs.span("dsml.fit"):
        Sigmas, cs = sufficient_stats(Xs, ys, use_kernel=use_kernel)
        beta_hat, beta_u = _local_work_stats(Sigmas, cs, lam, mu,
                                             lasso_iters, debias_iters,
                                             use_kernel=use_kernel)
        with obs.span("dsml.master"):
            support = support_from_rows(beta_u.T, Lam)    # master: eq. (5)
            if refit:
                # one LU solve per task, as the reference maps it: a
                # batched LU solve hangs in MKL-backed CPU builds of
                # PyTorch (threaded getrf)
                beta_tilde = torch.stack([
                    refit_ols_masked_stats(S, c, support)
                    for S, c in zip(Sigmas, cs)])
            else:
                beta_tilde = beta_u * support[None, :]    # workers: eq. (6)
    return DsmlResult(beta_tilde, beta_u, support, beta_hat)


def dsml_sharded_fn(lam, mu, Lam, mesh, axis: str = "task",
                    lasso_iters: int = 400, debias_iters: int = 600, *,
                    use_kernel: bool | None = None):
    """The rank's SPMD worker as a callable (X_blk, y_blk) ->
    ShardedDsmlResult, exposed apart from `dsml_fit_sharded` as in the
    reference, so probes can wrap and inspect the actual implementation.
    `mesh` is a `DeviceMesh` with a dim `axis`, a process group, or None
    for the default group."""

    def worker(X_blk, y_blk) -> ShardedDsmlResult:
        # X_blk: (m_local, n, p) — the tasks this rank owns
        with obs.span("dsml.fit_sharded"):
            Sigmas, cs = sufficient_stats(X_blk, y_blk,
                                          use_kernel=use_kernel)
            beta_hat, beta_u = _local_work_stats(Sigmas, cs, lam, mu,
                                                 lasso_iters, debias_iters,
                                                 use_kernel=use_kernel)
            # ---- the ONE communication round of Algorithm 1 ----
            with obs.span("dsml.allgather"):
                B_all = all_gather_tasks(beta_u, mesh, axis)  # (m, p)
            # ---- master step, replicated (== master + broadcast) ----
            with obs.span("dsml.master"):
                support = support_from_rows(B_all.T, Lam)
                beta_tilde = beta_u * support[None, :]
        return ShardedDsmlResult(beta_tilde, beta_u, support, beta_hat,
                                 B_all)

    return worker


def dsml_fit_sharded(
    X_local: torch.Tensor,
    y_local: torch.Tensor,
    lam,
    mu,
    Lam,
    mesh=None,
    axis: str = "task",
    lasso_iters: int = 400,
    debias_iters: int = 600,
    *,
    use_kernel: bool | None = None,
) -> ShardedDsmlResult:
    """SPMD DSML, called by every rank of `mesh[axis]` with its own block
    of tasks, X_local (m_local, n, p) and y_local (m_local, n), in rank
    order (rank r owns tasks r*m_local .. (r+1)*m_local - 1).

    Communication: exactly one all-gather of the (m_local, p) debiased
    estimates per rank — O(p) numbers per task, the paper's budget.
    Returns this rank's rows, the replicated support and the gathered
    (m, p) debiased rows. `use_kernel` as in `kernels/common.py`.
    """
    return dsml_sharded_fn(lam, mu, Lam, mesh, axis, lasso_iters,
                           debias_iters, use_kernel=use_kernel)(X_local,
                                                                y_local)
