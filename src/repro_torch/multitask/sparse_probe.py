"""DSML as a framework feature: distributed multi-task sparse probing on
frozen backbone features.

The port's counterpart of the JAX package's `repro/multitask/sparse_probe.py`.
Each task (one per machine / data-parallel group) owns its own labelled
data; features come from any zoo backbone's `forward_features` (dense,
MoE, hybrid, SSM, enc-dec or VLM). Tasks run the paper's Algorithm 1 on (features,
targets): local lasso -> debias -> ONE all-gather of the debiased
d-vector -> group hard threshold -> filter. The result is a set of
per-task linear heads that share a common sparse support over the
backbone's feature dimensions — exactly the paper's estimator with
X_t = pooled features. On CUDA tensors the fit runs the `rank_update`
and FISTA kernels, the features the model stack's.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.dsml import dsml_fit, dsml_fit_sharded
from repro_torch.core.engine import solve_lasso_eq2_grid, sufficient_stats
from repro_torch.core.prox import support_from_rows
from repro_torch.models import Batch, forward_features
from repro_torch.models.config import ModelConfig


class ProbeData(NamedTuple):
    features: torch.Tensor    # (m, n, d) pooled features per task
    targets: torch.Tensor     # (m, n) regression targets


def pool_features(params, cfg: ModelConfig, tokens: torch.Tensor,
                  frontend: Optional[torch.Tensor] = None, *,
                  use_kernel: bool | None = None) -> torch.Tensor:
    """Mean-pooled final hidden state per sequence, in float32.
    tokens: (n, S) -> (n, d)."""
    feats = forward_features(params, cfg, Batch(tokens=tokens,
                                                frontend=frontend),
                             use_kernel=use_kernel)
    return torch.mean(feats.to(torch.float32), dim=1)


def standardize(X: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-task z-scores over the samples (dim -2), population std."""
    mu = torch.mean(X, dim=-2, keepdim=True)
    sd = torch.std(X, dim=-2, correction=0, keepdim=True) + eps
    return (X - mu) / sd


def default_threshold(beta_u: torch.Tensor) -> float:
    """The default Λ of `sparse_probe_fit` for debiased rows (m, d) of
    every task: the largest multiplicative gap in the sorted row norms
    separates signal rows from the noise bulk. The reference's
    arithmetic, step for step, in f32."""
    d = beta_u.shape[1]
    norms = torch.linalg.vector_norm(beta_u.T, dim=-1)
    top = torch.flip(torch.sort(norms).values, dims=(0,))[: max(8, d // 8)]
    ratios = top[:-1] / torch.clamp_min(top[1:], 1e-12)
    k = int(torch.argmax(ratios))
    return float(torch.sqrt(top[k] * torch.clamp_min(top[k + 1], 1e-12)))


def sparse_probe_fit(data: ProbeData, *, lam: Optional[float] = None,
                     mu: Optional[float] = None, Lam: Optional[float] = None,
                     mesh=None, axis: str = "task",
                     lasso_iters: int = 400, debias_iters: int = 400,
                     use_kernel: bool | None = None):
    """Fit shared-support per-task probes with DSML (Algorithm 1).

    data.features: (m, n, d) — standardized internally. With `mesh` (a
    `DeviceMesh` with a dim `axis`, or a process group) the fit runs
    sharded, every rank calling with ITS tasks' data, with the paper's
    one-round communication, and returns a `ShardedDsmlResult` (this
    rank's rows); otherwise the single-host `dsml_fit`'s `DsmlResult`.
    The default threshold reads the debiased rows of every task — on the
    sharded path the rows the fit's one all-gather brought, so it needs
    no second round. `use_kernel` as in `kernels/common.py`.
    """
    m, n, d = data.features.shape
    X = standardize(data.features)
    # the reference computes this in f32: jnp.sqrt(jnp.log(float(d)) / n)
    base = float(torch.sqrt(torch.log(torch.tensor(float(d))) / n))
    lam = 4.0 * base if lam is None else lam
    mu = base if mu is None else mu
    if mesh is not None:
        res = dsml_fit_sharded(X, data.targets, lam, mu, Lam or 0.0, mesh,
                               axis=axis, lasso_iters=lasso_iters,
                               debias_iters=debias_iters,
                               use_kernel=use_kernel)
        B_all = res.beta_u_all
    else:
        res = dsml_fit(X, data.targets, lam, mu, Lam or 0.0,
                       lasso_iters=lasso_iters, debias_iters=debias_iters,
                       use_kernel=use_kernel)
        B_all = res.beta_u
    if Lam is None:
        Lam = default_threshold(B_all)
        support = support_from_rows(B_all.T, Lam)
        res = res._replace(beta_tilde=res.beta_u * support[None, :],
                           support=support)
    return res


def probe_predict(res, features: torch.Tensor) -> torch.Tensor:
    """features: (m, n, d) -> predictions (m, n), with the rows of `res`
    (a rank's own on a sharded result)."""
    X = standardize(features)
    return torch.einsum("tnd,td->tn", X, res.beta_tilde)


def lasso_probe_sweep(data: ProbeData, lams, *, iters: int = 400,
                      use_kernel: bool | None = None) -> torch.Tensor:
    """Per-task lasso heads for a whole grid of lambdas at once.

    Computes sufficient statistics once, then solves the |lams| x m
    problems as ONE batched engine call (Sigmas tiled across the grid).
    Returns (len(lams), m, d).
    """
    X = standardize(data.features)
    Sigmas, cs = sufficient_stats(X, data.targets, use_kernel=use_kernel)
    return solve_lasso_eq2_grid(Sigmas, cs, lams, iters=iters,
                                use_kernel=use_kernel)


def synthetic_probe_tasks(gen: torch.Generator, params, cfg: ModelConfig, *,
                          m: int = 4, n: int = 64, seq: int = 16,
                          s_active: int = 8,
                          use_kernel: bool | None = None
                          ) -> tuple[ProbeData, torch.Tensor]:
    """Build a multi-task probing problem on REAL backbone features:
    random token sequences per task, targets = sparse linear functional
    (shared support, per-task coefficients) of the pooled features +
    noise. Draws from `gen`, on its device (the parameters' device)."""
    dev = gen.device
    d = cfg.d_model
    tokens = torch.randint(0, cfg.vocab, (m, n, seq), generator=gen,
                           device=dev, dtype=torch.int32)
    feats = torch.stack([pool_features(params, cfg, t, use_kernel=use_kernel)
                         for t in tokens])
    Xs = standardize(feats)
    perm = torch.randperm(d, generator=gen, device=dev)
    support = torch.zeros(d, dtype=torch.bool, device=dev)
    support[perm[:s_active]] = True
    coef = torch.randn((m, d), generator=gen, device=dev) * support[None, :]
    noise = 0.1 * torch.randn((m, n), generator=gen, device=dev)
    targets = torch.einsum("tnd,td->tn", Xs, coef) + noise
    return ProbeData(features=feats, targets=targets), support

