"""Plain PyTorch reference of DSML Algorithm 1 (Wang, Kolar and Srebro,
2015) and of the calls the cells time, in float32.

It imports nothing of the measured program and takes nothing it made:
it works out the sufficient statistics, the step sizes, both FISTA
solves, the debias step and the master's threshold again from the raw
(X, y) that the benchmark generated. The solves follow the algorithm as
the program states it: eq. (2)'s lasso with step 1 / lambda_max and
threshold lam / 2, the debias program for every row of M as one
multi-right-hand-side lasso with c = I, step 1 / lambda_max and
threshold mu, FISTA's float32 momentum schedule, lambda_max by 64 power
iterations from the flat unit vector, and the warm starts of a stream
refit.

Products run in full float32 (`precision("f32")`, TF32 off). The
control of every cell is this same code under `precision("tf32")`.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

_HALF, _ONE, _FOUR = np.float32(0.5), np.float32(1.0), np.float32(4.0)


@contextlib.contextmanager
def precision(mode: str):
    """Run the block's float32 products in full float32 ("f32") or in
    TF32 ("tf32", the control)."""
    if mode not in ("f32", "tf32"):
        raise ValueError(f"precision {mode!r}")
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    on = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def momentum(t: np.float32) -> tuple[np.float32, float]:
    t_next = _HALF * (_ONE + np.sqrt(_ONE + _FOUR * t * t))
    return t_next, float((t - _ONE) / t_next)


def stats(Xs: torch.Tensor, ys: torch.Tensor):
    """Sigma_t = X_t'X_t / n (m, p, p) and c_t = X_t'y_t / n (m, p)."""
    n = Xs.shape[1]
    Xt = Xs.transpose(1, 2)
    return torch.bmm(Xt, Xs) / n, torch.bmm(Xt, ys[..., None])[..., 0] / n


def lambda_max(S: torch.Tensor, iters: int = 64) -> torch.Tensor:
    """Largest eigenvalue of each Sigma_t by power iteration."""
    p = S.shape[-1]
    v = torch.full(S.shape[:-1], float(_ONE / np.sqrt(np.float32(p))),
                   dtype=S.dtype, device=S.device)
    for _ in range(iters):
        w = torch.bmm(S, v[..., None])[..., 0]
        v = w / torch.clamp_min(torch.linalg.vector_norm(w, dim=-1,
                                                         keepdim=True), 1e-30)
    return torch.sum(v * torch.bmm(S, v[..., None])[..., 0], dim=-1)


def fista(S: torch.Tensor, C: torch.Tensor, eta: torch.Tensor,
          tau: torch.Tensor, iters: int, X0: torch.Tensor | None = None):
    """min_b 1/2 b'S b - c'b + lam |b|_1 for every column of C (m, p, r):
    `iters` FISTA steps of size eta (m,) and threshold tau (m, 1, r) or
    (m, 1, 1), from X0 (zeros by default). A step is the gradient
    S z - C, the move z - eta g, the soft threshold v - clamp(v, -t, t)
    and the momentum x' + theta (x' - x), in six plain calls."""
    eta = eta.reshape(-1, 1, 1)
    thr = eta * tau
    x = torch.zeros_like(C) if X0 is None else X0.clone()
    z, t = x, np.float32(1.0)
    for _ in range(iters):
        t, theta = momentum(t)
        v = torch.addcmul(z, eta, torch.baddbmm(C, S, z, beta=-1.0),
                          value=-1.0)
        x_next = v - torch.clamp(v, -thr, thr)
        z = torch.add(x_next, x_next - x, alpha=theta)
        x = x_next
    return x


def lasso(S, c, lam, lmax, iters, beta0=None):
    """Eq. (2): (1/n)|y - Xb|^2 + lam |b|_1 on the statistics, (m, p)."""
    eta = 2.0 / torch.clamp_min(2.0 * lmax, 1e-12)
    tau = torch.full((S.shape[0], 1, 1), 0.5 * lam, dtype=S.dtype,
                     device=S.device)
    X0 = None if beta0 is None else beta0[..., None]
    return fista(S, c[..., None], eta, tau, iters, X0)[..., 0]


def inverse_hessian(S, mu, lmax, iters, M0=None):
    """The debias matrices M (m, p, p), row j of M_t solving the lasso
    with c = e_j; warm from M0, else from I / diag(Sigma_t)."""
    m, p, _ = S.shape
    eye = torch.eye(p, dtype=S.dtype, device=S.device).expand(m, p, p)
    if M0 is None:
        diag = torch.diagonal(S, dim1=-2, dim2=-1)
        C0 = eye / torch.clamp_min(diag, 1e-12)[:, None, :]
    else:
        C0 = M0.transpose(1, 2)
    eta = 1.0 / torch.clamp_min(lmax, 1e-12)
    tau = torch.full((m, 1, 1), mu, dtype=S.dtype, device=S.device)
    return fista(S, eye.contiguous(), eta, tau, iters, C0).transpose(1, 2)


def debias(S, c, beta, M):
    """Eq. (4): b + M (c - Sigma b)."""
    r = c - torch.bmm(S, beta[..., None])[..., 0]
    return beta + torch.bmm(M, r[..., None])[..., 0]


def threshold(beta_u_all: torch.Tensor, Lam: float) -> torch.Tensor:
    """Eq. (5): the master's support, rows of B whose norm over the
    tasks exceeds Lambda. beta_u_all (m, p) -> (p,) bool."""
    return torch.linalg.vector_norm(beta_u_all, dim=0) > Lam


def local_fit(Xs, ys, lam, mu, lasso_iters, debias_iters) -> dict:
    """Steps 1-2 of Algorithm 1 for the tasks of one worker."""
    S, c = stats(Xs, ys)
    lmax = lambda_max(S)
    beta = lasso(S, c, lam, lmax, lasso_iters)
    M = inverse_hessian(S, mu, lmax, debias_iters)
    return {"beta_local": beta, "beta_u": debias(S, c, beta, M)}


def fit(Xs, ys, lam, mu, Lam, lasso_iters, debias_iters) -> dict:
    """Algorithm 1 on one host: beta_local, beta_u, support, beta_tilde."""
    out = local_fit(Xs, ys, lam, mu, lasso_iters, debias_iters)
    out["support"] = threshold(out["beta_u"], Lam)
    out["beta_tilde"] = out["beta_u"] * out["support"]
    return out


def grid(Xs, ys, lams, iters) -> torch.Tensor:
    """Eq. (2)'s lasso of every task at every lambda of `lams` (k,), 400
    steps from zero: (k, m, p). The k problems of a task share Sigma_t,
    so they are the k columns of one solve."""
    S, c = stats(Xs, ys)
    eta = 2.0 / torch.clamp_min(2.0 * lambda_max(S), 1e-12)
    lams = torch.as_tensor(lams, dtype=S.dtype, device=S.device)
    k = lams.shape[0]
    tau = (0.5 * lams).reshape(1, 1, k)
    C = c[..., None].expand(-1, -1, k).contiguous()
    return fista(S, C, eta, tau, iters).permute(2, 0, 1)


class Stream:
    """The online service's model, generation by generation: the
    statistics are the plain means of every row ingested so far. A refit
    is due once `refit_every` rows a task have come since the last; after
    a warm refit whose support moved by at most `drift_threshold`
    (1 - Jaccard against the previous support) the interval doubles, up
    to `max_refit_interval`, and otherwise it falls back to
    `refit_every`. Generation 0 runs the cold budgets, later ones the
    warm budgets from the previous generation's lasso and M."""

    def __init__(self, m, p, *, lam, mu, Lam, lasso_iters, debias_iters,
                 warm_lasso_iters, warm_debias_iters, refit_every,
                 max_refit_interval, drift_threshold, device):
        self.lam, self.mu, self.Lam = lam, mu, Lam
        self.iters = (lasso_iters, debias_iters)
        self.warm_iters = (warm_lasso_iters, warm_debias_iters)
        self.refit_every, self.max_interval = refit_every, max_refit_interval
        self.drift_threshold = drift_threshold
        self.interval, self.since = refit_every, 0
        self.XtX = torch.zeros((m, p, p), device=device)
        self.Xty = torch.zeros((m, p), device=device)
        self.rows = 0
        self.generation = 0
        self.beta = self.M = None
        self.support = torch.zeros(p, dtype=torch.bool, device=device)

    def ingest(self, Xs, ys) -> dict | None:
        """Fold a chunk in; the new generation's model when a refit was
        due, else None."""
        Xt = Xs.transpose(1, 2)
        self.XtX += torch.bmm(Xt, Xs)
        self.Xty += torch.bmm(Xt, ys[..., None])[..., 0]
        self.rows += Xs.shape[1]
        self.since += Xs.shape[1]
        return self.refit() if self.since >= self.interval else None

    def refit(self) -> dict:
        S, c = self.XtX / self.rows, self.Xty / self.rows
        lmax = lambda_max(S)
        warm = self.beta is not None
        li, di = self.warm_iters if warm else self.iters
        beta = lasso(S, c, self.lam, lmax, li, self.beta)
        M = inverse_hessian(S, self.mu, lmax, di, self.M)
        self.beta, self.M = beta, M
        beta_u = debias(S, c, beta, M)
        support = threshold(beta_u, self.Lam)
        inter = torch.sum(support & self.support)
        union = torch.sum(support | self.support)
        jac = float(inter / torch.clamp_min(union, 1)) if int(union) else 1.0
        if warm and 1.0 - jac <= self.drift_threshold:
            self.interval = min(2 * self.interval, self.max_interval)
        else:
            self.interval = self.refit_every
        self.since, self.support = 0, support
        self.generation += 1
        return {"beta_tilde": beta_u * support, "support": support,
                "generation": self.generation}


# ---- the comparisons ------------------------------------------------------

def gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|: the widest error of an output as
    a share of its own scale (0 when both are 0)."""
    scale = torch.max(torch.abs(want)).item()
    err = torch.max(torch.abs(got.to(want.dtype) - want)).item()
    if scale == 0.0:
        return 0.0 if err == 0.0 else float("inf")
    return err / scale


def mismatches(got: torch.Tensor, want: torch.Tensor) -> int:
    return int(torch.sum(got.to(torch.bool) != want.to(torch.bool)).item())
