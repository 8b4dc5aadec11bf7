"""Inputs of every cell, made on the device from the run's seed.

The design is the paper's simulation model (Section 5): rows of X_t are
N(0, Sigma) with Sigma_ab = rho^|a-b| (an AR(rho) process along the
features), the tasks share one support of size s, the nonzero
coefficients are uniform in [signal_low, signal_high], and
y_t = X_t beta_t + sigma eps. The AR rows come from the process's closed-form
Cholesky factor (x_0 = z_0, x_j = rho x_(j-1) + sqrt(1 - rho^2) z_j), so
a design is one product Z @ L'. Every draw comes from one
`torch.Generator` on the device, in a few large calls, in the order the
functions are called, so a seed gives the same inputs on every run.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Regression(NamedTuple):
    Xs: torch.Tensor        # (m, n, p)
    ys: torch.Tensor        # (m, n)
    B: torch.Tensor         # (m, p) true coefficients
    support: torch.Tensor   # (p,) bool


def generator(seed: int, device) -> torch.Generator:
    """The run's generator: any whole number is taken modulo 2^63."""
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def ar_factor(p: int, rho: float, device) -> torch.Tensor:
    """Lower-triangular L with L L' = (rho^|a-b|)_ab, float32."""
    idx = torch.arange(p, device=device, dtype=torch.float64)
    lag = idx[:, None] - idx[None, :]
    L = torch.where(lag >= 0, rho ** torch.clamp_min(lag, 0.0),
                    torch.zeros((), dtype=torch.float64, device=device))
    L[:, 1:] *= np.sqrt(1.0 - rho * rho)
    return L.to(torch.float32)


def design(g: torch.Generator, L: torch.Tensor, *shape: int) -> torch.Tensor:
    """AR rows of shape (*shape, p)."""
    p = L.shape[0]
    Z = torch.randn((*shape, p), generator=g, device=L.device)
    return (Z.reshape(-1, p) @ L.T).reshape(*shape, p)


def coefficients(g: torch.Generator, m: int, p: int, s: int, low: float,
                 high: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Shared-support coefficients B (m, p) and the support (p,)."""
    perm = torch.randperm(p, generator=g, device=device)
    support = torch.zeros(p, dtype=torch.bool, device=device)
    support[perm[:s]] = True
    vals = low + (high - low) * torch.rand((m, p), generator=g, device=device)
    return vals * support, support


def responses(g: torch.Generator, Xs: torch.Tensor, B: torch.Tensor,
              sigma: float) -> torch.Tensor:
    eps = torch.randn(Xs.shape[:2], generator=g, device=Xs.device)
    return torch.einsum("tnp,tp->tn", Xs, B) + sigma * eps


def regression(g: torch.Generator, cfg: dict, *, m: int | None = None,
               n: int | None = None) -> Regression:
    """One data set of the configuration `cfg` (keys m, n, p, s, rho,
    signal_low, signal_high, sigma); `m`, `n` override its counts."""
    m = cfg["m"] if m is None else m
    n = cfg["n"] if n is None else n
    dev = g.device
    L = ar_factor(cfg["p"], cfg["rho"], dev)
    B, support = coefficients(g, m, cfg["p"], cfg["s"], cfg["signal_low"],
                              cfg["signal_high"], dev)
    Xs = design(g, L, m, n)
    return Regression(Xs, responses(g, Xs, B, cfg["sigma"]), B, support)


def permuted_gaps(seed: int, rate: float, count: int) -> np.ndarray:
    """`count` Poisson inter-arrival gaps (seconds) at `rate`: one fixed
    set of gaps (drawn from seed 0), put in the order the run's seed
    gives, so every seed offers the same load in another order."""
    gaps = np.random.default_rng(0).exponential(1.0 / rate, count)
    return np.random.default_rng(int(seed)).permutation(gaps)
