"""Operations, bytes and peaks: the yardstick of every share in `metrics/`.

Counts are what the algorithm needs for the call's shapes and iteration
counts, not what a kernel happens to do: each input byte is read once
and each output byte written once, a symmetric product counts its
triangle, and elementwise work beside a product is left out. A faster
design of the same call therefore reads a higher share of the same
ceiling and never more than all of it.

Peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W limit):

* `F32_ACCURATE` = 495 / 3 TFLOP/s. A float32 product as accurate as
  float32 can be taken on the CUDA cores (FP32 FMA, 67 TFLOP/s) or on
  the tensor cores as three TF32 products on a hi/lo split (495 / 3);
  the port's f32 flash kernel does the latter, as does SDPA's f32
  kernel. The ceiling of f32-accurate work is the faster of the two
  designs, so that a CUDA-core kernel and a tensor-core kernel of the
  same product are held to the same roofline and neither can read over
  100 %.
* `BF16` = 989 TFLOP/s, for bfloat16 products.
* `HBM` = 3.35 TB/s.
* `FP32_FMA` = 67 TFLOP/s is printed beside the f32 shares on an
  earlier line and never reported as a metric.
"""
from __future__ import annotations

F32_ACCURATE = 495e12 / 3
FP32_FMA = 67e12
BF16 = 989e12
HBM = 3.35e12
F32 = 4  # bytes


# ---- the kernels ---------------------------------------------------------

def gemm_step_flops(m: int, p: int, r: int) -> float:
    """#1b, one FISTA step at r > 1: Sigma_t (p, p) @ Z_t (p, r), m tasks."""
    return 2.0 * m * p * p * r


def gemm_step_bytes(m: int, p: int, r: int) -> float:
    """#1b: Sigma, Z, X and C read, X' and Z' written."""
    return F32 * m * (p * p + 4 * p * r)


def gemv_step_flops(m: int, p: int) -> float:
    """#1a, one FISTA step at r = 1."""
    return 2.0 * m * p * p


def gemv_step_bytes(m: int, p: int) -> float:
    """#1a: each task's Sigma read once; the vectors beside it."""
    return F32 * m * (p * p + 5 * p)


def rank_update_flops(m: int, n: int, p: int) -> float:
    """#4: Sigma = X'X / n as a symmetric rank-n update (its triangle),
    and c = X'y / n."""
    return m * n * p * (p + 1) + 2.0 * m * n * p


def rank_update_bytes(m: int, n: int, p: int) -> float:
    """#4: X and y read, Sigma and c written."""
    return F32 * m * (n * p + n + p * p + p)


def bound_s(flops: float, nbytes: float, peak: float = F32_ACCURATE) -> float:
    """The least time the card could take: the larger of the two."""
    return max(flops / peak, nbytes / HBM)


# ---- the calls -----------------------------------------------------------

def fit_flops(m: int, n: int, p: int, lasso_iters: int,
              debias_iters: int) -> float:
    """`dsml_fit`: one rank-n update, the lasso's GEMV steps and the
    debias solve's r = p GEMM steps (the power iteration, the debias
    product and the threshold, under 0.02 % of it, are left out)."""
    return (rank_update_flops(m, n, p) + lasso_iters * gemv_step_flops(m, p)
            + debias_iters * gemm_step_flops(m, p, p))


def grid_flops(m: int, n: int, p: int, k: int, iters: int) -> float:
    """`sufficient_stats` then `solve_lasso_eq2_grid` over k values of
    lambda: k * m problems, each GEMV step over its task's Sigma."""
    return rank_update_flops(m, n, p) + iters * gemv_step_flops(k * m, p)


def grid_step_bytes(m: int, p: int, k: int) -> float:
    """One step of the grid reads the m distinct Sigma once (the k values
    of lambda share them) and k * m vectors."""
    return F32 * (m * p * p + 5 * k * m * p)


def refit_flops(m: int, p: int, lasso_iters: int, debias_iters: int) -> float:
    """One stream refit: the iterations that ran of both solves."""
    return lasso_iters * gemv_step_flops(m, p) \
        + debias_iters * gemm_step_flops(m, p, p)


def predict_flops(m: int, p: int, rows: int) -> float:
    """The front's product: rows scored by every task."""
    return 2.0 * m * p * rows
