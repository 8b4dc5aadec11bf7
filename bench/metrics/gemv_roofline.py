"""The lasso's r = 1 FISTA step (#1a, `fista_gemv_kernel`) as a share of
its roofline: each step reads the problem's distinct Sigma once at
3.35 TB/s (`roofline.gemv_step_bytes`, `grid_step_bytes`), over the
kernel's device time in the traced window."""


def read(w):
    if w.trace is None or "gemv_bound_s" not in w.work:
        return None
    t = w.trace.kernel_s("fista_gemv_kernel")
    return 100.0 * w.work["gemv_bound_s"] / t if t > 0 else None
