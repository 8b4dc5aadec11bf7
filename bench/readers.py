"""The bodies that several per-layer metrics share: each metric's file in
`bench/metrics/` names its own quantity and cells and reads it with one
of these."""
from __future__ import annotations

from bench import roofline


def idle_share(w):
    """The share of the traced window in which no kernel, copy or fill ran
    on the card (averaged over the cards of a many-card cell)."""
    if w.trace is None or w.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - w.trace.busy_s / w.trace.window_s)


def sgemm_roofline(w):
    """The debias solve's r = p FISTA step (#1b, `fista_gemm_kernel`) as a
    share of its roofline: the steps that ran, each at its bound
    (`roofline.gemm_step_*`, f32-accurate products at 165 TFLOP/s), over
    the kernel's device time in the traced window."""
    if w.trace is None or "gemm_bound_s" not in w.work:
        return None
    t = w.trace.kernel_s("fista_gemm_kernel")
    return 100.0 * w.work["gemm_bound_s"] / t if t > 0 else None


def mfu(w):
    """The window's algorithmic FLOPs (`work["flops"]`, from `roofline`)
    over the window times the f32-accurate peak, 165 TFLOP/s, per card."""
    if w.seconds <= 0 or not w.work.get("flops"):
        return None
    return 100.0 * w.work["flops"] / (w.seconds * roofline.F32_ACCURATE)
