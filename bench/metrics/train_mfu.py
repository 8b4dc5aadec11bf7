"""The training steps' share of the card's bf16 peak: their model FLOPs
(`roofline_lm.step_flops`, remat's recompute not counted) over the
window times 989 TFLOP/s."""
from bench import roofline


def read(w):
    if w.seconds <= 0 or not w.work.get("flops") \
            or "expert_gemm_bound_s" not in w.work:
        return None
    return 100.0 * w.work["flops"] / (w.seconds * roofline.BF16)
