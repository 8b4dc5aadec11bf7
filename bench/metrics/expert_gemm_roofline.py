"""The held experts' grouped products (`models/moe.py::grouped_mm`, one
`torch.mm` a group, in the forward, remat's recompute and the backward)
as a share of their roofline: their FLOPs at 989 TFLOP/s or their bytes
at 3.35 TB/s, whichever bounds (`roofline_lm.grouped_products`), over
the device time charged to the span `model.moe.experts` that the
products' forward and backward open."""


def read(w):
    if "expert_gemm_bound_s" not in w.work:
        return None
    t = w.spans.get("device_s", {}).get("model.moe.experts")
    return 100.0 * w.work["expert_gemm_bound_s"] / t if t else None
