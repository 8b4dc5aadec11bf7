"""Device ms a training step charged to the `model.ssd` span (the
Mamba-2 mixers, in the forward and in remat's recompute)."""


def read(w):
    t = w.spans.get("device_s", {}).get("model.ssd")
    return t / w.calls * 1e3 if t and w.calls else None
