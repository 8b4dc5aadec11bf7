"""Device ms a training step charged to the `model.moe` span (the held
experts' routing, grouped products and combine, in the forward and in
remat's recompute), through `torchprof.charge`'s join of the trace to
the program's spans."""


def read(w):
    t = w.spans.get("device_s", {}).get("model.moe")
    return t / w.calls * 1e3 if t and w.calls else None
