"""Mean of the serving front's `serve.batch` span over the window: the
copy in, the product and the copy of the scores back to the host
(`stream/serve.py`), which waits for the kernels queued before it."""


def read(w):
    s = w.spans.get("serve.batch.ms")
    return s["mean"] if s else None
