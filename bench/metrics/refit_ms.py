"""Mean of the stream service's `stream.refit` span over the window. The
span ends after the health check reads the candidate's residual back to
the host (`stream/health.py`: `stats.tolist()`), so it holds the refit's
device work."""


def read(w):
    s = w.spans.get("stream.refit.ms")
    return s["mean"] if s else None
