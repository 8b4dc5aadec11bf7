"""Kernel launches a call, from the port's `LAUNCHES` counts over the
window (DSML engine: `core/engine.py`, `core/dsml.py`)."""


def read(w):
    if not w.calls or not w.launches:
        return None
    return sum(w.launches.values()) / w.calls
