"""Rank 0's device time a fit in NCCL's all-gather kernel (the paper's
one round, `substrate/collectives.py`), which holds its wait for the
slowest rank."""


def read(w):
    if w.trace is None or not w.calls:
        return None
    t = w.trace.kernel_s("AllGather")
    return t / w.calls * 1e3 if t > 0 else None
