"""#1b's share of its roofline in the stream's refits: the steps that
ran (`stream.refit.debias_iters`)."""
from bench.readers import sgemm_roofline as read  # noqa: F401
