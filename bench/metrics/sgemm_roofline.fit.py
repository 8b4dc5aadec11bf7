"""#1b's share of its roofline in the fits: the steps the calls asked
for (600 a fit)."""
from bench.readers import sgemm_roofline as read  # noqa: F401
