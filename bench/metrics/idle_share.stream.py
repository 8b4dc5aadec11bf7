"""The device idle share of the online service's cell."""
from bench.readers import idle_share as read  # noqa: F401
