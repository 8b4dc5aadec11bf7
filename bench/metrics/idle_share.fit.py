"""The device idle share of the closed-loop calls' cells."""
from bench.readers import idle_share as read  # noqa: F401
