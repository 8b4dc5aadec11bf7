"""The whole service's share of the card's f32-accurate peak: the FLOPs
that ran in the window (each chunk's rank-n update, the refits' solve
steps, the front's products)."""
from bench.readers import mfu as read  # noqa: F401
