"""The calls' share of the card's f32-accurate peak: their algorithmic
FLOPs (`roofline.fit_flops`, `grid_flops`) over the window."""
from bench.readers import mfu as read  # noqa: F401
