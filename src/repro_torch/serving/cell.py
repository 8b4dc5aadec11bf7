"""The serving cell measured on the card: one dense configuration at full
width and the request batch it serves.

`chip_smoke.py` (phase 6) gates this cell and `launch/profile_serve.py`
profiles it; both build it here, so they measure the same thing.
"""
from __future__ import annotations

import torch

from repro_torch.configs import get_config
from repro_torch.models import init_params

ARCH = "granite-3-2b"     # the default --arch of launch/serve.py
BATCH = 4
PROMPT = 2048             # S·T = 2048² takes every layer's flash branch
NEW_TOKENS = 16
PARAM_SEED, PROMPT_SEED = 0, 1


def make_cell(device="cuda", **changes):
    """(cfg, params, prompt) of the cell: `get_config(ARCH)` unreduced with
    `changes` applied, random parameters from seed PARAM_SEED and a
    (BATCH, PROMPT) int32 prompt of random ids from seed PROMPT_SEED, all
    on `device`."""
    device = torch.device(device)
    cfg = get_config(ARCH).replace(**changes)
    params = init_params(
        torch.Generator(device=device).manual_seed(PARAM_SEED), cfg)
    prompt = torch.randint(
        0, cfg.vocab, (BATCH, PROMPT), device=device, dtype=torch.int32,
        generator=torch.Generator(device=device).manual_seed(PROMPT_SEED))
    return cfg, params, prompt
