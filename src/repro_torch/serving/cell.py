"""The serving cell measured on the card: one dense configuration at full
width and the request batch it serves, and the same batch for any other
configuration of the zoo.

`chip_smoke.py` gates this cell (phase 6) and serves the other families
with it (phase 9), and `launch/profile_serve.py` profiles it; all build
it here, so they measure the same thing.
"""
from __future__ import annotations

import torch

from repro_torch.configs import get_config
from repro_torch.models import init_params

ARCH = "granite-3-2b"     # the default --arch of launch/serve.py
BATCH = 4
PROMPT = 2048             # S·T = 2048² takes every layer's flash branch
NEW_TOKENS = 16
PARAM_SEED, PROMPT_SEED, FRONTEND_SEED = 0, 1, 2


def make_cell(device="cuda", arch: str = ARCH, **changes):
    """(cfg, params, prompt) of the cell: `get_config(arch)` unreduced with
    `changes` applied, random parameters from seed PARAM_SEED and a
    (BATCH, PROMPT) int32 prompt of random ids from seed PROMPT_SEED, all
    on `device`."""
    device = torch.device(device)
    cfg = get_config(arch).replace(**changes)
    params = init_params(
        torch.Generator(device=device).manual_seed(PARAM_SEED), cfg)
    return cfg, params, make_prompt(cfg, device)


def make_prompt(cfg, device="cuda", batch: int = BATCH) -> torch.Tensor:
    """The first `batch` rows of the cell's (BATCH, PROMPT) int32 prompt
    of random ids below `cfg.vocab` from seed PROMPT_SEED, on
    `device`."""
    device = torch.device(device)
    prompt = torch.randint(
        0, cfg.vocab, (BATCH, PROMPT), device=device, dtype=torch.int32,
        generator=torch.Generator(device=device).manual_seed(PROMPT_SEED))
    return prompt[:batch].contiguous()


def make_frontend(cfg, device="cuda", batch: int | None = None):
    """The stub modality input of an enc-dec or VLM configuration for
    `batch` requests (the cell's BATCH by default; 0.1 · N(0, 1) audio
    frames or vision patches, which `launch/serve.py` serves too) from
    seed FRONTEND_SEED, or None."""
    if not cfg.frontend:
        return None
    device = torch.device(device)
    return 0.1 * torch.randn(
        (BATCH if batch is None else batch, cfg.n_frontend_tokens, cfg.d_model), device=device,
        generator=torch.Generator(device=device).manual_seed(FRONTEND_SEED))
