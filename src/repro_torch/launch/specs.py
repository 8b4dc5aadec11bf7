"""Abstract inputs for every (arch x shape) combination, on the `meta`
device.

The port of the JAX package's `launch/specs.py`. There the shapes come
from `jax.eval_shape` over the real initialisers; here the real
initialisers run on the `meta` device, which gives every tensor its
shape and dtype and allocates nothing (`meta_train_state`), so the dry
run and the per-device byte counts see the production shapes exactly.
The same `SHAPES`, `_NATIVE_LONG`, `_SKIP_LONG` and `arch_for_shape`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.models import Batch, init_caches
from repro_torch.models.config import ModelConfig
from repro_torch.training.step import TrainState, init_train_state

SHAPES = {
    "train_4k":    dict(seq=4096,   batch=256, mode="train"),
    "prefill_32k": dict(seq=32768,  batch=32,  mode="prefill"),
    "decode_32k":  dict(seq=32768,  batch=128, mode="decode"),
    "long_500k":   dict(seq=524288, batch=1,   mode="decode"),
}

# archs that natively handle 500k decode (bounded state / local window)
_NATIVE_LONG = {"mamba2-1.3b", "recurrentgemma-9b"}
# enc-dec: a 500k-token decoder cache is out of the model's regime (skip,
# as the reference does)
_SKIP_LONG = {"seamless-m4t-medium"}
_SWA_WINDOW = 4096

META = torch.device("meta")


class _MetaGenerator(torch.Generator):
    """A generator whose `device` is `meta`: the initialisers draw from
    `gen` onto `gen.device`, so with it they build shapes and dtypes and
    allocate nothing."""

    @property
    def device(self):
        return META


class ComboSpec(NamedTuple):
    cfg: ModelConfig
    mode: str                       # train | prefill | decode
    args: tuple                     # trees of meta tensors
    note: str


def arch_for_shape(arch: str, shape: str) -> Optional[tuple]:
    """Returns (cfg, note) with any long-context variant applied, or None
    if the combo is skipped."""
    cfg = get_config(arch)
    note = ""
    if shape == "long_500k":
        if arch in _SKIP_LONG:
            return None
        if arch not in _NATIVE_LONG:
            cfg = cfg.replace(window=_SWA_WINDOW)
            note = f"sliding-window variant (window={_SWA_WINDOW})"
    return cfg, note


def meta_train_state(cfg: ModelConfig) -> TrainState:
    """`init_train_state`'s tree for `cfg` on the `meta` device."""
    return init_train_state(_MetaGenerator(), cfg)


def _frontend_spec(cfg: ModelConfig, batch: int):
    if cfg.frontend is None:
        return None
    return torch.empty((batch, cfg.n_frontend_tokens, cfg.d_model),
                       dtype=torch.float32, device=META)


def _token_len(cfg: ModelConfig, seq: int) -> int:
    """Text-token length so that total decoder context == seq."""
    if cfg.arch_type == "vlm":
        return seq - cfg.n_frontend_tokens
    return seq


def _tokens(batch: int, seq: int) -> torch.Tensor:
    return torch.empty((batch, seq), dtype=torch.int32, device=META)


def input_specs(arch: str, shape: str,
                cfg: Optional[ModelConfig] = None) -> Optional[ComboSpec]:
    """The combination's abstract inputs; `cfg` replaces the resolved
    configuration (the dry run's `--reduced` smoke size)."""
    resolved = arch_for_shape(arch, shape)
    if resolved is None:
        return None
    cfg, note = (resolved[0] if cfg is None else cfg), resolved[1]
    info = SHAPES[shape]
    seq, batch, mode = info["seq"], info["batch"], info["mode"]

    if mode == "train":
        tok = _tokens(batch, _token_len(cfg, seq))
        batch_spec = Batch(tokens=tok, labels=tok,
                           frontend=_frontend_spec(cfg, batch))
        return ComboSpec(cfg, mode, (meta_train_state(cfg), batch_spec),
                         note)

    params = meta_train_state(cfg).params
    if mode == "prefill":
        batch_spec = Batch(tokens=_tokens(batch, _token_len(cfg, seq)),
                           labels=None, frontend=_frontend_spec(cfg, batch))
        return ComboSpec(cfg, mode, (params, batch_spec), note)

    # decode: ONE token against a cache of `seq`
    caches = init_caches(cfg, batch, seq, device=META)
    token = _tokens(batch, 1)
    pos = torch.empty((), dtype=torch.int32, device=META)
    return ComboSpec(cfg, mode, (params, token, pos, caches), note)
