"""Carry data and solver state across from the JAX reference.

DSML has no trained weights: what crosses between the two packages is
data (`MultiTaskData`), a fit's result (`DsmlResult`,
`DsmlLogisticResult`) and the warm-start arrays of a refit (`beta0`,
the local lasso solution, and `M0`, the debias matrices).
`from_reference` takes the reference's NamedTuples or arrays — JAX or
numpy arrays, anything `np.array` reads — and returns the port's
tensors and NamedTuples on `device`. The reference's types
are matched by name and fields, so nothing of the reference is imported.

The model stack has parameters: `params_from_reference` carries the
reference's parameter tree (random, from a seed: no trained weights are
in the repository) across for a dense configuration.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dsml import DsmlResult
from repro_torch.core.logistic import DsmlLogisticResult
from repro_torch.core.synth import MultiTaskData
from repro_torch.models.backbone import _check_dense

_TUPLES = {cls.__name__: cls
           for cls in (MultiTaskData, DsmlResult, DsmlLogisticResult)}


def _tensor(a, device) -> torch.Tensor:
    # np.array copies: np.asarray of a JAX array is read-only, and torch
    # warns on (and must not write through) a read-only buffer
    arr = np.array(a)
    if arr.dtype.name == "bfloat16":
        # a JAX bf16 array becomes an ml_dtypes.bfloat16 array, which
        # torch.from_numpy refuses: carry its bits as uint16
        return torch.from_numpy(arr.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def from_reference(obj, device="cuda"):
    """A reference `MultiTaskData`, `DsmlResult` or `DsmlLogisticResult`
    -> the port's NamedTuple of tensors; any other array (e.g. `beta0`,
    `M0`) -> one tensor. Dtypes are kept (float32 stays float32, bool stays bool)."""
    fields = getattr(obj, "_fields", None)
    if fields is not None:
        cls = _TUPLES.get(type(obj).__name__)
        if cls is None or cls._fields != fields:
            raise TypeError(f"from_reference: no port counterpart for "
                            f"{type(obj).__name__}{fields}")
        return cls(*(_tensor(a, device) for a in obj))
    return _tensor(obj, device)


def _leaves(tree, fn):
    """Apply `fn` to every array of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: _leaves(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_leaves(v, fn) for v in tree]
    return fn(tree)


def params_from_reference(params: dict, cfg, device="cuda") -> dict:
    """The reference's parameter tree for a dense `cfg` (nested dicts,
    the layers stacked along a leading axis under `"layers"` as
    `{"p0": {...}}`, an optional `"head"`), as JAX or numpy arrays -> the
    port's parameters (`models.backbone.init_params`'s layout: a list of
    per-layer dicts under `"layers"`) on `device`, dtypes and bits kept."""
    _check_dense(cfg)
    stacked = params["layers"]
    if set(stacked) != {"p0"}:
        raise ValueError(f"params_from_reference: a dense stack has one "
                         f"layer per group, got groups {sorted(stacked)}")
    # split the stacked axis on the host, one copy of each layer
    host = _leaves(stacked["p0"], np.array)
    if host["norm1"].shape[0] != cfg.n_layers:
        raise ValueError(f"params_from_reference: {host['norm1'].shape[0]} "
                         f"stacked layers, config has {cfg.n_layers}")
    out = {k: _tensor(v, device) for k, v in params.items()
           if k != "layers"}
    out["layers"] = [_leaves(host, lambda a, i=i: _tensor(a[i], device))
                     for i in range(cfg.n_layers)]
    return out
