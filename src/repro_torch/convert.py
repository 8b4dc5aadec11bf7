"""Carry data and solver state across from the JAX reference.

DSML has no trained weights: what crosses between the two packages is
data (`MultiTaskData`, a probe's `ProbeData`), a fit's result
(`DsmlResult`, also as the reference's `dsml_fit_sharded` returns it:
global arrays laid out over its mesh, which `np.array` gathers;
`DsmlLogisticResult`), the warm-start arrays of a refit (`beta0`,
the local lasso solution, and `M0`, the debias matrices) and the
streaming service's state (`StreamState`, `WindowState`), whose
counters (`generation`, `head`, `seen`) go to the host whatever
`device` is, as the port keeps them.
`from_reference` takes the reference's NamedTuples or arrays — JAX or
numpy arrays, anything `np.array` reads — and returns the port's
tensors and NamedTuples on `device`. The reference's types
are matched by name and fields, so nothing of the reference is imported.

The model stack has parameters: `params_from_reference` carries the
reference's parameter tree (random, from a seed: no trained weights are
in the repository) across for every family of the zoo, and
`train_state_from_reference` a training state (parameters, AdamW's
master copy and moments, the counts).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dsml import DsmlResult
from repro_torch.core.logistic import DsmlLogisticResult
from repro_torch.core.synth import MultiTaskData
from repro_torch.models.backbone import stack_plan
from repro_torch.multitask.sparse_probe import ProbeData
from repro_torch.optim.adamw import AdamWState
from repro_torch.training.step import TrainState, shard_train_state
from repro_torch.stream.state import StreamState, WindowState
from repro_torch.tree import tree_map

_TUPLES = {cls.__name__: cls
           for cls in (MultiTaskData, DsmlResult, DsmlLogisticResult,
                       StreamState, WindowState, ProbeData)}
# fields the port keeps on the host: the counters the host branches on
_HOST_FIELDS = {"generation", "head", "seen"}


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
    """A reference `MultiTaskData`, `DsmlResult`, `DsmlLogisticResult`,
    `StreamState`, `WindowState` or `ProbeData` -> the port's NamedTuple
    of tensors;
    any other array (e.g. `beta0`, `M0`) -> one tensor. Dtypes are kept
    (float32 stays float32, bool stays bool, int32 stays int32)."""
    fields = getattr(obj, "_fields", None)
    if fields is not None:
        cls = _TUPLES.get(type(obj).__name__)
        if cls is None or cls._fields != fields:
            raise TypeError(f"from_reference: no port counterpart for "
                            f"{type(obj).__name__}{fields}")
        return cls(*(_tensor(a, "cpu" if f in _HOST_FIELDS else device)
                     for f, a in zip(fields, obj)))
    return _tensor(obj, device)


def _unstack(groups: dict, pattern, n_groups: int, device) -> list:
    """The reference's scanned groups `{"p0": ..., "p1": ...}` (each leaf
    with a leading axis of n_groups) -> one dict per layer, group by
    group, `p0` first within a group."""
    if set(groups) != {f"p{i}" for i in range(len(pattern))}:
        raise ValueError(f"params_from_reference: groups {sorted(groups)} "
                         f"for the pattern {pattern}")
    # split the stacked axis on the host, one copy of each layer
    host = {k: tree_map(np.array, v) for k, v in groups.items()}
    got = host["p0"]["norm1"].shape[0]
    if got != n_groups:
        raise ValueError(f"params_from_reference: {got} stacked groups, "
                         f"the config has {n_groups}")
    return [tree_map(lambda a, g=g: _tensor(a[g], device), host[f"p{i}"])
            for g in range(n_groups) for i in range(len(pattern))]


def params_from_reference(params: dict, cfg, device="cuda") -> dict:
    """The reference's parameter tree for `cfg` (nested dicts; the scanned
    layers stacked along a leading axis under `"layers"` as
    `{"p0": {...}, ...}` groups of `stack_plan(cfg)`'s pattern; the
    unrolled `"tail"` list, which is the MoE head; the encoder's stacked
    `"layers"` and `"final_norm"`; an optional `"head"`), as JAX or numpy
    arrays -> the port's parameters (`models.backbone.init_params`'s
    layout: lists of per-layer dicts) on `device`, dtypes and bits
    kept."""
    pattern, n_groups, tail = stack_plan(cfg)
    if len(params.get("tail", [])) != len(tail):
        raise ValueError(f"params_from_reference: {len(params.get('tail', []))}"
                         f" tail layers, the config has {len(tail)}")
    out = {k: tree_map(lambda a: _tensor(a, device), v)
           for k, v in params.items() if k not in ("layers", "encoder")}
    out["layers"] = _unstack(params["layers"], pattern, n_groups, device)
    if "encoder" in params:
        enc = params["encoder"]
        out["encoder"] = {
            "layers": _unstack(enc["layers"], ("attn",),
                               cfg.n_encoder_layers, device),
            "final_norm": _tensor(enc["final_norm"], device)}
    return out


def train_state_from_reference(state, cfg, device="cuda", mesh=None):
    """The reference's `TrainState(params, AdamWState(master, mu, nu,
    count), step)` -> the port's `training.step.TrainState` on `device`:
    the parameter, master and moment trees each laid out as
    `params_from_reference` lays out parameters, `count` and `step` 0-d
    int32 tensors. With a `mesh` (a `DeviceMesh` of (data, model) or
    (pod, data, model)), every rank converts the whole state and keeps
    its blocks (`training.step.shard_train_state`: the parameters by
    `param_pspecs`, master and moments by `opt_pspecs`)."""
    if tuple(getattr(state, "_fields", ())) != TrainState._fields or \
            tuple(getattr(state.opt, "_fields", ())) != AdamWState._fields:
        raise TypeError(f"train_state_from_reference: not a reference "
                        f"TrainState: {type(state).__name__}")
    opt = state.opt

    def tree(t):
        return params_from_reference(t, cfg, device)

    def count(c):
        return _tensor(c, device).to(torch.int32)

    out = TrainState(params=tree(state.params),
                     opt=AdamWState(tree(opt.master), tree(opt.mu),
                                    tree(opt.nu), count(opt.count)),
                     step=count(state.step))
    return out if mesh is None else shard_train_state(out, mesh)
