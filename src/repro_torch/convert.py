"""Carry data and solver state across from the JAX reference.

DSML has no trained weights: what crosses between the two packages is
data (`MultiTaskData`), a fit's result (`DsmlResult`,
`DsmlLogisticResult`) and the warm-start arrays of a refit (`beta0`,
the local lasso solution, and `M0`, the debias matrices).
`from_reference` takes the reference's NamedTuples or arrays — JAX or
numpy arrays, anything `np.array` reads — and returns the port's
tensors and NamedTuples on `device`. The reference's types
are matched by name and fields, so nothing of the reference is imported.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dsml import DsmlResult
from repro_torch.core.logistic import DsmlLogisticResult
from repro_torch.core.synth import MultiTaskData

_TUPLES = {cls.__name__: cls
           for cls in (MultiTaskData, DsmlResult, DsmlLogisticResult)}


def _tensor(a, device) -> torch.Tensor:
    # np.array copies: np.asarray of a JAX array is read-only, and torch
    # warns on (and must not write through) a read-only buffer
    return torch.from_numpy(np.array(a)).to(device)


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
