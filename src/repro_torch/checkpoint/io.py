"""Tree checkpointing: one npz file, leaves named by their path.

The port's counterpart of the JAX package's `repro/checkpoint/io.py`, on
the same file format, so a checkpoint written by either package loads
in the other. A tree is nested dicts, NamedTuples, lists and tuples
with tensors at the leaves, walked by `repro_torch.tree`. A leaf's name
is its path joined with "/": dict keys, NamedTuple field names, list
indices — `{"state": StreamState}` saves as `state/Sigmas`, ...,
`state/support` (bool), `state/generation` (int32, 0-d). Dict keys go
in sorted order and `None` is no leaf, as JAX flattens a pytree.
Leaves go to the host with `.cpu()`; bfloat16 is saved as float32 (npz
has no bfloat16) and cast back on restore. Restore maps the saved
arrays onto a template tree, checking shapes, and puts each leaf on
its template leaf's device with its dtype.

Sharded trees (the sharded train state, DTensor leaves): `save_pytree`
gathers each leaf to its global tensor on every rank (one all-gather a
split mesh dim) and rank 0 alone writes the file, after the gather, then
every rank waits for the write; so the file has the unsharded tree's
names and shapes, and loads in the unsharded port and in the reference.
`restore_pytree` into a template of DTensors has every rank read the
global file and keep its own block of each leaf, placed as the template
leaf (any mesh: a checkpoint of one mesh shape resumes on another).

Crash safety: `save_pytree` never writes the target file in place. The
payload lands in a same-directory temp file that is flushed, fsynced,
and `os.replace`d over the destination, so a process killed mid-save
leaves either the previous complete checkpoint or a stray `*.tmp.*`
file — never a torn npz that bricks restart. Torn or otherwise
unreadable files surface as `CheckpointError` (a `ValueError` subclass)
with the path named, as do template mismatches.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.sharding.place import full, place
from repro_torch.tree import map_leaves, named_leaves


class CheckpointError(ValueError):
    """A checkpoint file is unreadable or does not match its template."""


def _host_array(leaf: torch.Tensor) -> np.ndarray:
    """A tensor leaf as the numpy array it is saved as (bfloat16 as
    float32)."""
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _flatten_with_names(tree) -> dict:
    return {name: _host_array(full(leaf))
            for name, leaf in named_leaves(tree).items()}


def npz_safe_dtype(dtype: torch.dtype) -> np.dtype:
    """The on-disk dtype a leaf of torch `dtype` lands as — mirrors the
    bf16 -> f32 upcast `save_pytree` applies (restore casts back), so
    compatibility validators compare against what is actually saved."""
    return _host_array(torch.zeros((), dtype=dtype)).dtype


def atomic_write(path: str, write_fn) -> None:
    """Write `path` atomically: `write_fn(file_obj)` fills a
    same-directory temp file, which is flushed + fsynced and renamed
    over the destination. On failure the temp file is removed and the
    previous `path` contents (if any) are untouched."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def _npz_name(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_pytree(path: str, tree) -> None:
    """Write `tree` to `path` (`.npz` added). With DTensor leaves, every
    rank of their group must call it: each leaf is gathered to its global
    value, rank 0 writes, and the others return once it has."""
    sharded = any(isinstance(x, DTensor) for x in named_leaves(tree).values())
    flat = _flatten_with_names(tree)
    if not sharded or dist.get_rank() == 0:
        atomic_write(_npz_name(path), lambda f: np.savez(f, **flat))
    if sharded:
        dist.barrier()


def load_npz(path: str):
    """`np.load` with torn/corrupt files surfaced as CheckpointError."""
    fname = _npz_name(path)
    try:
        return np.load(fname)
    except FileNotFoundError:
        raise
    except Exception as e:
        raise CheckpointError(
            f"checkpoint '{fname}' is unreadable (torn write or "
            f"corruption): {type(e).__name__}: {e}") from e


def restore_pytree(path: str, template):
    """Restore into the structure of `template`, a tree of tensors: each
    leaf comes back with its template leaf's shape (checked), dtype and
    device; a DTensor leaf as this rank's block of the saved array,
    placed as the template leaf.

    Raises `CheckpointError` naming the file and the offending leaves
    when the checkpoint is torn, was saved from a different structure
    (missing leaves), or carries mismatched shapes. Extra keys on disk
    are legal (a template may restore a subset), but are reported
    alongside missing-leaf errors since together they usually mean
    "wrong checkpoint for this template".
    """
    fname = _npz_name(path)
    with load_npz(fname) as data:
        names = list(named_leaves(template))
        missing = [k for k in names if k not in data.files]
        if missing:
            extra = [k for k in data.files if k not in names]
            hint = f"; file has {len(extra)} unexpected keys e.g. " \
                f"{extra[:3]}" if extra else ""
            raise CheckpointError(
                f"checkpoint '{fname}' does not match the restore "
                f"template: {len(missing)} leaves missing, e.g. "
                f"{missing[:3]}{hint}")

        def restore(key, leaf):
            arr = data[key]
            if arr.shape != tuple(leaf.shape):
                raise CheckpointError(
                    f"checkpoint '{fname}' leaf '{key}': shape {arr.shape} "
                    f"!= template {tuple(leaf.shape)}")
            if isinstance(leaf, DTensor):
                full = torch.from_numpy(arr).to(
                    device=leaf.to_local().device, dtype=leaf.dtype)
                return place(full, leaf.device_mesh, leaf.placements)
            return torch.from_numpy(arr).to(device=leaf.device,
                                            dtype=leaf.dtype)

        return map_leaves(restore, template)
