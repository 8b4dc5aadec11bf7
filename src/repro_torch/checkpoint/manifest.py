"""Crash-safe generation checkpoints: atomic writes + checksummed manifest.

The port's counterpart of the JAX package's `repro/checkpoint/manifest.py`,
over the same files and manifest. `CheckpointStore` is the persistence
layer a long-running service can die on at any instruction and still
restart from:

* every payload write is atomic (`io.atomic_write`: same-directory temp
  file + fsync + rename), so a SIGKILL mid-save leaves the previous
  complete generation, never a torn npz;
* `MANIFEST.json` — itself written atomically — records each retained
  generation with its file name, byte size, and sha256, newest first;
* the last `keep` generations are retained, older payloads pruned;
* `load()` walks the manifest newest-first and falls back past any
  entry whose file is missing, fails its checksum, or no longer
  restores against the template — each skip is recorded to
  `repro_torch.obs` (`checkpoint.fallback{reason}`) so silent corruption is
  still observable. A manifest that is itself unreadable degrades to a
  directory scan over `ckpt_*.npz` (checksums unavailable, restore
  errors still caught).

The store is deliberately dumb about contents: it persists any tensor
tree (`io.save_pytree`), tagged with a caller-supplied integer
generation.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import traceback
from typing import List, Optional, Tuple

from repro_torch import obs
from repro_torch.checkpoint.io import (
    CheckpointError, atomic_write, restore_pytree, save_pytree,
)

MANIFEST_NAME = "MANIFEST.json"
_CKPT_RE = re.compile(r"^ckpt_(\d{8})\.npz$")


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


class CheckpointStore:
    """Retained-generation checkpoint directory with a checksummed
    manifest. `save` is crash-safe; `load` survives a corrupted head by
    falling back through older retained generations."""

    def __init__(self, dirpath: str, keep: int = 3):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.dirpath = dirpath
        self.keep = keep

    # -- paths ------------------------------------------------------------

    def _manifest_path(self) -> str:
        return os.path.join(self.dirpath, MANIFEST_NAME)

    def _ckpt_name(self, generation: int) -> str:
        return f"ckpt_{generation:08d}.npz"

    # -- manifest ---------------------------------------------------------

    def _read_manifest(self) -> Optional[List[dict]]:
        """Manifest entries (newest first), or None when the manifest is
        missing/unreadable and the caller should fall back to a scan."""
        try:
            with open(self._manifest_path()) as f:
                doc = json.load(f)
            entries = doc["checkpoints"]
            if not isinstance(entries, list):
                raise CheckpointError("manifest 'checkpoints' not a list")
            return entries
        except FileNotFoundError:
            return None
        except (OSError, ValueError, KeyError, TypeError) as e:
            # unreadable file, bad JSON or text, or a document of the
            # wrong shape: degrade to the directory scan
            obs.inc("checkpoint.fallback", reason="manifest_unreadable")
            obs.inc("checkpoint.manifest_error",
                    kind=type(e).__name__)
            return None

    def _write_manifest(self, entries: List[dict]) -> None:
        doc = {"version": 1, "checkpoints": entries}
        payload = json.dumps(doc, indent=2).encode() + b"\n"
        atomic_write(self._manifest_path(), lambda f: f.write(payload))

    # -- save -------------------------------------------------------------

    def save(self, tree, generation: int) -> str:
        """Persist `tree` as `generation`, update the manifest, prune
        generations past `keep`. Returns the payload path."""
        generation = int(generation)
        name = self._ckpt_name(generation)
        path = os.path.join(self.dirpath, name)
        save_pytree(path, tree)
        entry = {"generation": generation, "file": name,
                 "nbytes": os.path.getsize(path), "sha256": _sha256(path)}
        entries = [e for e in (self._read_manifest() or [])
                   if e.get("file") != name]
        entries.append(entry)
        entries.sort(key=lambda e: e.get("generation", -1), reverse=True)
        retained, pruned = entries[:self.keep], entries[self.keep:]
        self._write_manifest(retained)
        for old in pruned:
            stale = os.path.join(self.dirpath, str(old.get("file")))
            try:
                os.remove(stale)
            except OSError:
                obs.inc("checkpoint.prune_error")
        obs.inc("checkpoint.saved")
        obs.set_gauge("checkpoint.head_generation", generation)
        return path

    # -- load -------------------------------------------------------------

    def _candidates(self) -> List[Tuple[int, str, Optional[str]]]:
        """(generation, filename, sha256-or-None), newest first — from
        the manifest when readable, else a directory scan."""
        entries = self._read_manifest()
        if entries is not None:
            out = []
            for e in entries:
                try:
                    out.append((int(e["generation"]), str(e["file"]),
                                e.get("sha256")))
                except (KeyError, TypeError, ValueError):
                    obs.inc("checkpoint.fallback", reason="manifest_entry")
            return sorted(out, reverse=True)
        try:
            names = os.listdir(self.dirpath)
        except OSError:
            return []
        found = []
        for n in names:
            m = _CKPT_RE.match(n)
            if m:
                found.append((int(m.group(1)), n, None))
        return sorted(found, reverse=True)

    def generations(self) -> List[int]:
        """Retained generations, newest first."""
        return [g for g, _, _ in self._candidates()]

    def load(self, template):
        """Restore the newest loadable generation into `template`.

        Returns `(tree, generation)`. A corrupted head — missing file,
        checksum mismatch, torn npz, template mismatch — is skipped
        (recorded as `checkpoint.fallback{reason}`) and the next
        retained generation is tried; `CheckpointError` is raised only
        when no retained generation restores.
        """
        candidates = self._candidates()
        tried, tracebacks = [], []
        for generation, name, sha in candidates:
            path = os.path.join(self.dirpath, name)
            if not os.path.exists(path):
                obs.inc("checkpoint.fallback", reason="missing_file")
                tried.append(f"{name}: missing")
                continue
            if sha is not None and _sha256(path) != sha:
                obs.inc("checkpoint.fallback", reason="checksum")
                tried.append(f"{name}: checksum mismatch")
                continue
            try:
                tree = restore_pytree(path, template)
            except Exception as e:  # noqa: BLE001 - counted, reported, skipped
                obs.inc("checkpoint.fallback", reason="restore_error")
                tried.append(f"{name}: {type(e).__name__}: {e}")
                tracebacks.append("".join(traceback.format_exception(e)))
                continue
            obs.inc("checkpoint.loaded")
            obs.set_gauge("checkpoint.loaded_generation", generation)
            return tree, generation
        detail = "; ".join(tried) if tried else "no checkpoints found"
        err = CheckpointError(
            f"no loadable checkpoint in '{self.dirpath}' "
            f"({len(candidates)} candidates): {detail}")
        for tb in tracebacks:       # each skipped restore's traceback
            err.add_note(tb)
        raise err
