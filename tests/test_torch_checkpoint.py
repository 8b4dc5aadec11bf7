"""The port's checkpoints (`repro_torch.checkpoint`) against the JAX
reference's, on the CPU.

Case for case the checkpoint cases of the reference's
`tests/test_chaos.py` (torn heads, a corrupt manifest, pruning, atomic
writes, the service's compatibility checks, a SIGKILL mid-ingest), run
on the port; and the cross-load: a `StreamState`, a window-mode tree
and a whole service checkpoint saved by either package restore in the
other with the same leaf names, dtypes and bits.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.stream as jstream
from repro.checkpoint.io import restore_pytree as jax_restore_pytree
from repro.checkpoint.io import save_pytree as jax_save_pytree
from repro.testing import make_clean_batch as jax_make_clean_batch
from repro_torch import obs
from repro_torch.checkpoint.io import (
    CheckpointError, atomic_write, npz_safe_dtype, restore_pytree,
    save_pytree,
)
from repro_torch.checkpoint.manifest import CheckpointStore
from repro_torch.convert import from_reference
from repro_torch.stream import (
    StreamingDsmlService, ingest, init_stream_state, init_window, refit,
    window_ingest,
)
from repro_torch.testing import make_clean_batch, truncate_file

REPO = Path(__file__).resolve().parents[1]
LAM, MU, THR = 0.4, 0.2, 1.0
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _service(m=2, p=16, **kw):
    kw.setdefault("lam", LAM)
    kw.setdefault("mu", MU)
    kw.setdefault("Lam", THR)
    kw.setdefault("device", CPU)
    return StreamingDsmlService(m, p, **kw)


def _stamped_tree(svc, generation):
    svc.state = svc.state._replace(
        generation=torch.tensor(generation, dtype=torch.int32))
    return svc._ckpt_tree()


# -- torn checkpoints ---------------------------------------------------------

def test_truncated_head_falls_back_one_generation(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=3)
    svc = _service(guard=False)
    for g in (1, 2, 3):
        store.save(_stamped_tree(svc, g), g)
    assert store.generations() == [3, 2, 1]
    truncate_file(str(tmp_path / "ckpt_00000003.npz"), keep_fraction=0.4)
    before = obs.counter_total("checkpoint.fallback", reason="checksum")
    tree, gen = store.load(svc._ckpt_tree())
    assert gen == 2
    assert int(tree["state"].generation) == 2
    assert obs.counter_total("checkpoint.fallback",
                             reason="checksum") == before + 1


def test_corrupt_manifest_degrades_to_directory_scan(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=3)
    svc = _service(guard=False)
    for g in (1, 2):
        store.save(_stamped_tree(svc, g), g)
    (tmp_path / "MANIFEST.json").write_text("{ not json")
    tree, gen = store.load(svc._ckpt_tree())
    assert gen == 2             # head intact, found without the manifest
    # a truncated head is still skipped (restore error, not checksum)
    truncate_file(str(tmp_path / "ckpt_00000002.npz"), keep_fraction=0.2)
    tree, gen = store.load(svc._ckpt_tree())
    assert gen == 1


@pytest.mark.parametrize("doc", ['{"checkpoints": 3}', '[1, 2]',
                                 '{"version": 1}'])
def test_malformed_manifest_degrades_to_directory_scan(tmp_path, doc):
    store = CheckpointStore(str(tmp_path), keep=3)
    svc = _service(guard=False)
    store.save(_stamped_tree(svc, 4), 4)
    (tmp_path / "MANIFEST.json").write_text(doc)
    before = obs.counter_total("checkpoint.fallback",
                               reason="manifest_unreadable")
    assert store.generations() == [4]
    assert obs.counter_total("checkpoint.fallback",
                             reason="manifest_unreadable") == before + 1


def test_store_load_stops_at_max_generation(tmp_path):
    """The generation a sharded service's ranks agreed on: the newest at
    or below it, and none where none is."""
    store = CheckpointStore(str(tmp_path), keep=3)
    svc = _service(guard=False)
    for g in (1, 2, 4):
        store.save(_stamped_tree(svc, g), g)
    assert store.load(svc._ckpt_tree(), max_generation=3)[1] == 2
    assert store.load(svc._ckpt_tree(), max_generation=4)[1] == 4
    with pytest.raises(CheckpointError, match="no checkpoints found"):
        store.load(svc._ckpt_tree(), max_generation=0)


def test_store_prunes_to_keep(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=2)
    svc = _service(guard=False)
    for g in range(1, 6):
        store.save(_stamped_tree(svc, g), g)
    assert store.generations() == [5, 4]
    names = sorted(f for f in os.listdir(tmp_path) if f.endswith(".npz"))
    assert names == ["ckpt_00000004.npz", "ckpt_00000005.npz"]


def test_all_generations_corrupt_raises(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=2)
    svc = _service(guard=False)
    for g in (1, 2):
        store.save(_stamped_tree(svc, g), g)
    for name in ("ckpt_00000001.npz", "ckpt_00000002.npz"):
        truncate_file(str(tmp_path / name), keep_fraction=0.1)
    # drop the checksums so both files reach the restore and fail there
    (tmp_path / "MANIFEST.json").unlink()
    with pytest.raises(CheckpointError,
                       match="no loadable checkpoint") as err:
        store.load(svc._ckpt_tree())
    # every skipped restore's traceback rides on the error as a note
    notes = err.value.__notes__
    assert len(notes) == 2 and all("Traceback" in n for n in notes)


def test_atomic_save_failure_keeps_previous(tmp_path):
    path = str(tmp_path / "ck.npz")
    save_pytree(path, {"a": torch.arange(4.0)})

    def boom(f):
        f.write(b"partial garbage")
        raise RuntimeError("simulated crash mid-write")

    with pytest.raises(RuntimeError, match="simulated crash"):
        atomic_write(path, boom)
    restored = restore_pytree(path, {"a": torch.zeros(4)})   # still intact
    assert restored["a"].tolist() == [0, 1, 2, 3]
    assert [f for f in os.listdir(tmp_path) if ".tmp." in f] == []


def test_restore_checks_structure_and_shapes(tmp_path):
    path = str(tmp_path / "t")
    save_pytree(path, {"a": torch.zeros(3), "b": [torch.ones(2)]})
    with pytest.raises(CheckpointError, match="1 leaves missing"):
        restore_pytree(path, {"a": torch.zeros(3), "c": torch.zeros(1)})
    with pytest.raises(CheckpointError, match="shape"):
        restore_pytree(path, {"a": torch.zeros(4)})
    with pytest.raises(CheckpointError, match="unreadable"):
        truncate_file(path + ".npz", keep_fraction=0.0)
        restore_pytree(path, {"a": torch.zeros(3)})


def test_bfloat16_leaves_land_as_float32_and_come_back():
    assert npz_safe_dtype(torch.bfloat16) == np.float32
    assert npz_safe_dtype(torch.float16) == np.float16
    assert npz_safe_dtype(torch.bool) == np.bool_
    x = torch.randn(5).to(torch.bfloat16)
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                        f"bf16.{os.getpid()}")
    save_pytree(path, {"x": x})
    try:
        with np.load(path + ".npz") as data:
            assert data["x"].dtype == np.float32
        back = restore_pytree(path, {"x": torch.zeros(5,
                                                      dtype=torch.bfloat16)})
        assert back["x"].dtype == torch.bfloat16
        assert torch.equal(back["x"], x)
    finally:
        os.remove(path + ".npz")


# -- the service's checkpoints --------------------------------------------------

def test_service_load_validates_compat(tmp_path):
    svc = _service(m=2, p=16, guard=False)
    path = str(tmp_path / "svc.npz")
    svc.save(path)
    with pytest.raises(CheckpointError, match="incompatible"):
        _service(m=2, p=32, guard=False).load(path)
    with pytest.raises(CheckpointError, match="incompatible"):
        _service(m=4, p=16, guard=False).load(path)
    # f16 lands on disk as f16 (unlike bf16's f32 upcast), so it is a
    # genuine on-disk dtype mismatch against the f32 checkpoint
    with pytest.raises(CheckpointError, match="dtype"):
        _service(m=2, p=16, dtype=torch.float16, guard=False).load(path)
    with pytest.raises(CheckpointError, match="not a StreamingDsmlService"):
        save_pytree(str(tmp_path / "other.npz"), {"weights": torch.zeros(3)})
        svc.load(str(tmp_path / "other.npz"))
    svc2 = _service(m=2, p=16, guard=False)
    svc2.load(path)             # the compatible load still works
    assert svc2.generation == svc.generation


def test_service_checkpoint_restore_cycle(tmp_path):
    rng = np.random.default_rng(8)
    svc = _service(refit_every=32, max_refit_interval=32, guard=False,
                   ckpt_dir=str(tmp_path), ckpt_keep=2)
    for _ in range(3):
        svc.ingest(*make_clean_batch(rng, 2, 32, 16, device=CPU))
    assert svc.generation == 3
    assert svc.ckpt_store.generations() == [3, 2]
    truncate_file(str(tmp_path / "ckpt_00000003.npz"), keep_fraction=0.3)
    fresh = _service(refit_every=32, guard=False, ckpt_dir=str(tmp_path))
    assert fresh.restore() == 2
    assert fresh.generation == 2
    assert fresh.state.generation.device == CPU
    Xp = torch.as_tensor(rng.standard_normal((8, 16)), dtype=torch.float32)
    assert torch.isfinite(fresh.predict(Xp)).all()


_KILL_PAYLOAD = """
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.stream import StreamingDsmlService
from repro_torch.testing import make_clean_batch

svc = StreamingDsmlService(2, 16, lam=0.4, mu=0.2, Lam=1.0, device="cpu",
                           refit_every=32, guard=False,
                           ckpt_dir={ckpt_dir!r})
rng = np.random.default_rng(0)
for step in range(100000):
    svc.ingest(*make_clean_batch(rng, 2, 32, 16, device="cpu"))
    print("gen", svc.generation, flush=True)
"""


def test_sigkill_mid_ingest_leaves_loadable_store(tmp_path):
    ckpt_dir = str(tmp_path / "store")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", _KILL_PAYLOAD.format(ckpt_dir=ckpt_dir)],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    manifest = os.path.join(ckpt_dir, "MANIFEST.json")

    def _retained() -> int:
        # the child rewrites the manifest atomically; a failed read
        # counts as "not yet"
        try:
            with open(manifest) as f:
                return len(json.load(f)["checkpoints"])
        except (OSError, ValueError, KeyError):
            return 0

    try:
        deadline = time.time() + 120
        while time.time() < deadline:
            if _retained() >= 2:
                break
            if proc.poll() is not None:
                pytest.fail(f"ingest child died early:\n"
                            f"{proc.communicate()[1].decode()}")
            time.sleep(0.2)
        else:
            pytest.fail("child never wrote two checkpoint generations")
    finally:
        proc.kill()             # SIGKILL: no atexit, no cleanup
        proc.communicate()
    svc = _service(guard=False, ckpt_dir=ckpt_dir)
    assert svc.restore() >= 2
    assert torch.isfinite(svc.state.Sigmas).all()


# -- across the two packages ------------------------------------------------

def _reference_state():
    """A reference `StreamState` two chunks and one refit in."""
    rng = np.random.default_rng(2)
    st = jstream.init_stream_state(3, 12)
    for _ in range(2):
        st = jstream.ingest(st, *jax_make_clean_batch(rng, 3, 24, 12))
    st, _ = jstream.refit(st, LAM, MU, THR, lasso_iters=60, debias_iters=60)
    return st


def _same_bits(got, want):
    for name in want._fields:
        a, b = getattr(got, name), np.array(getattr(want, name))
        assert a.numpy().dtype == b.dtype, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


def test_stream_state_saved_by_reference_restores_in_port(tmp_path):
    ref = _reference_state()
    path = str(tmp_path / "ref_state")
    jax_save_pytree(path, {"state": ref})
    got = restore_pytree(path, {"state": init_stream_state(3, 12,
                                                           device=CPU)})
    _same_bits(got["state"], ref)
    assert got["state"].generation.device == CPU


def test_stream_state_saved_by_port_restores_in_reference(tmp_path):
    ref = _reference_state()
    st = from_reference(ref, CPU)
    path = str(tmp_path / "port_state")
    save_pytree(path, {"state": st})
    with np.load(path + ".npz") as data:
        assert sorted(data.files) == sorted(
            f"state/{f}" for f in ref._fields)
        assert data["state/support"].dtype == np.bool_
        assert data["state/generation"].dtype == np.int32
        assert data["state/generation"].shape == ()
    back = jax_restore_pytree(path, {"state": jstream.init_stream_state(3,
                                                                        12)})
    _same_bits(st, back["state"])


def test_window_tree_crosses_both_ways(tmp_path):
    rng = np.random.default_rng(3)
    jwin, win = jstream.init_window(2, 3, 12), init_window(2, 3, 12,
                                                          device=CPU)
    for _ in range(3):
        X, y = jax_make_clean_batch(rng, 3, 24, 12)
        jwin = jstream.window_ingest(jwin, X, y)
        win = window_ingest(win, torch.from_numpy(np.array(X)),
                            torch.from_numpy(np.array(y)))
    ref_state = _reference_state()
    jtree = {"state": ref_state, "window": jwin}
    path = str(tmp_path / "ref_win")
    jax_save_pytree(path, jtree)
    got = restore_pytree(path, {"state": init_stream_state(3, 12, device=CPU),
                                "window": init_window(2, 3, 12, device=CPU)})
    _same_bits(got["window"], jwin)
    _same_bits(got["state"], ref_state)
    path2 = str(tmp_path / "port_win")
    save_pytree(path2, {"state": got["state"], "window": win})
    back = jax_restore_pytree(path2, {
        "state": jstream.init_stream_state(3, 12),
        "window": jstream.init_window(2, 3, 12)})
    _same_bits(win, back["window"])
    assert int(back["window"].seen) == 3 and int(back["window"].head) == 1


def test_service_checkpoints_cross_load(tmp_path):
    """A service checkpoint written by either package loads in the other
    package's service, which then serves the same model."""
    rng = np.random.default_rng(4)
    kw = dict(refit_every=32, guard=False, lasso_iters=80, debias_iters=80)
    ref = jstream.StreamingDsmlService(2, 16, lam=LAM, mu=MU, Lam=THR, **kw)
    for _ in range(2):
        ref.ingest(*jax_make_clean_batch(rng, 2, 32, 16))
    ref.save(str(tmp_path / "ref_svc"))
    svc = _service(**kw)
    svc.load(str(tmp_path / "ref_svc"))
    assert svc.generation == ref.generation == 2
    _same_bits(svc.state, ref.state)
    Xp = rng.standard_normal((5, 16)).astype(np.float32)
    np.testing.assert_allclose(svc.predict(Xp).numpy(),
                               np.array(ref.predict(jnp.asarray(Xp))),
                               rtol=0, atol=1e-6)
    # the port refits on, saves, and the reference loads it
    X, y = make_clean_batch(rng, 2, 32, 16, device=CPU)
    svc.ingest(X, y)
    assert svc.generation == 3
    svc.save(str(tmp_path / "port_svc"))
    ref2 = jstream.StreamingDsmlService(2, 16, lam=LAM, mu=MU, Lam=THR,
                                        **kw)
    ref2.load(str(tmp_path / "port_svc"))
    assert ref2.generation == 3
    _same_bits(svc.state, ref2.state)


def test_restored_state_refits_like_the_reference(tmp_path):
    """A reference checkpoint restored in the port and refit there gives
    the reference's refit of the same state, within 1e-5."""
    ref = _reference_state()
    path = str(tmp_path / "ref_state")
    jax_save_pytree(path, {"state": ref})
    st = restore_pytree(path, {"state": init_stream_state(3, 12,
                                                          device=CPU)})
    got, _ = refit(st["state"], LAM, MU, THR, lasso_iters=60,
                   debias_iters=60)
    want, _ = jstream.refit(ref, LAM, MU, THR, lasso_iters=60,
                            debias_iters=60)
    for name in ("beta_tilde", "beta_u", "Ms"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.array(getattr(want, name)), rtol=0,
                                   atol=1e-5, err_msg=name)
    assert torch.equal(got.support, torch.from_numpy(np.array(want.support)))
    # ingest after restore keeps the host counter on the host
    nxt = ingest(got, torch.ones(3, 4, 12), torch.ones(3, 4))
    assert nxt.generation.device == CPU and int(nxt.generation) == 2
