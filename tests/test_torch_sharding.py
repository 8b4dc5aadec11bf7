"""The port's sharding rules against the JAX package's, on the CPU.

* For all ten `ASSIGNED` configurations at full size (the reference's
  trees from `jax.eval_shape`, the port's on the `meta` device), on the
  meshes (16, 16), (2, 16, 16), (32, 8), (2, 2), (1, 2) and (2, 1):
  `opt_pspecs`, `param_pspecs`, `train_state_pspecs`, `batch_pspecs`,
  `logits_pspec` and `cache_pspecs` give each leaf the reference's spec,
  compared as plain tuples. The reference stacks a group's layers on a
  leading axis (`layers/p0/...`) where the port keeps a list of layers
  (`layers/0/...`); the rules are right-aligned, so a stacked leaf's spec
  is the port leaf's with one more leading entry (None, except for the
  reference's stacked conv caches, which its rules match by the name's
  end as `/v`'s and whose layer axis takes the batch's axis).
* `fit_spec` and `fit_first` on the reference's own cases
  (`tests/test_substrate.py`).
* `placements` and `place` on a (2, 2) mesh of four gloo ranks: each
  rank's block of a tensor is the block JAX's `NamedSharding.devices_indices_map` gives
  the device at the same mesh position (4 forced host devices), a dim
  split over ("data", "model") included.
"""
from __future__ import annotations

import json

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from repro.configs import ASSIGNED, get_config as jget
from repro.models import init_caches as jinit_caches
from repro.models import stack_plan as jstack_plan
from repro.sharding import rules as jrules
from repro.substrate import run_probe as jax_run_probe
from repro.training.step import init_train_state as jinit_train_state
from repro_torch.configs import get_config as tget
from repro_torch.launch.specs import META, meta_train_state
from repro_torch.models import init_caches as tinit_caches
from repro_torch.sharding import rules as trules
from repro_torch.substrate import run_probe
from repro_torch.tree import named_leaves

MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((32, 8), ("data", "model")), ((2, 2), ("data", "model")),
          ((1, 2), ("data", "model")), ((2, 1), ("data", "model"))]


class _JaxMesh:
    """Axis names and sizes, all the reference's rules read of a mesh."""

    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))
        self.axis_names = names


def _ref_specs(tree) -> dict:
    """{path: spec tuple} of a reference spec tree, paths as its rules
    name them, NamedTuple fields without their leading dot."""
    return {"/".join(c.lstrip(".") for c in jrules._path_str(p).split("/")):
            tuple(s) for p, s in jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: isinstance(x, JP))}


def _ref_name(name: str, n_pattern: int) -> tuple[str, bool]:
    """The reference's path of the port's leaf `name`, and whether the
    reference stacks it: `.../layers/<j>/...` -> `.../layers/p<j % n>/...`
    (the encoder's one-layer pattern: p0), the caches' `stack/<j>/...`
    -> `stack/p<j % n>/...`."""
    parts = name.split("/")
    if parts[0] == "stack":
        parts[1] = f"p{int(parts[1]) % n_pattern}"
        return "/".join(parts), True
    if "layers" in parts:
        k = parts.index("layers")
        j = int(parts[k + 1])
        n = 1 if parts[0] == "encoder" else n_pattern
        parts[k + 1] = f"p{j % n}"
        return "/".join(parts), True
    return name, False


def _check_tree(got: dict, want: dict, n_pattern: int, label: str) -> int:
    """Each port leaf's spec against the reference's; returns how many
    leaves were compared."""
    for name, spec in got.items():
        ref, stacked = _ref_name(name, n_pattern)
        w = want[ref]
        if stacked:
            w = w[1:]
        assert tuple(spec) == w, (label, name, tuple(spec), want[ref])
    return len(got)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_specs_match_reference_on_six_meshes(arch):
    jc, tc = jget(arch), tget(arch)
    n_pattern = len(jstack_plan(jc)[0])
    jstate = jax.eval_shape(lambda: jinit_train_state(jax.random.PRNGKey(0),
                                                      jc))
    tstate = meta_train_state(tc)
    jcaches = jax.eval_shape(lambda: jinit_caches(jc, 4, 64))
    tcaches = tinit_caches(tc, 4, 64, device=META)
    compared = 0
    for shape, names in MESHES:
        jm, sizes = _JaxMesh(shape, names), dict(zip(names, shape))
        label = f"{arch} {shape}"
        for fn in ("opt_pspecs", "param_pspecs"):
            compared += _check_tree(
                named_leaves(getattr(trules, fn)(tstate.params, sizes)),
                _ref_specs(getattr(jrules, fn)(jstate.params, jm)),
                n_pattern, f"{label} {fn}")
        # the whole train state: params, opt (master, mu, nu, count), step
        compared += _check_tree(
            named_leaves(trules.train_state_pspecs(tstate, sizes)),
            _ref_specs(jrules.train_state_pspecs(jstate, jm)),
            n_pattern, f"{label} train_state_pspecs")
        compared += _check_tree(
            named_leaves(trules.cache_pspecs(sizes, tcaches, 4)),
            _ref_specs(jrules.cache_pspecs(jm, jcaches, 4)),
            n_pattern, f"{label} cache_pspecs")
        for b in (1, 2, 4, 256):
            for fe in (False, True):
                want = jrules.batch_pspecs(jm, b, fe)
                got = trules.batch_pspecs(sizes, b, fe)
                assert [None if s is None else tuple(s) for s in got] == \
                    [None if s is None else tuple(s) for s in want], \
                    (label, b, fe)
        for vocab, seq in ((jc.padded_vocab, 4096), (49155, 4096),
                           (49155, 4095)):
            assert tuple(trules.logits_pspec(sizes, vocab, seq)) == \
                tuple(jrules.logits_pspec(jm, vocab, seq)), \
                (label, vocab, seq)
    assert compared > 0


def test_fit_spec_drops_nondividing_axes():
    m = {"data": 16, "model": 16}
    assert trules.fit_spec((24, 128), ("model", None), m) == (None, None)
    assert trules.fit_spec((32, 128), ("model", None), m) == ("model", None)
    # right alignment adds leading None for stacked params
    assert trules.fit_spec((8, 32, 128), ("model", None), m) == \
        (None, "model", None)


def test_fit_first_fallback_chain():
    m = {"data": 16, "model": 16}
    # vocab 49155 not divisible -> falls back to d-over-(data,model)
    spec = trules.fit_first((49155, 2048), (("model", "data"),
                                            (None, ("data", "model"))), m)
    assert spec == (None, ("data", "model"))


def test_spec_entries_normalise_as_jax_does():
    assert tuple(trules.P(("data",), None, [], ("data", "model"))) == \
        tuple(JP(("data",), None, (), ("data", "model")))
    assert trules.dp_axes({"pod": 2, "data": 4, "model": 2}) == \
        ("pod", "data")


SPECS = [(), ("data",), (None, "model"), ("data", "model"),
         ("model", "data"), (("data", "model"),), (None, ("data", "model")),
         (None, None, ("data", "model"))]
SHAPE = (8, 12, 4)

_JAX_BLOCKS = f"""
import json
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
mesh = jax.make_mesh((2, 2), ("data", "model"))
out = []
for spec in {SPECS!r}:
    idx = NamedSharding(mesh, P(*spec)).devices_indices_map({SHAPE!r})
    out.append([[[s.start or 0, {SHAPE!r}[i] if s.stop is None else s.stop]
                 for i, s in enumerate(idx[mesh.devices[d, m]])]
                for d in range(2) for m in range(2)])
print(json.dumps(out))
"""

_TORCH_BLOCKS = f"""
import json
import torch
from repro_torch.sharding.place import place
from repro_torch.sharding.rules import P, placements
from repro_torch.substrate import init_from_env, make_mesh
rank, world = init_from_env()
mesh = make_mesh((2, 2), ("data", "model"), "cpu")
full = torch.arange(torch.Size({SHAPE!r}).numel()).reshape({SHAPE!r})
out = []
for spec in {SPECS!r}:
    loc = place(full, mesh, placements(P(*spec), mesh)).to_local()
    out.append(loc.tolist())
print(json.dumps(out))
"""


def test_placements_give_each_rank_jaxs_block():
    """Rank r = (d, m) = divmod(r, 2) of the port's (2, 2) mesh holds the
    block that the device at mesh position (d, m) holds in JAX."""
    ref = jax_run_probe(_JAX_BLOCKS, n_devices=4, timeout=120)
    assert ref.returncode == 0, ref.stderr[-3000:]
    blocks = json.loads(ref.stdout.strip().splitlines()[-1])
    run = run_probe(_TORCH_BLOCKS, world=4, timeout=120, pg_timeout=60)
    assert run.ok, run.report()
    full = np.arange(np.prod(SHAPE)).reshape(SHAPE)
    for r, rank in enumerate(run.ranks):
        got = json.loads(rank.stdout.strip().splitlines()[-1])
        for spec, loc, per_pos in zip(SPECS, got, blocks):
            want = full[tuple(slice(a, b) for a, b in per_pos[r])]
            np.testing.assert_array_equal(np.array(loc), want,
                                          err_msg=f"rank {r} spec {spec}")
    # the rules never split a dim over axes out of mesh order
    with pytest.raises(ValueError, match="mesh's order"):
        trules.placements(trules.P(("model", "data")),
                          {"data": 2, "model": 2})
