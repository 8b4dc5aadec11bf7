"""The port's sharded train step against the JAX package's unsharded one,
on gloo ranks on the CPU.

Smoke granite in f32 (and internvl2-2b, mamba2-1.3b and
deepseek-moe-16b), on the reference's state, one batch made with numpy:
each rank converts the state and places it by the sharding rules
(`train_state_from_reference(..., mesh=)`: parameters by
`param_pspecs`, master and moments by `opt_pspecs`, ZeRO-1) and its
block of the batch, takes `make_train_step`'s step with the reference's
`logits_pspec` and `grads_pspec`, and rank 0 writes the gathered state.
Two steps, each from the reference's state before it, are held to the
reference's unsharded jitted step on the same state and batch: the loss
and grad_norm, and every leaf of mu, nu (1e-5 · max|·|), the master
weights and the parameters (1e-5, absolute: `test_torch_train.py`'s bar
for the update, which holds an element whose gradient is within rounding
of zero to AdamW's own step bound, 2 lr; see there).

Meshes (data, model): (1, 2), (2, 1) and (2, 2), the last with two
microbatches (against the reference's step with two), and (1, 4), where
smoke granite's 2 kv heads do not split over 4 ranks: `fit_spec`
replicates `wk`/`wv` and each rank slices out the kv head of its one q
head. internvl2-2b at (1, 2). mamba2-1.3b and deepseek-moe-16b at
(2, 1), both held to the reference's one-batch step: mamba2-1.3b with
its rows given unequal counts of valid labels (the token mean over the
global batch), deepseek-moe-16b with its capacity binding (global
routing: the reference drops tokens on that batch). The other families'
model-parallel steps are in `test_torch_train_sharded_zoo.py`.

A (2, 2) run's checkpoint is one global file, which loads in the
unsharded port and in the reference's `restore_pytree` (given a template
laid out as the port's lists of layers), and from which a (1, 2) run
resumes to the unbroken run's next loss. The collectives a step makes,
by kind (`launch.hlo.Counters`, which extends `CommDebugMode`).
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import restore_pytree as jax_restore_pytree
from repro.configs import get_config, smoke
from repro.models import Batch
from repro.training.step import init_train_state as jax_init_train_state
from repro.training.step import make_train_step as jax_make_train_step
import repro_torch.configs as tconfigs
from repro_torch.checkpoint.io import restore_pytree, save_pytree
from repro_torch.convert import train_state_from_reference
from repro_torch.launch import train as ttrain
from repro_torch.optim.adamw import AdamWState
from repro_torch.sharding.rules import opt_pspecs
from repro_torch.substrate import run_probe
from repro_torch.models import Batch as TBatch
from repro_torch.training.step import (
    TrainState, init_train_state, make_train_step,
)
from repro_torch.tree import named_leaves, tree_leaves

F32 = dict(compute_dtype="float32", param_dtype="float32")
KW = dict(peak_lr=1e-3, warmup=4, total_steps=100)
TOL = 1e-5
B, S = 4, 64

# one rank: convert a reference state (a pickle) or restore a checkpoint
# of the port's, placed on the mesh; take one step; rank 0 saves what it
# gathered and the metrics
_RANK = r"""
import dataclasses, json, logging, pickle
import numpy as np
import torch
torch.set_num_threads(1)
logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
    logging.ERROR)
from repro_torch.checkpoint.io import restore_pytree, save_pytree
from repro_torch.configs import get_config, smoke
from repro_torch.convert import train_state_from_reference
from repro_torch.launch.hlo import Counters
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import Batch
from repro_torch.sharding.place import distribute_tree, full_tree
from repro_torch.sharding.rules import (
    NamedSharding, batch_pspecs, logits_pspec, named, opt_pspecs,
)
from repro_torch.substrate import init_from_env
from repro_torch.training.step import (
    init_train_state, make_train_step, shard_train_state,
)
spec = json.load(open(@SPEC@))
rank, world = init_from_env()
mesh = make_host_mesh(spec["model"], device_type="cpu")
cfg = smoke(get_config(spec["arch"]))
changes = dict(spec["changes"])
if "moe" in changes:
    changes["moe"] = dataclasses.replace(cfg.moe, **changes["moe"])
cfg = cfg.replace(compute_dtype="float32", param_dtype="float32", **changes)
data = np.load(spec["batch"])
batch = Batch(*(torch.from_numpy(data[k]) if k in data.files else None
                for k in ("tokens", "labels", "frontend")))
n = batch.tokens.shape[0]
sb = distribute_tree(batch, batch_pspecs(mesh, n, batch.frontend is not None),
                     mesh)
template = shard_train_state(
    init_train_state(torch.Generator().manual_seed(0), cfg), mesh)
step = make_train_step(
    cfg, microbatches=spec["microbatches"], **spec["kw"],
    logits_pspec=NamedSharding(mesh, logits_pspec(
        mesh, cfg.padded_vocab, batch.tokens.shape[1])),
    grads_pspec=named(mesh, opt_pspecs(template.params, mesh)))
out = []
for k, path in enumerate(spec["states"]):
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            state = train_state_from_reference(pickle.load(f), cfg, "cpu",
                                               mesh=mesh)
    else:
        state = restore_pytree(path, template)
    with Counters() as c:
        state, m = step(state, sb)
    out.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "calls": c.calls(), "bytes": c.collectives(),
                "ops": c.ops()})
    if spec.get("save") and spec["save"][k]:
        save_pytree(spec["save"][k], state)
    full = full_tree(state)
    if rank == 0:
        save_pytree(f"{spec['out']}/state{k}", full)
if rank == 0:
    json.dump(out, open(f"{spec['out']}/metrics.json", "w"))
"""


def _run(tmp_path, name, world, **spec) -> list:
    """`_RANK` on `world` gloo ranks with `spec`; rank 0's metrics."""
    out = tmp_path / name
    out.mkdir()
    spec = {"changes": {}, "microbatches": 1, "kw": KW, **spec,
            "out": str(out)}
    path = out / "spec.json"
    path.write_text(json.dumps(spec))
    run = run_probe(_RANK.replace("@SPEC@", repr(str(path))), world=world,
                    timeout=120, pg_timeout=60)
    assert run.ok, run.report()
    return json.loads((out / "metrics.json").read_text())


def _configs(arch, **changes):
    """The reference's and the port's smoke `arch` in f32 with `changes`;
    a `moe` entry is a dict of the nested `MoeConfig`'s fields."""
    out = []
    for c in (smoke(get_config(arch)), tconfigs.smoke(tconfigs.get_config(arch))):
        kw = dict(changes)
        if "moe" in kw:
            kw["moe"] = dataclasses.replace(c.moe, **kw["moe"])
        out.append(c.replace(**F32, **kw))
    return tuple(out)


def _batch_arrays(cfg, seed=7, uneven=False) -> dict:
    """Tokens, labels (the last of each row -1; `uneven`: the second half
    of row 0 too, so the rows' counts of valid labels differ) and, for a
    VLM, stub patches, made with numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    out = {"tokens": toks,
           "labels": np.concatenate([toks[:, 1:],
                                     np.full((B, 1), -1, np.int32)], 1)}
    if uneven:
        out["labels"][0, S // 2:] = -1
    if cfg.frontend is not None:
        out["frontend"] = rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


def _within(got: torch.Tensor, want, tol: float, floor: float):
    """(whether `got` is within tol · max(floor, max|want|) of `want`,
    the error, the bar)."""
    want = np.array(want, dtype=np.float64)
    err = float(np.max(np.abs(got.detach().double().numpy() - want),
                       initial=0.0))
    scale = max(floor, float(np.max(np.abs(want), initial=0.0)))
    return err <= tol * scale, err, tol * scale


def _close(got: torch.Tensor, want, label: str, tol: float = TOL,
           floor: float = 1e-6, port=None) -> None:
    """`got` within the bar of the reference's `want`. Where `port` (the
    unsharded port's value, from the same state) is given and is itself
    outside the bar, the f32 rounding of the one-card port already
    parts from the reference's there, and `got` is held to `port` by the
    same bar instead: the sharding may add nothing to it."""
    ok, err, bar = _within(got, want, tol, floor)
    if ok:
        return
    if port is not None and not _within(port, want, tol, floor)[0]:
        ok, err2, bar2 = _within(got, port.numpy(), tol, floor)
        assert ok, (f"{label}: err {err} > {bar} off the reference, "
                    f"{err2} > {bar2} off the unsharded port")
        return
    assert ok, f"{label}: err {err} > {bar}"


def _reference_steps(jc, tc, arrays, microbatches, tmp_path):
    """The reference's state S0 (its init, seed 0) and two jitted steps:
    (paths of S0 and S1, each pickled in the reference's layout as numpy
    arrays in the port's `TrainState`, whose fields are the reference's,
    for `train_state_from_reference`; [(S1, metrics), (S2, metrics)] in
    the port's layout)."""
    jbatch = Batch(tokens=jnp.asarray(arrays["tokens"]),
                   labels=jnp.asarray(arrays["labels"]),
                   frontend=None if "frontend" not in arrays
                   else jnp.asarray(arrays["frontend"]))
    step = jax.jit(jax_make_train_step(jc, microbatches=microbatches, **KW))
    js = jax_init_train_state(jax.random.PRNGKey(0), jc)
    paths, want = [], []
    for k in range(2):
        path = str(tmp_path / f"ref_state{k}.pkl")
        with open(path, "wb") as f:
            pickle.dump(TrainState(
                params=jax.tree.map(np.asarray, js.params),
                opt=AdamWState(*(jax.tree.map(np.asarray, t)
                                 for t in js.opt[:3]),
                               np.asarray(js.opt.count)),
                step=np.asarray(js.step)), f)
        paths.append(path)
        js, jm = step(js, jbatch)
        want.append((train_state_from_reference(js, tc, "cpu"),
                     {k: float(v) for k, v in jm.items()}))
    return paths, want


def _check_step(got_path, want, metrics, label, port=None):
    """The gathered state after one sharded step against the reference's
    (see the module docstring for the bars); `port`, the unsharded port's
    (state, metrics) from the same state, where a leaf may be held to it
    (`_close`)."""
    state, jm = want
    got = restore_pytree(got_path, state)
    ps, pm = port or (None, {})

    def pick(leaves, i, mask=None):
        if leaves is None:
            return None
        return leaves[i] if mask is None else leaves[i][mask]

    _close(torch.tensor(metrics["loss"]), jm["loss"], f"{label} loss",
           port=None if ps is None else torch.tensor(pm["loss"]))
    _close(torch.tensor(metrics["grad_norm"]), jm["grad_norm"],
           f"{label} grad_norm",
           port=None if ps is None else torch.tensor(pm["grad_norm"]))
    assert int(got.step) == int(state.step)
    assert int(got.opt.count) == int(state.opt.count)
    for name in ("mu", "nu"):
        mine = None if ps is None else tree_leaves(getattr(ps.opt, name))
        for i, (g, w) in enumerate(zip(tree_leaves(getattr(got.opt, name)),
                                       tree_leaves(getattr(state.opt, name)))):
            _close(g, w.numpy(), f"{label} {name}", port=pick(mine, i))
    lr, small = jm["lr"], 0
    for name, g_tree, w_tree in (("master", got.opt.master, state.opt.master),
                                 ("params", got.params, state.params)):
        mine = None if ps is None else tree_leaves(
            ps.opt.master if name == "master" else ps.params)
        for i, (g, w, mu) in enumerate(zip(tree_leaves(g_tree),
                                           tree_leaves(w_tree),
                                           tree_leaves(state.opt.mu))):
            tiny = (torch.abs(mu) < 0.1 * 1e-7) & (mu != 0)
            _close(g[~tiny], w[~tiny].numpy(), f"{label} {name}", floor=1.0,
                   port=pick(mine, i, ~tiny))
            _close(g[tiny], w[tiny].numpy(), f"{label} {name} |g| < 1e-7",
                   tol=2 * lr, floor=1.0, port=pick(mine, i, tiny))
            small += int(tiny.sum())
    n = sum(p.numel() for p in tree_leaves(state.params))
    assert small <= 1e-3 * 2 * n, f"{label}: {small} of {n} tiny gradients"


def _port_steps(tc, arrays, microbatches, paths):
    """The unsharded port's step, on plain tensors, from each of the
    reference's states at `paths`: [(state, metrics)]."""
    step = make_train_step(tc, microbatches=microbatches, **KW)
    batch = TBatch(*(torch.from_numpy(arrays[k]) if k in arrays else None
                     for k in ("tokens", "labels", "frontend")))
    out = []
    for path in paths:
        with open(path, "rb") as f:
            state = train_state_from_reference(pickle.load(f), tc, "cpu")
        state, m = step(state, batch)
        out.append((state, {k: float(v) for k, v in m.items()}))
    return out


def _held_to_reference(tmp_path, arch, mesh, microbatches=1,
                       ref_microbatches=None, uneven=False, port_floor=False,
                       **changes):
    """Two sharded steps of `arch` on `mesh`, each held to the
    reference's step from the same state; with `port_floor`, a leaf
    where the unsharded port's own step parts from the reference's by
    more than the bar is held to the unsharded port's (`_close`)."""
    jc, tc = _configs(arch, **changes)
    arrays = _batch_arrays(tc, uneven=uneven)
    np.savez(tmp_path / "batch.npz", **arrays)
    paths, want = _reference_steps(
        jc, tc, arrays, ref_microbatches or microbatches, tmp_path)
    port = (_port_steps(tc, arrays, microbatches, paths) if port_floor
            else [None, None])
    metrics = _run(tmp_path, "run", mesh[0] * mesh[1], arch=arch,
                   model=mesh[1], microbatches=microbatches, states=paths,
                   batch=str(tmp_path / "batch.npz"), changes=changes)
    for k in range(2):
        _check_step(str(tmp_path / "run" / f"state{k}"), want[k], metrics[k],
                    f"{arch} {mesh} step {k}", port=port[k])
    return metrics


@pytest.mark.parametrize("mesh, microbatches", [((1, 2), 1), ((2, 1), 1),
                                                ((2, 2), 2), ((1, 4), 1)],
                         ids=["1x2", "2x1", "2x2-mb2", "1x4-kv-replicated"])
def test_sharded_step_matches_reference(tmp_path, mesh, microbatches):
    _held_to_reference(tmp_path, "granite-3-2b", mesh, microbatches)


def test_sharded_vlm_matches_reference(tmp_path):
    _held_to_reference(tmp_path, "internvl2-2b", (1, 2))


# smoke deepseek-moe-16b with C = ⌈T·K·0.75/E⌉ slots an expert: fewer
# than the T·K choices, so the capacity binds and tokens are dropped
BINDING = {"moe": {"capacity_factor": 0.75}}


def _reference_drops(arch, arrays, **changes) -> list:
    """The reference's `moe_drop_frac` of each MoE layer on the batch of
    `arrays`, from its own forward on its seed-0 state (read out of its
    scan by `jax.debug.callback`)."""
    import repro.models.backbone as jbackbone
    from repro.models import forward_train as jax_forward_train
    jc, _ = _configs(arch, **changes)
    drops, inner = [], jbackbone.moe_apply

    def recorded(p, x, cfg):
        out, aux = inner(p, x, cfg)
        jax.debug.callback(lambda v: drops.append(float(v)),
                           aux["moe_drop_frac"])
        return out, aux

    js = jax_init_train_state(jax.random.PRNGKey(0), jc)
    batch = Batch(tokens=jnp.asarray(arrays["tokens"]),
                  labels=jnp.asarray(arrays["labels"]))
    jbackbone.moe_apply = recorded
    try:
        jax.block_until_ready(jax_forward_train(js.params, jc, batch,
                                                remat=False))
        jax.effects_barrier()
    finally:
        jbackbone.moe_apply = inner
    return drops


@pytest.mark.parametrize("arch, uneven, changes",
                         [("mamba2-1.3b", True, {}),
                          ("deepseek-moe-16b", False, BINDING)],
                         ids=["mamba2-1.3b", "deepseek-moe-16b"])
def test_data_only_mesh_runs_the_other_families(tmp_path, arch, uneven,
                                                changes):
    """On (2, 1), held to the reference's one-batch step. The SSM mixes
    no rows: with the ranks' counts of valid labels unequal, its loss is
    the token mean over the global batch, where a mean of the ranks'
    means would not be. The MoE routes the global batch (each rank
    gathers the rows): its capacity binds (the reference drops tokens on
    this batch), so routing each rank's rows alone would drop other
    tokens and fail here."""
    if changes:
        jc, tc = _configs(arch, **changes)
        drops = _reference_drops(arch, _batch_arrays(tc), **changes)
        assert drops and min(drops) > 0, drops
    _held_to_reference(tmp_path, arch, (2, 1), uneven=uneven, **changes)


def test_model_axis_without_ranks_says_how_to_start_them(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "REPRO_INIT_FILE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(SystemExit, match="RANK, WORLD_SIZE, REPRO_INIT_FILE"):
        ttrain.main(["--device", "cpu", "--model-axis", "2"])


def _port_layout(tree, cfg):
    """A reference train state re-laid as the port's trees (lists of
    per-layer dicts), as JAX arrays, keeping the reference's NamedTuple
    types: a template for the reference's `restore_pytree` of a file the
    port wrote."""
    port = train_state_from_reference(tree, cfg, "cpu")
    as_jax = jax.tree.map(lambda x: jnp.asarray(x.numpy()),
                          [port.params, *port.opt[:3]],
                          is_leaf=lambda x: isinstance(x, torch.Tensor))
    opt = type(tree.opt)(*as_jax[1:], count=tree.opt.count)
    return type(tree)(params=as_jax[0], opt=opt, step=tree.step)


def test_sharded_checkpoint_is_one_global_file(tmp_path):
    """(2, 2): a step, then the state saved (rank 0 writes the gathered
    file), then the next step (the unbroken run). The file loads in the
    unsharded port and in the reference; (1, 2) resumes from it to the
    unbroken run's next loss and state."""
    jc, tc = _configs("granite-3-2b")
    arrays = _batch_arrays(tc)
    np.savez(tmp_path / "batch.npz", **arrays)
    paths, want = _reference_steps(jc, tc, arrays, 1, tmp_path)
    ck = str(tmp_path / "ckpt")
    unbroken = _run(tmp_path, "unbroken", 4, arch="granite-3-2b", model=2,
                    states=[paths[0], ck + ".npz"], save=[ck, None],
                    batch=str(tmp_path / "batch.npz"))
    assert sorted(os.listdir(tmp_path)).count("ckpt.npz") == 1
    # the unsharded port
    state = restore_pytree(ck, init_train_state(
        torch.Generator().manual_seed(0), tc))
    first = restore_pytree(str(tmp_path / "unbroken" / "state0"), state)
    for a, b in zip(tree_leaves(state), tree_leaves(first)):
        assert torch.equal(a, b)
    _check_step(ck, want[0], unbroken[0], "checkpoint")
    # the reference, into a template laid out as the port's trees
    jstate = jax_init_train_state(jax.random.PRNGKey(0), jc)
    back = jax_restore_pytree(ck, _port_layout(jstate, tc))
    for (name, a), b in zip(named_leaves(state).items(),
                            jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.array(b), a.numpy(), err_msg=name)
    resumed = _run(tmp_path, "resumed", 2, arch="granite-3-2b", model=2,
                   states=[ck + ".npz"], batch=str(tmp_path / "batch.npz"))
    _close(torch.tensor(resumed[0]["loss"]), unbroken[1]["loss"],
           "resumed loss")
    a = restore_pytree(str(tmp_path / "resumed" / "state0"), state)
    b = restore_pytree(str(tmp_path / "unbroken" / "state1"), state)
    for (name, x), y in zip(named_leaves(a).items(), tree_leaves(b)):
        _close(x, y.numpy(), f"resumed {name}", floor=1.0)


def _init_state(tmp_path, tc, name) -> str:
    """The port's own seed-0 state for `tc`, saved; its path."""
    path = str(tmp_path / name)
    save_pytree(path, init_train_state(torch.Generator().manual_seed(0), tc))
    return path + ".npz"


def test_step_collectives_by_kind(tmp_path):
    """The collectives of one step, by kind. (1, 2), tensor parallel: five
    all-reduces a layer, each of a (B, S, d) f32 activation (the
    attention's and the MLP's outputs in the forward, the attention's
    again in remat's recompute, which stops at the last tensor the
    backward saves, before the MLP's output, and the gradients of the two
    blocks' inputs in the backward), read as the difference between 4 and
    2 layers; no reduce-scatter, and no all-gather of an activation.
    (2, 1), ZeRO-1: one reduce-scatter a gradient leaf that `opt_pspecs`
    splits over `data`, and one all-gather of its new parameter."""
    arrays = _batch_arrays(_configs("granite-3-2b")[1])
    np.savez(tmp_path / "batch.npz", **arrays)
    got = {}
    for n_layers in (2, 4):
        tc = _configs("granite-3-2b", n_layers=n_layers)[1]
        got[n_layers] = _run(
            tmp_path, f"tp{n_layers}", 2, arch="granite-3-2b", model=2,
            states=[_init_state(tmp_path, tc, f"init{n_layers}")],
            batch=str(tmp_path / "batch.npz"),
            changes={"n_layers": n_layers})[0]
    act = B * S * tc.d_model * 4
    two, four = got[2], got[4]
    assert "reduce-scatter" not in two["calls"] and \
        "all-to-all" not in two["calls"], two["calls"]
    assert four["calls"]["all-reduce"] - two["calls"]["all-reduce"] == 2 * 5
    # the byte model counts an all-reduce twice
    assert four["bytes"]["all-reduce"] - two["bytes"]["all-reduce"] == \
        2 * 5 * 2 * act
    # no all-gather is a layer's: as many, of as many bytes, at 4 layers
    assert two["calls"].get("all-gather") == four["calls"].get("all-gather")
    assert two["bytes"].get("all-gather") == four["bytes"].get("all-gather")

    tc = _configs("granite-3-2b")[1]
    zero = _run(tmp_path, "zero", 2, arch="granite-3-2b", model=1,
                states=[_init_state(tmp_path, tc, "init")],
                batch=str(tmp_path / "batch.npz"))[0]
    split = sum("data" in tuple(s) for s in named_leaves(opt_pspecs(
        init_train_state(torch.Generator().manual_seed(0), tc).params,
        {"data": 2, "model": 1})).values())
    assert zero["calls"]["reduce-scatter"] == split
    # the write-back: the new parameter of each leaf split over `data`
    assert zero["calls"]["all-gather"] == split


_INIT = r"""
import torch
from repro_torch.configs import get_config, smoke
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.substrate import init_from_env
from repro_torch.training.step import (
    init_sharded_train_state, init_train_state, shard_train_state,
)
from repro_torch.tree import named_leaves
init_from_env()
mesh = make_host_mesh(2, device_type="cpu")
cfg = smoke(get_config("granite-3-2b"))
a = shard_train_state(init_train_state(torch.Generator().manual_seed(0), cfg),
                      mesh)
b = init_sharded_train_state(torch.Generator().manual_seed(0), cfg, mesh)
la, lb = named_leaves(a), named_leaves(b)
assert list(la) == list(lb)
for name in la:
    x, y = la[name], lb[name]
    if hasattr(x, "placements"):
        assert x.placements == y.placements, name
        x, y = x.to_local(), y.to_local()
    assert x.dtype == y.dtype and torch.equal(x, y), name
"""


def test_init_sharded_train_state_is_the_sharded_init(tmp_path):
    """Every rank's blocks of `init_sharded_train_state` (leaf by leaf,
    no whole f32 state) are `shard_train_state(init_train_state(...))`'s:
    the same placements and bits, on a (2, 2) mesh."""
    run = run_probe(_INIT, world=4, timeout=120, pg_timeout=60)
    assert run.ok, run.report()
