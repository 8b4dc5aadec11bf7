"""Dry run of the sharded train, prefill and decode steps on a fake 256-
or 512-rank mesh.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b \
        --shape train_4k[,prefill_32k,...] [--multi-pod | --both-meshes | \
        --mesh DxM] [--reduced] [--all] [--out experiments/dryrun_torch]

The port of the JAX package's `launch/dryrun.py` by purpose. The
reference lowers and compiles each (arch x shape x mesh) step for 256
(512) forced host devices and reads XLA's analyses. The port runs its own
steps on `FakeTensorMode` tensors, as rank 0 of a fake process group of
256 (or 512) ranks (`torch.testing._internal.distributed.fake_pg`):
every op and collective runs on shapes alone, nothing is computed or
allocated and nothing is sent. `train_4k` runs the train step
(`training.step.make_train_step`, sharded by `sharding.rules` as
`launch/train.py` shards it); `prefill_32k` runs
`serving.engine.make_prefill_step(cfg, cache_len=S)` on parameters
placed by `param_pspecs` and a batch by `batch_pspecs`; `decode_32k`
and `long_500k` run `make_serve_step(cfg)` on those parameters, one
token placed as `batch_pspecs(...).tokens`, the position S - 1 (a host
integer) and caches of S slots placed by `cache_pspecs`, as the
reference lowers them. `launch.hlo.Counters` counts what rank 0 does.
One JSON record a combination, with the reference's fields where torch
can give them:

  flops_per_chip             FLOPs on rank 0's local shapes;
  bytes_per_chip             its ops' input and output bytes (eager, no
                             fusion: an upper bound of its HBM traffic);
  collective_bytes_per_chip  by kind and total (an all-reduce twice),
                             with `collective_calls`;
  memory                     `argument_size_in_bytes`: rank 0's local
                             shards of the step's arguments (the train
                             state or the parameters, the batch or the
                             token, the caches); `temp_size_in_bytes`:
                             null (no compiler to ask for its
                             temporaries);
  roofline                   the three terms at the H100's data-sheet
                             peaks (`launch.mesh.HW`) and the bottleneck;
  model_flops, useful_ratio  6 · active parameters · tokens for a train
                             step, 2 · active parameters · tokens for
                             prefill (B · S tokens) and decode (B), over
                             all ranks' FLOPs;
  per_device_bytes           parameters, optimizer state, batch and (for
                             decode shapes) caches on one rank, from the
                             rules and the `meta` shapes alone;
  microbatches (0 for serving), n_params, n_active.

Microbatches: the smallest power of two (at most 16, dividing the local
batch) that keeps the residual stream remat saves (layers x local batch
/ microbatches x sequence x d_model, bf16) under a quarter of the
card's 80 GB, the share of the reference's rule for its 16 GB card.

The fake group becomes the default process group, so the dry run is a
program of its own; tests run it in a subprocess.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import logging
import math
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.configs import ASSIGNED, smoke
from repro_torch.launch.hlo import Counters, roofline
from repro_torch.launch.mesh import HW, make_production_mesh
from repro_torch.launch.specs import SHAPES, input_specs
from repro_torch.models import Batch
from repro_torch.serving.engine import make_prefill_step, make_serve_step
from repro_torch.sharding.place import distribute_tree
from repro_torch.sharding.rules import (
    NamedSharding, axis_sizes, batch_pspecs, cache_pspecs, logits_pspec,
    named, opt_pspecs, param_pspecs,
)
from repro_torch.substrate.mesh import make_mesh
from repro_torch.training.step import make_train_step, shard_train_state
from repro_torch.tree import map_leaves, named_leaves

# the remat residual stream's share of the card's memory (see above)
RESIDUAL_SHARE = 0.25
MAX_MICROBATCHES = 16


@contextlib.contextmanager
def fake_group(world: int):
    """A fake default process group of `world` ranks, this process rank 0,
    for the duration."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def microbatches_for(cfg, local_batch: int, seq: int) -> int:
    resid = cfg.n_layers * local_batch * seq * cfg.d_model * 2
    budget = RESIDUAL_SHARE * HW["hbm_bytes"]
    micro = 1
    while micro < MAX_MICROBATCHES and resid / micro > budget \
            and local_batch % (2 * micro) == 0:
        micro *= 2
    return micro


def _local_bytes(tree, specs, sizes: dict, itemsize: int | None = None
                 ) -> int:
    """Bytes of one rank's blocks of `tree`'s leaves under `specs`
    (a dim split over axes a, b holds 1 / (|a| |b|) of it), each element
    of `itemsize` bytes where given, else of its leaf's dtype."""
    spec_of = named_leaves(specs)
    total = 0
    for name, x in named_leaves(tree).items():
        n = x.numel()
        for ax in spec_of[name]:
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                if a is not None:
                    n //= sizes[a]
        total += n * (itemsize or x.element_size())
    return total


def per_device_bytes(arch: str, shape: str, sizes: dict) -> dict | None:
    """One rank's bytes of parameters (compute dtype, `param_pspecs`),
    optimizer state (f32 master and moments, `opt_pspecs`), the batch
    and, for decode shapes, the caches (`cache_pspecs`), from the `meta`
    shapes alone."""
    spec = input_specs(arch, shape)
    if spec is None:
        return None
    B = SHAPES[shape]["batch"]
    params = spec.args[0].params if spec.mode == "train" else spec.args[0]
    out = {"params": _local_bytes(params, param_pspecs(params, sizes),
                                  sizes),
           # f32 master, mu and nu
           "opt": 3 * _local_bytes(params, opt_pspecs(params, sizes), sizes,
                                   itemsize=4) if spec.mode == "train"
           else 0}
    if spec.mode == "decode":
        caches = spec.args[3]
        out["caches"] = _local_bytes(caches, cache_pspecs(sizes, caches, B),
                                     sizes)
        out["batch"] = _local_bytes(spec.args[1],
                                    batch_pspecs(sizes, B).tokens, sizes)
    else:
        batch = spec.args[1]
        bspec = batch_pspecs(sizes, B, batch.frontend is not None)
        out["batch"] = _local_bytes(batch, Batch(
            tokens=bspec.tokens,
            labels=bspec.labels if batch.labels is not None else None,
            frontend=bspec.frontend), sizes)
    out["total"] = sum(out.values())
    return out


def _fake_like(fm, tree):
    """`tree`'s meta tensors as fake CPU tensors of `fm` (no memory)."""
    with fm:
        return map_leaves(lambda _, x: torch.empty(x.shape, dtype=x.dtype),
                          tree)


def _local_args(tree) -> int:
    """Bytes of this rank's local tensors of `tree`'s leaves."""
    return sum((x.to_local() if isinstance(x, DTensor) else x).numel()
               * x.element_size() for x in named_leaves(tree).values()
               if isinstance(x, torch.Tensor))


def _record(cfg, mesh, k: Counters, t_run: float, args: int,
            model_flops: float, micro: int) -> dict:
    coll = k.collectives()
    return {
        "t_run_s": round(t_run, 2),
        "flops_per_chip": float(k.flops), "bytes_per_chip": float(k.bytes),
        "collective_bytes_per_chip": coll, "collective_calls": k.calls(),
        "memory": {"argument_size_in_bytes": args,
                   "temp_size_in_bytes": None},
        "roofline": roofline(k.flops, k.bytes, coll["total"]),
        "model_flops": model_flops,
        "useful_ratio": model_flops / max(k.flops * mesh.size(), 1.0),
        "n_params": cfg.param_count(), "n_active": cfg.active_param_count(),
        "microbatches": micro,
    }


def train_record(cfg, spec, mesh, seq: int) -> dict:
    """Run one sharded train step of `spec` (fake tensors) on `mesh` and
    count rank 0's work; its tokens are batch × `seq`, the context (the
    VLM's patches included), as the reference counts them."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    sizes = axis_sizes(mesh)
    state, batch = spec.args
    B, S = batch.tokens.shape
    dp = math.prod(sizes[a] for a in ("pod", "data") if a in sizes)
    micro = microbatches_for(cfg, B // dp, S)
    fm = FakeTensorMode()
    state, batch = _fake_like(fm, (state, batch))
    with fm:
        state = shard_train_state(state, mesh)
        batch = distribute_tree(batch, batch_pspecs(
            mesh, B, batch.frontend is not None), mesh)
        step = make_train_step(
            cfg, microbatches=micro,
            logits_pspec=NamedSharding(mesh, logits_pspec(
                mesh, cfg.padded_vocab, S)),
            grads_pspec=named(mesh, opt_pspecs(state.params, mesh)))
        args = _local_args((state, batch))
        t0 = time.time()
        with Counters() as k:
            step(state, batch)
        t_run = time.time() - t0
    return _record(cfg, mesh, k, t_run, args,
                   6 * cfg.active_param_count() * B * seq, micro)


def serve_record(cfg, spec, mesh, seq: int) -> dict:
    """Run one sharded prefill (of a prompt whose context is `seq`, into
    a cache of `seq` slots) or decode step (one token at position
    seq - 1 against caches of `seq` slots) of `spec` on fake tensors on
    `mesh`, placed as the reference's dry run places them, and count
    rank 0's work."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    fm = FakeTensorMode()
    args = _fake_like(fm, spec.args)
    params = args[0]
    with fm:
        sp = distribute_tree(params, param_pspecs(params, mesh), mesh)
        if spec.mode == "prefill":
            batch = args[1]
            B = batch.tokens.shape[0]
            sb = distribute_tree(batch, batch_pspecs(
                mesh, B, batch.frontend is not None), mesh)
            step, inputs = make_prefill_step(cfg, cache_len=seq), (sp, sb)
            tokens = B * seq
        else:
            _, token, _, caches = args
            B = token.shape[0]
            st = distribute_tree(token, batch_pspecs(mesh, B).tokens, mesh)
            sc = distribute_tree(caches, cache_pspecs(mesh, caches, B), mesh)
            step, inputs = make_serve_step(cfg), (sp, st, seq - 1, sc)
            tokens = B
        arg_bytes = _local_args(inputs)
        t0 = time.time()
        with Counters() as k:
            step(*inputs)
        t_run = time.time() - t0
    return _record(cfg, mesh, k, t_run, arg_bytes,
                   2 * cfg.active_param_count() * tokens, 0)


def lower_combo(arch: str, shape: str, *, multi_pod: bool,
                mesh_override: tuple | None = None,
                reduced: bool = False) -> dict:
    """One (arch x shape x mesh) record; the fake group must span the
    mesh. `reduced` runs the smoke-sized configuration."""
    mesh_name = ("x".join(map(str, mesh_override)) if mesh_override
                 else ("2x16x16" if multi_pod else "16x16"))
    spec = input_specs(arch, shape)
    if spec is None:
        return {"arch": arch, "shape": shape, "mesh": mesh_name,
                "status": "skipped",
                "note": "long_500k out of regime for enc-dec"}
    if reduced:
        spec = input_specs(arch, shape, cfg=smoke(spec.cfg))
    cfg = spec.cfg
    if mesh_override:
        mesh = make_mesh(tuple(mesh_override), ("data", "model"), "cpu")
    else:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    sizes = axis_sizes(mesh)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
           "mode": spec.mode, "note": spec.note, "reduced": reduced,
           "per_device_bytes": per_device_bytes(arch, shape, sizes)
           if not reduced else None}
    seq = SHAPES[shape]["seq"]
    record = train_record if spec.mode == "train" else serve_record
    rec.update(status="ok", **record(cfg, spec, mesh, seq))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description="Multi-pod dry-run")
    ap.add_argument("--arch", default=None,
                    help="one family, or several separated by commas")
    ap.add_argument("--shape", default=None,
                    help=f"of {', '.join(SHAPES)}; several separated by "
                    "commas")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="DxM single-pod override, e.g. 32x8")
    ap.add_argument("--reduced", action="store_true",
                    help="the smoke-sized configurations")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)
    mesh_override = (tuple(int(x) for x in args.mesh.split("x"))
                     if args.mesh else None)
    # DTensor warns at every two-dim reduction of the gradient norm
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)

    archs = ASSIGNED if args.all or args.arch is None \
        else args.arch.split(",")
    shapes = list(SHAPES) if args.all or args.shape is None \
        else args.shape.split(",")
    unknown = [s for s in shapes if s not in SHAPES]
    if unknown:
        ap.error(f"unknown shape {unknown}: one of {list(SHAPES)}")
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    os.makedirs(args.out, exist_ok=True)
    for mp in meshes:
        world = (math.prod(mesh_override) if mesh_override
                 else (512 if mp else 256))
        mesh_name = args.mesh if mesh_override else (
            "2x16x16" if mp else "16x16")
        with fake_group(world):
            for arch in archs:
                for shape in shapes:
                    tag = f"{arch}__{shape}__{mesh_name}" + (
                        "__reduced" if args.reduced else "")
                    path = os.path.join(args.out, tag + ".json")
                    print(f"[dryrun] {tag} ...", flush=True)
                    try:
                        rec = lower_combo(arch, shape, multi_pod=mp,
                                          mesh_override=mesh_override,
                                          reduced=args.reduced)
                    except Exception as e:  # record failures as bugs to fix
                        rec = {"arch": arch, "shape": shape,
                               "mesh": mesh_name, "status": "error",
                               "error": repr(e),
                               "traceback": traceback.format_exc()}
                    with open(path, "w") as f:
                        json.dump(rec, f, indent=2)
                    rf = rec.get("roofline", {})
                    print(f"  -> {rec['status']} run={rec.get('t_run_s', '-')}"
                          f"s bottleneck={rf.get('bottleneck', '-')}",
                          flush=True)


if __name__ == "__main__":
    main()
