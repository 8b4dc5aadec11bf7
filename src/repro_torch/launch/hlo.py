"""Per-rank counters of a sharded program, and the three-term roofline.

The port of the JAX package's `launch/hlo.py` by purpose. The reference
parses the post-SPMD HLO module of a compiled step: the FLOPs of every
dot, operand and output bytes, and collective bytes by kind, each scaled
by its while loop's trip count. PyTorch runs eagerly and has no module to
parse, so the port counts the same quantities as the program runs (on
fake tensors in the dry run: nothing is computed or allocated), in one
dispatch mode, `Counters`:

  flops       — `torch.utils.flop_counter`'s formulas (2·M·N·K a
                product, the attention ops'), on each rank's LOCAL
                shapes: for a DTensor op the mode steps aside and counts
                the local ops DTensor runs (a mode that ran above DTensor
                would see global shapes);
  bytes       — every local op's input and output bytes: the eager
                program's device-memory traffic, each op a kernel (no
                fusion), the reference's per-instruction upper bound;
  collectives — calls and bytes by kind, from `CommDebugMode` (which it
                extends): DTensor's own collectives and any
                `torch.distributed` call, under the reference's byte
                model (the bytes of the collective's output on a rank,
                an all-reduce counted twice).

`roofline` turns per-rank FLOPs, bytes and collective bytes into seconds
at the port's `HW` (the H100 SXM's data-sheet peaks).
"""
from __future__ import annotations

from collections import defaultdict

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.launch.mesh import HW

# the reference's kinds; a name fragment of the op's overload packet
_KINDS = (("all_gather", "all-gather"), ("allgather", "all-gather"),
          ("reduce_scatter", "reduce-scatter"),
          ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
          ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
          ("broadcast", "broadcast"))
# all-reduce moves ~2x the buffer (reduce-scatter + all-gather phases)
_MULT = {"all-reduce": 2.0}


def _kind(packet) -> str | None:
    """The collective kind of a communication op ("other" for a wait or a
    barrier), None for any other op."""
    name = str(packet)
    if "c10d" not in name:
        return None
    for frag, kind in _KINDS:
        if frag in name:
            return kind
    return "other"


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class Counters(CommDebugMode):
    """A rank's FLOPs, bytes and collectives while the mode is active
    (see the module docstring). `collectives()` gives {kind: bytes,
    "total": bytes}, `calls()` {kind: calls}.

    DTensor infers an op's output shape by running it once on fake
    tensors of the global shapes (its sharding propagation,
    `ShardingPropagator._propagate_tensor_meta_non_cached`, cached by
    shape), through whatever modes are active; those runs are no work of
    the rank's, and the mode counts nothing while one is under way."""

    def __init__(self):
        super().__init__()
        self._in_propagation = 0
        self._unwrap = None
        self.flops = 0
        self.bytes = 0
        self._coll_bytes: dict = defaultdict(float)
        self._coll_calls: dict = defaultdict(int)
        self._coll_ops: dict = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if isinstance(func, torch._ops.HigherOrderOperator) or \
                any(t == DTensor for t in types):
            # DTensor desugars into local ops and collectives, which
            # come back through this mode
            return super().__torch_dispatch__(func, types, args, kwargs)
        kwargs = kwargs or {}
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if self._in_propagation:
            return out
        packet = func._overloadpacket
        kind = _kind(packet)
        if kind is not None:
            if kind != "other":
                self._coll_calls[kind] += 1
                self._coll_ops[str(packet)] += 1
                # an op that returns only its work object (the ledger's
                # all-to-all) wrote into its first argument
                nbytes = _nbytes(out) or _nbytes(args[:1])
                self._coll_bytes[kind] += nbytes * _MULT.get(kind, 1.0)
            return out
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        return out

    def __enter__(self):
        orig = ShardingPropagator._propagate_tensor_meta_non_cached

        def counted(prop, op_schema):
            self._in_propagation += 1
            try:
                return orig(prop, op_schema)
            finally:
                self._in_propagation -= 1

        ShardingPropagator._propagate_tensor_meta_non_cached = counted
        self._unwrap = orig
        return super().__enter__()

    def __exit__(self, *exc):
        ShardingPropagator._propagate_tensor_meta_non_cached = self._unwrap
        return super().__exit__(*exc)

    def collectives(self) -> dict:
        out = dict(self._coll_bytes)
        out["total"] = sum(self._coll_bytes.values())
        return out

    def calls(self) -> dict:
        return dict(self._coll_calls)

    def ops(self) -> dict:
        """{op: calls} of the collectives by the op that ran them: DTensor's
        functional ones (`_c10d_functional.*`) apart from the synchronous
        `torch.distributed` calls of the ledger (`c10d.*`)."""
        return dict(self._coll_ops)


def roofline(flops: float, bytes_accessed: float, coll_bytes: float) -> dict:
    """Three roofline terms in seconds from per-rank quantities, at the
    port's `HW`: compute at the bf16 tensor-core peak, memory at the HBM
    rate, collectives at one NVLink direction's rate."""
    t_compute = flops / HW["peak_flops_bf16"]
    t_memory = bytes_accessed / HW["hbm_bw"]
    t_coll = coll_bytes / HW["link_bw"]
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    terms["bottleneck"] = max(terms, key=lambda k: terms[k]
                              if k.endswith("_s") else -1).replace("_s", "")
    return terms
