"""Sharding rules: map parameter/activation/cache trees to partition specs,
and specs to DTensor placements.

The port of the JAX package's `sharding/rules.py`, in its spec language:
a `P` has one entry per tensor dim, each a mesh axis name, a tuple of
names (the dim split over several axes, major to minor) or None
(replicated), so the rules read as the reference's and compare with them
leaf by leaf (`tuple(spec)`).

Scheme:
  * `model` axis: tensor parallel: attention heads, ffn width, experts,
    vocab (embedding rows / head columns), decode-cache sequence.
  * `data` axis: FSDP of the f32 optimizer state (ZeRO-1): the d_model
    dimension of weight matrices; the batch dimension of activations.
  * `pod` axis (multi-pod mesh): pure data parallelism: parameters are
    replicated across pods; the batch is sharded over (pod, data).

Rules are right-aligned, so a leaf with a leading layer axis (the
reference's scanned stacks) and the port's per-layer leaf (lists of
layers, `tree.py` paths such as `layers/0/attn/wq`) get the same spec for
the same dims. Every proposed axis is checked for divisibility against
the dim's size; an axis that does not divide is dropped (replicated),
never moved to another dim (see `fit_spec`).

A mesh here is its axis names and sizes: a `DeviceMesh` with named dims,
or a mapping {axis: size} in mesh order, so the rules run without a
process group (the dry run's 256-rank mesh, the CPU tests). `placements`
turns a spec into the DTensor placements of a `DeviceMesh`.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from repro_torch.tree import map_leaves, tree_map


def _entry(ax):
    """A spec entry as JAX's PartitionSpec keeps it: a one-name tuple is
    the name, an empty one None."""
    if isinstance(ax, (tuple, list)):
        ax = tuple(ax)
        return None if not ax else (ax[0] if len(ax) == 1 else ax)
    return ax


class P:
    """A partition spec: one entry per tensor dim (axis name, tuple of
    names, or None). Iterates, indexes and compares as the tuple of its
    entries. Not a tuple itself, so that `tree.py` walks a tree of specs
    with each spec as one leaf."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(_entry(e) for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        if isinstance(other, P):
            return self.entries == other.entries
        return isinstance(other, tuple) and self.entries == other

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return f"P{self.entries!r}"


def axis_sizes(mesh) -> dict:
    """{axis: size} in mesh order, from a `DeviceMesh` with named dims or
    a mapping."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    if isinstance(mesh, Mapping):
        return dict(mesh)
    raise TypeError(f"not a mesh: {type(mesh).__name__}")


def dp_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel activation axes: ('pod', 'data') when multi-pod."""
    names = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _axis_size(sizes: dict, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= sizes[a]
        return n
    return sizes[axis]


def _align(shape: Sequence[int], right: Sequence) -> list:
    nd = len(shape)
    spec: list = [None] * nd
    take = min(len(right), nd)
    if take:
        spec[nd - take:] = list(right[len(right) - take:])
    return spec


def _fits(shape: Sequence[int], spec: Sequence, sizes: dict) -> bool:
    return all(ax is None or shape[i] % _axis_size(sizes, ax) == 0
               for i, ax in enumerate(spec))


def fit_spec(shape: Sequence[int], right: Sequence, mesh) -> P:
    """Right-align `right` onto `shape`; axes that do not divide their dim
    are DROPPED (replicated), never moved to another dim: moving TP onto
    e.g. the head_dim would make RoPE's half-split reshard every layer.
    Replicating the offending (small) projection matches production TP
    practice for GQA with kv_heads < TP degree."""
    sizes = axis_sizes(mesh)
    spec = _align(shape, right)
    for i, ax in enumerate(spec):
        if ax is not None and shape[i] % _axis_size(sizes, ax) != 0:
            spec[i] = None
    return P(*spec)


def fit_first(shape: Sequence[int], proposals: Sequence[Sequence],
              mesh) -> P:
    """Try each proposal in order; the first that fully divides wins. If
    none fits, fall back to the first proposal with failing axes
    dropped."""
    sizes = axis_sizes(mesh)
    for right in proposals:
        spec = _align(shape, right)
        if _fits(shape, spec, sizes):
            return P(*spec)
    return fit_spec(shape, proposals[0], mesh)


# (path-substring, proposal list): the first path match wins; within a
# match, the first proposal whose axes all divide is used (else axes are
# dropped). The reference's table, in its order.
_PARAM_RULES: Tuple[Tuple[str, Tuple[Tuple[Optional[str], ...], ...]], ...] = (
    # MoE expert stacks (E, d, f) / (E, f, d): experts over `model` (EP)
    ("experts/w_down", (("model", None, "data"),)),
    ("experts/",       (("model", "data", None),)),
    ("router",         ((None, "model"),)),
    # attention projections
    ("wq", (("data", "model", None),)),
    ("wk", (("data", "model", None),)),
    ("wv", (("data", "model", None),)),
    ("wo", (("model", None, "data"),)),
    # dense mlp / shared experts / griffin gate+in projections
    ("w_down", (("model", "data"),)),
    ("w_gate", (("data", "model"),)),
    ("w_up",   (("data", "model"),)),
    # griffin rg-lru
    ("rec/w_x", (("data", "model"),)),
    ("rec/w_a", ((None, "model"),)),
    ("rec/w_i", ((None, "model"),)),
    ("rec/w_o", (("model", "data"),)),
    ("rec/conv_w", ((None, "model"),)),
    ("rec/b_a", (("model",),)),
    ("rec/b_i", (("model",),)),
    ("rec/lam", (("model",),)),
    # mamba2 ssd
    ("ssd/w_in",  (("data", "model"),)),
    ("ssd/w_out", (("model", "data"),)),
    ("ssd/conv_w", ((None, "model"),)),
    ("ssd/dt_bias", (("model",),)),
    ("ssd/A_log", (("model",),)),
    ("ssd/D", (("model",),)),
    # embeddings: vocab over model, d_model over data (fsdp);
    # odd vocab sizes fall back to sharding d_model over BOTH axes
    ("embed", (("model", "data"), (None, ("data", "model")))),
    ("head",  (("data", "model"), (("data", "model"), None))),
    # norms replicated
    ("norm", ((),)),
)


def _spec_for(path: str, shape, mesh) -> P:
    for frag, proposals in _PARAM_RULES:
        if frag in path:
            return fit_first(shape, proposals, mesh)
    return P()  # replicate by default


def _strip_data(spec: P) -> P:
    """Remove the `data` axis from a spec (ZeRO-1: the compute-dtype
    parameters are replicated over data; TP over model only)."""
    def strip(ax):
        if ax == "data":
            return None
        if isinstance(ax, tuple):
            kept = tuple(a for a in ax if a != "data")
            return kept[0] if len(kept) == 1 else (kept or None)
        return ax
    return P(*[strip(ax) for ax in spec])


def opt_pspecs(params_tree, mesh):
    """ZeRO-sharded specs (model TP + data sharding) for master/moments."""
    return map_leaves(lambda path, leaf: _spec_for(path, leaf.shape, mesh),
                      params_tree)


def param_pspecs(params_tree, mesh):
    """Compute-dtype parameter specs: TP over `model`, replicated over
    `data`/`pod` (ZeRO-1, see optim.adamw)."""
    return tree_map(_strip_data, opt_pspecs(params_tree, mesh))


def train_state_pspecs(state, mesh):
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.training.step import TrainState
    pspecs = param_pspecs(state.params, mesh)
    ospecs = opt_pspecs(state.params, mesh)
    return TrainState(
        params=pspecs,
        opt=AdamWState(master=ospecs, mu=ospecs, nu=ospecs, count=P()),
        step=P(),
    )


def _dp_or_none(mesh, batch_size: int):
    sizes = axis_sizes(mesh)
    dp = dp_axes(mesh)
    total = 1
    for a in dp:
        total *= sizes[a]
    return dp if batch_size % total == 0 and batch_size >= total else None


def batch_pspecs(mesh, batch_size: int, has_frontend: bool = False):
    """Batch sharding: batch over (pod, data)."""
    from repro_torch.models import Batch
    b = _dp_or_none(mesh, batch_size)
    tok = P(b, None)
    return Batch(tokens=tok, labels=tok,
                 frontend=P(b, None, None) if has_frontend else None)


def logits_pspec(mesh, vocab: int, seq: int) -> P:
    """(B, S, V): batch over dp; vocab over model, falling back to the
    sequence dim when the vocab is not divisible (odd vocab sizes)."""
    model = axis_sizes(mesh)["model"]
    if vocab % model == 0:
        return P(dp_axes(mesh), None, "model")
    if seq % model == 0:
        return P(dp_axes(mesh), "model", None)
    return P(dp_axes(mesh), None, None)


def cache_pspecs(mesh, caches, batch_size: int):
    """Decode caches: batch over dp (if divisible), cache seq over model.

    KVCache k/v (B, S, K, H) -> P(dp, 'model', None, None) (seq-parallel)
    slot_pos (S,)            -> P() (replicated, tiny)
    Recurrent h (B, D)       -> P(dp, 'model')
    conv (B, k, D)           -> P(dp, None, 'model')
    Ssd state (B, H, P, N)   -> P(dp, 'model', None, None)
    enc_out (B, F, d)        -> P(dp, None, None)

    The field-name rules match as the reference's do, substring first
    and then the name's end, so a leaf gets the reference's spec where
    the two rules disagree too (a `conv` leaf ends in "v" and takes the
    `/v` rule before its own)."""
    b = _dp_or_none(mesh, batch_size)
    rules = (
        ("slot_pos", None),
        ("enc_out", (b, None, None)),
        ("/k", (b, "model", None, None)),
        ("/v", (b, "model", None, None)),
        ("state", (b, "model", None, None)),
        ("conv", (b, None, "model")),
        ("/h", (b, "model")),
    )

    def spec(path, leaf):
        for frag, right in rules:
            if frag in path or path.endswith(frag.strip("/")):
                if right is None:
                    return P()
                return fit_spec(leaf.shape, right, mesh)
        return P()

    return map_leaves(spec, caches)


def cache_placements(mesh, field: str, shape, batch_size: int) -> tuple:
    """The placements `cache_pspecs` gives a cache leaf named `field`
    (`k`, `v`, `slot_pos`, `h`, `conv`, `state`, `enc_out`) of `shape`,
    for a batch of `batch_size`: where a serving step builds a cache
    leaf, it places it by the rules' own match."""
    import torch
    leaf = torch.empty(tuple(shape), device="meta")
    spec = cache_pspecs(mesh, {"stack": [{field: leaf}]},
                        batch_size)["stack"][0][field]
    return placements(spec, mesh)


def placements(spec: P, mesh) -> tuple:
    """The DTensor placements of `spec` on `mesh` (a `DeviceMesh` or a
    mapping of axis sizes, in mesh order): for each mesh dim, `Shard(i)`
    if tensor dim i names that axis, else `Replicate()`. A data axis
    (`dp_axes`) of one rank is `Replicate()` whatever the spec names
    there: its one block is the whole dim either way, and DTensor
    refuses to flatten a dim of size 1 that a mesh dim splits (an einsum
    over a batch of 1 at (1, M)). A `model` axis of one rank keeps its
    `Shard`, as the train step at (N, 1) was built and tested with it.

    A dim that names several axes, as ("data", "model"), is split major
    to minor as JAX splits it: rank (d, m) holds block d · M + m. DTensor
    splits a dim sharded on several mesh dims in mesh-dim order, so the
    tuple must list its axes in mesh order (every rule does); another
    order raises."""
    sizes = axis_sizes(mesh)
    names = list(sizes)
    one_rank = {a for a in dp_axes(mesh) if sizes[a] == 1}
    out = [Replicate()] * len(names)
    named = set()
    for i, ax in enumerate(spec):
        axes = ax if isinstance(ax, tuple) else (() if ax is None else (ax,))
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"placements: {spec} splits dim {i} over "
                             f"{axes}, not in the mesh's order {names}")
        for j in order:
            if j in named:
                raise ValueError(f"placements: {spec} names mesh axis "
                                 f"{names[j]!r} on two dims")
            named.add(j)
            if names[j] not in one_rank:
                out[j] = Shard(i)
    return tuple(out)


class NamedSharding:
    """A spec's placements on a `DeviceMesh`: the reference's
    `NamedSharding`, what `place.constrain` redistributes a DTensor to."""

    __slots__ = ("mesh", "spec", "placements")

    def __init__(self, mesh: DeviceMesh, spec: P):
        self.mesh, self.spec = mesh, spec
        self.placements = placements(spec, mesh)

    def __repr__(self):
        return f"NamedSharding({self.spec!r}, {self.placements!r})"


def named(mesh: DeviceMesh, tree):
    """Spec tree -> `NamedSharding` tree."""
    return tree_map(lambda s: NamedSharding(mesh, s), tree)
