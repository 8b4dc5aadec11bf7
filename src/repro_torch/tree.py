"""Trees of tensors: nested dicts, NamedTuples, lists and tuples, as the
port's parameters, optimizer states, service states and checkpoints are
built.

One walk for all of them, in JAX's pytree order: dict keys in sorted
order and `None` no leaf, so two trees with the same keys give their
leaves in one order whatever order their dicts were built in. A leaf's
name is its path joined with "/": dict keys, NamedTuple field names,
list indices (`{"layers": [{"wq": ...}]}` names its leaf `layers/0/wq`).
A rebuilt tree keeps each node's type; its dicts hold their keys in
sorted order.
"""
from __future__ import annotations


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def map_leaves(fn, tree, path=()):
    """`tree` rebuilt with every leaf x replaced by fn(name, x)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_leaves(fn, tree[k], path + (str(k),))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(map_leaves(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_leaves(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(path), tree)


def tree_map(fn, tree):
    """`tree` rebuilt with every leaf x replaced by fn(x)."""
    return map_leaves(lambda _, x: fn(x), tree)


def named_leaves(tree) -> dict:
    """{name: leaf}, in the walk's order."""
    out = {}
    map_leaves(out.__setitem__, tree)
    return out


def tree_leaves(tree) -> list:
    """The leaves, in the walk's order."""
    return list(named_leaves(tree).values())


def tree_unflatten(tree, leaves):
    """`tree`'s structure with `leaves` (in the walk's order) at its
    leaves."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
