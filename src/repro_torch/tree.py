"""Nested-dict parameter trees, flattened in the JAX package's order.

``jax.tree.flatten`` visits dict keys sorted at every level; the flat-buffer
layout (``core/bucket.py``) and therefore the wire offsets, padding and byte
counts depend on that order, so the port flattens the same way. A tree
definition is a hashable nested tuple: ``None`` marks a leaf, a tuple of
``(key, subtree)`` pairs a dict (empty dicts survive a round trip, as the
parameter-free norms of ``nonparam_ln`` need) and, with ``tuples=True``,
``(TUPLE, subtrees)`` a tuple, whose elements JAX visits in order (the
checkpoint of a codec's wire tuple, as ``compress_state`` keeps its comm
copy). By default a tuple is a leaf: the model maps over tuples of
per-block tensors as single values.
"""
from __future__ import annotations


# The recursions are module-level functions, not nested closures: a nested
# recursive function reaches itself through its closure cell, a reference
# cycle that would keep every leaf it collected alive until Python's cyclic
# garbage collector happens to run (whole-model tensors, on the card).


TUPLE = "<tuple>"


def _is_tuple_def(s) -> bool:
    return isinstance(s, tuple) and s[:1] == (TUPLE,)


def _flatten(t, leaves: list, tuples: bool):
    if isinstance(t, dict):
        return tuple((k, _flatten(t[k], leaves, tuples)) for k in sorted(t))
    if tuples and isinstance(t, tuple):
        return (TUPLE, tuple(_flatten(v, leaves, tuples) for v in t))
    leaves.append(t)
    return None


def tree_flatten(tree, *, tuples: bool = False):
    """-> (leaves in sorted-key order, treedef); `tuples` descends into
    tuples as JAX does."""
    leaves = []
    return leaves, _flatten(tree, leaves, tuples)


def _unflatten(s, it):
    if s is None:
        return next(it)
    if _is_tuple_def(s):
        return tuple(_unflatten(v, it) for v in s[1])
    return {k: _unflatten(v, it) for k, v in s}


def tree_unflatten(treedef, leaves):
    it = iter(leaves)
    out = _unflatten(treedef, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree definition holds")
    return out


def tree_leaves(tree):
    return tree_flatten(tree)[0]


def tree_map(fn, tree, *rest):
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef,
                          [fn(*xs) for xs in zip(leaves, *others)])


def _paths(t, prefix: tuple, out: list, tuples: bool):
    if isinstance(t, dict):
        for k in sorted(t):
            _paths(t[k], prefix + (k,), out, tuples)
    elif tuples and isinstance(t, tuple):
        for i, v in enumerate(t):
            _paths(v, prefix + (i,), out, tuples)
    else:
        out.append(prefix)


def tree_key_paths(tree, *, tuples: bool = False) -> list:
    """Each leaf's tuple of dict keys (and, with `tuples`, tuple
    indices), in flatten order."""
    out = []
    _paths(tree, (), out, tuples)
    return out


def tree_paths(tree, sep: str = "."):
    """Leaf paths joined by `sep`, in flatten order ("blocks.layer_0.attn.wq")."""
    return [sep.join(p) for p in tree_key_paths(tree)]


def keystr(path) -> str:
    """A key path as ``jax.tree_util.keystr`` writes it: ``['a']['b']``."""
    return "".join(f"[{k!r}]" for k in path)


def tree_map_with_path(fn, tree, *rest):
    """`tree_map` whose `fn` also takes each leaf's key path first."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r)[0] for r in rest]
    return tree_unflatten(treedef, [fn(p, *xs) for p, *xs in
                                    zip(tree_key_paths(tree), leaves,
                                        *others)])
