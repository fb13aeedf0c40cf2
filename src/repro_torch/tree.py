"""Nested-dict parameter trees, flattened in the JAX package's order.

``jax.tree.flatten`` visits dict keys sorted at every level; the flat-buffer
layout (``core/bucket.py``) and therefore the wire offsets, padding and byte
counts depend on that order, so the port flattens the same way. A tree
definition is a hashable nested tuple: ``None`` marks a leaf and a tuple of
``(key, subtree)`` pairs a dict (empty dicts survive a round trip, as the
parameter-free norms of ``nonparam_ln`` need).
"""
from __future__ import annotations


# The recursions are module-level functions, not nested closures: a nested
# recursive function reaches itself through its closure cell, a reference
# cycle that would keep every leaf it collected alive until Python's cyclic
# garbage collector happens to run (whole-model tensors, on the card).


def _flatten(t, leaves: list):
    if isinstance(t, dict):
        return tuple((k, _flatten(t[k], leaves)) for k in sorted(t))
    leaves.append(t)
    return None


def tree_flatten(tree):
    """-> (leaves in sorted-key order, treedef)."""
    leaves = []
    return leaves, _flatten(tree, leaves)


def _unflatten(s, it):
    if s is None:
        return next(it)
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


def _paths(t, prefix: tuple, out: list):
    if isinstance(t, dict):
        for k in sorted(t):
            _paths(t[k], prefix + (k,), out)
    else:
        out.append(prefix)


def tree_key_paths(tree) -> list:
    """Each leaf's tuple of dict keys, in flatten order."""
    out = []
    _paths(tree, (), out)
    return out


def tree_paths(tree, sep: str = "."):
    """Leaf paths joined by `sep`, in flatten order ("blocks.layer_0.attn.wq")."""
    return [sep.join(p) for p in tree_key_paths(tree)]
