"""Nested-dict parameter trees, flattened in the JAX package's order.

``jax.tree.flatten`` visits dict keys sorted at every level; the flat-buffer
layout (``core/bucket.py``) and therefore the wire offsets, padding and byte
counts depend on that order, so the port flattens the same way. A tree
definition is a hashable nested tuple: ``None`` marks a leaf and a tuple of
``(key, subtree)`` pairs a dict (empty dicts survive a round trip, as the
parameter-free norms of ``nonparam_ln`` need).
"""
from __future__ import annotations


def tree_flatten(tree):
    """-> (leaves in sorted-key order, treedef)."""
    leaves = []

    def rec(t):
        if isinstance(t, dict):
            return tuple((k, rec(t[k])) for k in sorted(t))
        leaves.append(t)
        return None
    return leaves, rec(tree)


def tree_unflatten(treedef, leaves):
    it = iter(leaves)

    def rec(s):
        if s is None:
            return next(it)
        return {k: rec(v) for k, v in s}
    out = rec(treedef)
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


def tree_paths(tree, sep: str = "."):
    """Leaf paths joined by `sep`, in flatten order ("blocks.layer_0.attn.wq")."""
    paths = []

    def rec(t, prefix):
        if isinstance(t, dict):
            for k in sorted(t):
                rec(t[k], prefix + (k,))
        else:
            paths.append(sep.join(prefix))
    rec(tree, ())
    return paths
