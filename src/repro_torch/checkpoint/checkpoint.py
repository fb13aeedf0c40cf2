"""Tree checkpoints in the JAX package's format (``repro/checkpoint``): a
flat npz of ``leaf_{i}`` arrays plus a json of names, dtypes, the tree
definition and free metadata, so a checkpoint written by either package
loads in the other.

* Leaves go in JAX's flatten order (dict keys sorted at every level,
  ``tree.py``), named in ``jax.tree_util.keystr``'s ``['a']['b']`` form.
* bfloat16 leaves are stored widened to float32, with ``"bfloat16"`` in
  ``dtypes`` (numpy has no bfloat16 of its own); loading narrows them
  back, which is exact.
* ``treedef`` is written in JAX's ``PyTreeDef(...)`` form for trees of
  dicts and tuples (a compressed comm copy is a wire tuple);
  neither package's loader reads it (the caller's `like` gives the
  structure).
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch.tree import (
    TUPLE, keystr, tree_flatten, tree_key_paths, tree_unflatten,
)

_NP_DTYPES = {torch.float32: "float32", torch.float64: "float64",
              torch.float16: "float16", torch.bfloat16: "bfloat16",
              torch.int32: "int32", torch.int64: "int64",
              torch.int16: "int16", torch.int8: "int8",
              torch.uint8: "uint8", torch.bool: "bool"}


def _names(tree) -> list:
    """Leaf names in flatten order, as ``jax.tree_util.keystr`` writes
    them."""
    return [keystr(p) for p in tree_key_paths(tree, tuples=True)]


def _treedef_body(s) -> str:
    if s is None:
        return "*"
    if s[:1] == (TUPLE,):
        body = ", ".join(_treedef_body(v) for v in s[1])
        return "(" + body + ("," if len(s[1]) == 1 else "") + ")"
    return "{" + ", ".join(f"{k!r}: {_treedef_body(v)}" for k, v in s) + "}"


def _treedef_str(treedef) -> str:
    return f"PyTreeDef({_treedef_body(treedef)})"


def _jsonable(obj):
    """numpy scalars/arrays in metadata -> plain Python."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def _to_numpy(t: torch.Tensor):
    """-> (array to store, dtype name to record)."""
    t = t.detach().cpu()
    if t.dtype == torch.uint16:            # q9..q16 wire codes, same bits
        return t.view(torch.int16).numpy().view(np.uint16), "uint16"
    name = _NP_DTYPES[t.dtype]
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)            # stored widened, exactly
    return t.numpy(), name


def save_checkpoint(path: str, tree: Any, metadata: dict | None = None):
    """Write `tree` (nested dicts of tensors or arrays) to path.npz and
    path.json."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    leaves, treedef = tree_flatten(tree, tuples=True)
    arrays, dtypes = {}, {}
    for i, v in enumerate(leaves):
        if isinstance(v, torch.Tensor):
            a, name = _to_numpy(v)
        else:
            a = np.asarray(v)
            name = str(a.dtype)
        dtypes[f"leaf_{i}"] = name
        arrays[f"leaf_{i}"] = a
    np.savez(path + ".npz", **arrays)
    meta = {"names": _names(tree), "dtypes": dtypes,
            "treedef": _treedef_str(treedef),
            "metadata": _jsonable(metadata or {})}
    with open(path + ".json", "w") as f:
        json.dump(meta, f, indent=1)


def load_checkpoint(path: str, like: Any) -> Any:
    """Restore into the structure of `like` (a tree of tensors): each leaf
    shape-checked, cast to its `like` leaf's dtype and placed on its
    device."""
    leaves_like, treedef = tree_flatten(like, tuples=True)
    restored = []
    with np.load(path + ".npz") as data:
        for i, ref in enumerate(leaves_like):
            arr = data[f"leaf_{i}"]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"leaf {i}: shape {arr.shape} != "
                                 f"{tuple(ref.shape)}")
            if arr.dtype == np.uint16:     # through an int16 view
                t = torch.from_numpy(np.array(arr).view(np.int16)) \
                    .view(torch.uint16)
            else:
                t = torch.from_numpy(np.array(arr))
            restored.append(t.to(device=ref.device, dtype=ref.dtype))
    return tree_unflatten(treedef, restored)


def load_metadata(path: str) -> dict:
    with open(path + ".json") as f:
        return json.load(f)["metadata"]


def mean_model_tree(params_stacked):
    """Node-stacked params -> the swarm's average model μ as a single-model
    tree: pack to the flat [n_nodes, n_padded] fp32 buffer, mean over the
    node axis, unpack through a single-node layout (original leaf
    dtypes)."""
    from repro_torch.core import bucket as B
    layout = B.build_layout(params_stacked)
    buf = B.pack(layout, params_stacked)
    leaves, treedef = tree_flatten(params_stacked)
    probe = tree_unflatten(treedef, [torch.empty(x.shape[1:], dtype=x.dtype,
                                                 device="meta")
                                     for x in leaves])
    flat = B.build_flat_layout(probe)
    assert flat.n_padded == layout.n_padded, (flat.n_padded, layout.n_padded)
    mu = torch.mean(buf, dim=0)
    del buf
    return B.unpack_flat(flat, mu)
