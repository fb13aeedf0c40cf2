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

On a node mesh (``launch/mesh.py``: one node a rank, its leaves
``[1, ...]``, a compressed comm copy's wire rows ``[rows_per_node,
...]``) every rank calls each function with `mesh=`: a save gathers every
leaf along dim 0 in rank order to rank 0, which writes the one-shard file
of the whole swarm; a load gives each rank its slab of it; the mean model
is the whole swarm's, bitwise the one-shard mean of the gathered rows.

With a model axis (a node split over K ranks) every rank also passes
`split`, a tree like the saved one whose leaves are the split dimension
of an un-stacked leaf or None (``models/transformer.py`` ``param_split``): a
save first all-gathers each split leaf over the node's K ranks, so rank
0 writes the same one-shard file; a load gives each rank its node's row,
cut to its own slice. Off a node mesh, a load with `shard` (one GPU of a
node split over K, ``launch/mesh.py`` ``ModelShard``) and `split` gives
that GPU its slice of every node's row, each leaf read on the host and
cut there (a split node's serving follower, ``serve/source.py``).
"""
from __future__ import annotations

import json
import os
import struct
import time
import zipfile
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

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


def save_checkpoint(path: str, tree: Any, metadata: dict | None = None,
                    mesh=None, times: dict | None = None, split=None):
    """Write `tree` (nested dicts of tensors or arrays) to path.npz and
    path.json.

    On a node `mesh` every rank calls it with its own slab of the swarm's
    tree (tensor leaves on its device, the same leading size on every
    rank): each leaf is gathered along dim 0 in rank order to rank 0 only
    (``bucket.gather_slab``, one leaf at a time), rank 0 writes the
    one-shard file of the gathered tree with its `metadata`, and every
    rank returns once the file is written. A `times` dict is filled with
    the seconds this rank spent gathering (its copies to the host in) and
    writing (``gather_s``, ``write_s``). With a model axis `split` gives
    each leaf's split dimension (see the module docstring)."""
    if mesh is not None:
        from repro_torch.core import bucket as B
        t0 = time.perf_counter()
        leaves, treedef = tree_flatten(tree, tuples=True)
        dims = _split_dims(split, len(leaves), mesh)
        gathered = []
        for v, d in zip(leaves, dims):
            if not isinstance(v, torch.Tensor):
                raise TypeError(f"a node mesh saves tensor leaves, got "
                                f"{type(v).__name__}")
            if d is not None:
                v = B.all_gather_model(v, mesh, d + 1)
            # the node's whole row lies on each of its ranks: model index
            # 0's go to rank 0
            g = B.gather_slab(v, mesh) if mesh.model_index == 0 else None
            gathered.append(None if g is None else g.cpu())
            del g, v
        t1 = time.perf_counter()
        if mesh.rank == 0 and mesh.model_index == 0:
            save_checkpoint(path, tree_unflatten(treedef, gathered),
                            metadata)
        del gathered
        if times is not None:
            times.update(gather_s=t1 - t0, write_s=time.perf_counter() - t1)
        dist.barrier(group=mesh.group if mesh.model_size == 1 else None)
        return
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


def _split_dims(split, n: int, mesh) -> list:
    """Each of `n` leaves' split dimension (None: whole), from `split` on
    a mesh with a model axis; all None without one."""
    if mesh.model_size == 1:
        return [None] * n
    if split is None:
        raise ValueError("a node mesh with a model axis saves and loads "
                         "with split= (models/transformer.py param_split)")
    dims = tree_flatten(split, tuples=True)[0]
    if len(dims) != n:
        raise ValueError(f"split has {len(dims)} leaves, the tree {n}")
    return dims


def _read_rows(npz: str, name: str, rank: int, size: int):
    """Rank `rank`'s share of leaf `name` (its dim 0 cut in `size` equal
    slabs) -> (the leaf's stored shape, the slab), reading only the
    slab's bytes: an ``np.savez`` member is stored uncompressed, so its
    rows lie at a fixed offset in the file."""
    with zipfile.ZipFile(npz) as zf:
        info = zf.getinfo(name + ".npy")
    if info.compress_type != zipfile.ZIP_STORED:
        raise ValueError(f"{npz}: {name} is compressed; a node mesh reads "
                         "the slabs of np.savez's stored members")
    with open(npz, "rb") as f:
        f.seek(info.header_offset)
        local = f.read(30)                 # the zip local file header
        n_name, n_extra = struct.unpack("<HH", local[26:30])
        f.seek(info.header_offset + 30 + n_name + n_extra)
        version = np.lib.format.read_magic(f)
        shape, fortran, dtype = (np.lib.format.read_array_header_1_0(f)
                                 if version == (1, 0) else
                                 np.lib.format.read_array_header_2_0(f))
        if fortran:
            raise ValueError(f"{npz}: {name} is stored in Fortran order")
        if not shape or shape[0] % size:
            return shape, None             # the caller's shape check raises
        k = shape[0] // size
        row = dtype.itemsize * int(np.prod(shape[1:], dtype=np.int64))
        f.seek(rank * k * row, os.SEEK_CUR)
        slab = np.fromfile(f, dtype=dtype, count=k * row // dtype.itemsize)
    return shape, slab.reshape((k,) + tuple(shape[1:]))


def _tensor(arr) -> torch.Tensor:
    if arr.dtype == np.uint16:             # through an int16 view
        return torch.from_numpy(np.array(arr).view(np.int16)) \
            .view(torch.uint16)
    return torch.from_numpy(np.array(arr))


def load_checkpoint(path: str, like: Any, mesh=None, split=None,
                    shard=None) -> Any:
    """Restore into the structure of `like` (a tree of tensors): each leaf
    shape-checked, cast to its `like` leaf's dtype and placed on its
    device. On a node `mesh` `like` is the rank's slab: each stored leaf
    must hold ``mesh.size`` of them along dim 0, and the rank reads its
    own, only its bytes; with a model axis (`split`) its node's slab, cut
    to its own slice. With `shard` and `split` and no mesh, `like` is
    `shard`'s slices of node-stacked leaves: each stored leaf is cut to
    its slice on the host (the leading [n_nodes] dim whole)."""
    leaves_like, treedef = tree_flatten(like, tuples=True)
    restored = []
    if mesh is not None:
        from repro_torch.models.split import take_slice
        dims = _split_dims(split, len(leaves_like), mesh)
        for i, (ref, d) in enumerate(zip(leaves_like, dims)):
            if ref.dim() == 0:
                raise ValueError(f"leaf {i}: a node mesh loads slabs along "
                                 "dim 0, not 0-d leaves")
            full = list(ref.shape)
            if d is not None:
                full[d + 1] *= mesh.model_size
            want = (mesh.size * ref.shape[0],) + tuple(full[1:])
            shape, slab = _read_rows(path + ".npz", f"leaf_{i}", mesh.rank,
                                     mesh.size)
            if tuple(shape) != want:
                raise ValueError(f"leaf {i}: shape {shape} != {want}")
            if d is not None:
                slab = take_slice(slab, d + 1, mesh.model_size,
                                  mesh.model_index)
            restored.append(_tensor(slab).to(device=ref.device,
                                             dtype=ref.dtype))
        return tree_unflatten(treedef, restored)
    dims = [None] * len(leaves_like)
    if shard is not None:
        from repro_torch.models.split import take_slice
        dims = tree_flatten(split, tuples=True)[0]
        if len(dims) != len(leaves_like):
            raise ValueError(f"split has {len(dims)} leaves, the tree "
                             f"{len(leaves_like)}")
    with np.load(path + ".npz") as data:
        for i, (ref, d) in enumerate(zip(leaves_like, dims)):
            arr = data[f"leaf_{i}"]
            if d is not None:
                if arr.ndim < d + 2 or arr.shape[d + 1] % shard.size:
                    raise ValueError(f"leaf {i}: shape {arr.shape} does "
                                     f"not split {shard.size} ways at "
                                     f"dim {d + 1}")
                arr = take_slice(arr, d + 1, shard.size, shard.index)
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"leaf {i}: shape {arr.shape} != "
                                 f"{tuple(ref.shape)}")
            restored.append(_tensor(arr).to(device=ref.device,
                                            dtype=ref.dtype))
    return tree_unflatten(treedef, restored)


def load_metadata(path: str) -> dict:
    with open(path + ".json") as f:
        return json.load(f)["metadata"]


def mean_model_tree(params_stacked, mesh=None):
    """Node-stacked params -> the swarm's average model μ as a single-model
    tree: pack to the flat [n_nodes, n_padded] fp32 buffer, mean over the
    node axis, unpack through a single-node layout (original leaf
    dtypes). On a node `mesh` (the rank's [1, ...] leaves) the ranks'
    packed rows are all-gathered first, so every rank gets the whole
    swarm's μ, bitwise the one-shard μ of the gathered rows (a ring
    all-reduce sums in an order that changes with its chunking and would
    not be)."""
    from repro_torch.core import bucket as B
    layout = B.build_layout(params_stacked)
    buf = B.pack(layout, params_stacked)
    if mesh is not None:
        buf = B.all_gather_rows(buf, mesh)
    leaves, treedef = tree_flatten(params_stacked)
    probe = tree_unflatten(treedef, [torch.empty(x.shape[1:], dtype=x.dtype,
                                                 device="meta")
                                     for x in leaves])
    flat = B.build_flat_layout(probe)
    assert flat.n_padded == layout.n_padded, (flat.n_padded, layout.n_padded)
    mu = torch.mean(buf, dim=0)
    del buf
    return B.unpack_flat(flat, mu)
