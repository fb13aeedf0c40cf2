"""Parameter trees between the JAX package and the port.

``params_from_numpy`` turns the JAX package's parameter tree (nested dicts
of numpy arrays, as ``jax.device_get(init_params(...))`` gives) into the
port's tensors, leaf by leaf whatever the layer (attention, MLP, and
Mamba2's ``in_proj``, ``conv_w``, ``A_log``, ``dt_bias``, ``D``,
``gate_norm``, ``out_proj``), so both packages compute from identical
weights;
``params_to_numpy`` is its inverse. bfloat16 arrays cross as their raw
16-bit patterns (numpy has no bfloat16 of its own); the inverse returns
them widened to float32, which is exact.

On a node split over K GPUs (the model axis, ``models/split.py``)
``shard_params`` cuts a whole tree (the JAX package's numpy arrays or the
port's one-GPU tensors, node-stacked or not) into one GPU's slices, and
``unshard_params`` puts the K slices back together.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.split import take_slice
from repro_torch.models.transformer import param_split
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten


def _to_tensor(x, device):
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(a).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(tree, device):
    return tree_map(lambda x: _to_tensor(x, device), tree)


def params_to_numpy(tree):
    def conv(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.numpy()
    return tree_map(conv, tree)


def _split_dims(cfg, model_parallel: int, stacked: bool):
    lead = int(stacked)
    return tree_map(lambda d: None if d is None else d + lead,
                    param_split(cfg, model_parallel))


def shard_params(tree, cfg, model_parallel: int, index: int, *,
                 stacked: bool = False):
    """The whole parameter tree `tree` -> GPU `index`'s slices of it
    (``models/transformer.py`` ``param_split``; `stacked`: leaves carry a
    leading node axis). A replicated leaf passes through."""
    return tree_map(lambda x, d: take_slice(x, d, model_parallel, index),
                    tree, _split_dims(cfg, model_parallel, stacked))


def unshard_params(shards, cfg, *, stacked: bool = False):
    """The K GPUs' slices (a list of trees, model index order) -> the
    whole tree: each split leaf concatenated along its dimension, a
    replicated one taken from the first GPU."""
    dims = tree_leaves(_split_dims(cfg, len(shards), stacked))
    leaves, treedef = tree_flatten(shards[0])
    parts = [leaves] + [tree_leaves(s) for s in shards[1:]]

    def join(i):
        xs = [p[i] for p in parts]
        if dims[i] is None:
            return xs[0]
        if isinstance(xs[0], torch.Tensor):
            return torch.cat(xs, dim=dims[i])
        return np.concatenate(xs, axis=dims[i])
    return tree_unflatten(treedef, [join(i) for i in range(len(leaves))])
