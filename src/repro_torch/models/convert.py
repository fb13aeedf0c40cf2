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
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_map


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
