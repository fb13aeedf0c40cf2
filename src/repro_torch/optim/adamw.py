"""AdamW with decoupled weight decay (counterpart of
``repro/optim/adamw.py``): fp32 accumulators by default and a step
counter, the bias corrections read from it. Plain PyTorch, leaf by leaf,
each elementwise step in the reference's order."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.tree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    state_dtype: str = "float32"


def adamw_init(cfg: AdamWConfig, params):
    """{"m", "v"}: zero trees in `state_dtype`; "t": the int32 step
    counter, on the parameters' device."""
    dt = getattr(torch, cfg.state_dtype)

    def z(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    device = tree_leaves(params)[0].device
    return {"m": tree_map(z, params), "v": tree_map(z, params),
            "t": torch.zeros((), dtype=torch.int32, device=device)}


def adamw_update(cfg: AdamWConfig, params, grads, state, lr=None):
    """-> (params', state'). `lr` defaults to cfg.lr (a float or a 0-d
    fp32 tensor)."""
    lr = cfg.lr if lr is None else lr
    t = state["t"] + 1
    tf = t.to(torch.float32)
    bc1 = 1.0 - torch.pow(cfg.b1, tf)
    bc2 = 1.0 - torch.pow(cfg.b2, tf)

    def upd(p, g, m, v):
        g = g.to(torch.float32)
        m32 = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * g * g
        step = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        if cfg.weight_decay:
            step = step + cfg.weight_decay * p.to(torch.float32)
        return ((p.to(torch.float32) - lr * step).to(p.dtype),
                m32.to(m.dtype), v32.to(v.dtype))

    flat_p, tdef = tree_flatten(params)
    outs = [upd(p, g, m, v) for p, g, m, v in zip(
        flat_p, tree_leaves(grads), tree_leaves(state["m"]),
        tree_leaves(state["v"]))]
    return (tree_unflatten(tdef, [o[0] for o in outs]),
            {"m": tree_unflatten(tdef, [o[1] for o in outs]),
             "v": tree_unflatten(tdef, [o[2] for o in outs]),
             "t": t})
