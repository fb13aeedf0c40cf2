"""SGD with (Nesterov) momentum and decoupled weight decay (counterpart of
``repro/optim/sgd.py``).

The momentum path packs the whole tree into ONE flat fp32 vector
(``core/bucket.py`` ``pack_flat``) and runs a single ``sgd_fused_update``
sweep: the CUDA kernel for tensors on the card, the plain version on the
CPU. The update is elementwise and the zero padding is a fixed point of it,
so the tree may be node-stacked: one sweep over the ``[n_nodes, ...]`` tree
equals the JAX package's per-node vmapped call bitwise, in one launch. The
per-leaf path (``fused=False``) is kept as the oracle.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.profiler import record_function

from repro_torch.tree import tree_flatten, tree_map, tree_unflatten


@dataclass(frozen=True)
class SGDConfig:
    lr: float = 0.1
    momentum: float = 0.9
    nesterov: bool = False
    weight_decay: float = 0.0
    state_dtype: str = "float32"
    fused: bool = True       # flat-buffer kernel path for the momentum
    # update (bitwise = the per-leaf path); momentum=0 always runs per-leaf


def sgd_init(cfg: SGDConfig, params):
    if cfg.momentum == 0.0:
        return {}
    dt = getattr(torch, cfg.state_dtype)
    return {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                                device=p.device), params)}


def _sgd_update_fused(cfg: SGDConfig, params, grads, state, lr):
    """One kernel sweep over the packed tree: params / grads / momentum
    each flatten to one fp32 vector, update once — in place into the two
    packed copies, which nothing else holds — unpack with the original
    leaf dtypes."""
    from repro_torch.core import bucket as B
    from repro_torch.kernels import sgd_fused_update
    p_layout = B.build_flat_layout(params)
    m_layout = B.build_flat_layout(state["m"])
    with record_function("sgd.pack"):
        pbuf = B.pack_flat(p_layout, params)
        gbuf = B.pack_flat(p_layout, grads)
        mbuf = B.pack_flat(m_layout, state["m"])
    pn, mn = sgd_fused_update(pbuf, gbuf, mbuf, lr=lr, mu=cfg.momentum,
                              wd=cfg.weight_decay, nesterov=cfg.nesterov,
                              block=p_layout.block,
                              tile_rows=p_layout.tile_rows, inplace=True)
    del pbuf, gbuf, mbuf
    with record_function("sgd.unpack"):
        new_p = B.unpack_flat(p_layout, pn)
        del pn
        return new_p, {"m": B.unpack_flat(m_layout, mn)}


def sgd_update(cfg: SGDConfig, params, grads, state, lr=None):
    """-> (params', state'). `lr` defaults to cfg.lr; engines pass a 0-d
    fp32 tensor on the parameters' device."""
    lr = cfg.lr if lr is None else lr
    if state and cfg.fused:
        return _sgd_update_fused(cfg, params, grads, state, lr)

    def upd(p, g, m):
        g = g.to(torch.float32)
        if cfg.weight_decay:
            g = g + cfg.weight_decay * p.to(torch.float32)
        if m is None:
            step = g
            new_m = None
        else:
            new_m = cfg.momentum * m.to(torch.float32) + g
            step = g + cfg.momentum * new_m if cfg.nesterov else new_m
        new_p = (p.to(torch.float32) - lr * step).to(p.dtype)
        return new_p, new_m

    if not state:
        return tree_map(lambda p, g: upd(p, g, None)[0], params, grads), {}
    flat_p, tdef = tree_flatten(params)
    flat_g, _ = tree_flatten(grads)
    flat_m, _ = tree_flatten(state["m"])
    outs = [upd(p, g, m) for p, g, m in zip(flat_p, flat_g, flat_m)]
    dt = getattr(torch, cfg.state_dtype)
    return (tree_unflatten(tdef, [o[0] for o in outs]),
            {"m": tree_unflatten(tdef, [o[1].to(dt) for o in outs])})
