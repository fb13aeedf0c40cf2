"""SwarmSGD training engine: the blocking superstep (Algorithm 1), the
slice of ``repro/core/swarm.py`` the port runs.

Node state is node-stacked (every parameter and optimizer leaf has a
leading [n_nodes] dim). A superstep is

  1. every node's h_i <= H local momentum-SGD steps (gradients per node,
     one fused ``sgd_update`` sweep over all nodes per step);
  2. one uniformly sampled matching of the interaction graph: matched
     pairs average their post-local-step models over the flat-buffer
     transport — fp32 exact, or with ``quantize`` the lattice codec
     (``quantize_mod`` encode, permute, fused ``decode_avg``);
  3. matched nodes refresh their comm copy ``prev`` (the quantized
     encode's distance proxy) to the post-interaction model.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core.exchange import (
    GossipTransport, _rows, make_local_steps, masked_mean_loss,
)
from repro_torch.core.potential import gamma_potential
from repro_torch.quant.schemes import ModularQuantConfig
from repro_torch.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class SwarmConfig:
    n_nodes: int
    H: int = 2                   # local steps per interaction (fixed H)
    quantize: bool = False       # Extension 3: lattice gossip at quant.bits
    quant: ModularQuantConfig = ModularQuantConfig()


@dataclass
class SwarmState:
    params: Any                  # node-stacked tree
    opt: Any                     # node-stacked optimizer state
    prev: Any                    # comm copy: params at last interaction
    step: int


def swarm_init(gen: torch.Generator, cfg: SwarmConfig,
               param_init: Callable, opt_init: Callable) -> SwarmState:
    """Every node starts from the same model, drawn once from `gen`."""
    one = param_init(gen)
    params = tree_map(lambda x: x.unsqueeze(0).repeat(
        (cfg.n_nodes,) + (1,) * x.ndim), one)
    del one
    opt = opt_init(params)
    prev = tree_map(torch.clone, params) if cfg.quantize else None
    return SwarmState(params, opt, prev, 0)


def make_swarm_step(cfg: SwarmConfig, loss_fn: Callable, opt_update: Callable,
                    lr_fn: Callable,
                    transport: Optional[GossipTransport] = None):
    """Returns superstep(state, batch, perm, h_counts, rng, *, u=None) ->
    (state, metrics). batch leaves are [n_nodes, H, local_batch, ...]
    tensors on the device; perm is an involution [n_nodes]; h_counts the
    per-node local-step counts; rng the torch.Generator of the encode's
    uniforms, or `u` the uniforms themselves ([n_nodes, n_padded])."""
    tr = transport or GossipTransport(cfg.n_nodes, quant=cfg.quant)
    local_steps = make_local_steps(loss_fn, opt_update, cfg.H)

    def superstep(state: SwarmState, batch, perm, h_counts, rng, *, u=None):
        device = tree_leaves(state.params)[0].device
        lr = torch.tensor(lr_fn(state.step), dtype=torch.float32,
                          device=device)
        params, opt, losses = local_steps(state.params, state.opt, batch,
                                          h_counts, lr)
        perm_t = torch.as_tensor(np.asarray(perm), dtype=torch.int64,
                                 device=device)
        matched = perm_t != torch.arange(cfg.n_nodes, device=device)
        with record_function("swarm.gossip"):
            params = tr.mix_pair(params, perm_t, matched,
                                 quantize=cfg.quantize, prev=state.prev,
                                 rng=rng, u=u)
        new_prev = None
        if state.prev is not None:
            # refresh the comm copy on interaction, to the post-interaction
            # model: the next encode input is H local steps away from it,
            # so the distance proxy |x - prev| stays live
            with record_function("swarm.prev"):
                new_prev = tree_map(
                    lambda pv, p: torch.where(_rows(matched, p.ndim), p, pv),
                    state.prev, params)
        metrics = {"loss": masked_mean_loss(losses, None), "lr": lr,
                   "matched_frac": torch.mean(matched.to(torch.float32))}
        with record_function("swarm.gamma"):
            metrics["gamma"] = gamma_potential(params)
        return SwarmState(params, opt, new_prev, state.step + 1), metrics

    return superstep


def sample_h_counts(cfg: SwarmConfig, rng: np.random.Generator) -> np.ndarray:
    """Host-side per-node local-step counts for this superstep: fixed H
    (draws nothing from `rng`, as the JAX driver's fixed mode)."""
    del rng
    return np.full((cfg.n_nodes,), cfg.H, np.int32)
