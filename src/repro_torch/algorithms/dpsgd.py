"""D-PSGD (Lian et al.; counterpart of ``repro/algorithms/dpsgd.py``): one
SGD step, then averaging with ALL graph neighbours through a doubly
stochastic mixing matrix W (Metropolis weights), every step.

The mixing is the transport's `matrix_mix`: one dense [n, n] x
[n, n_padded] fp32 product over the packed buffer. Under a participation
mask only edges whose BOTH endpoints are active mix: W_eff = I + M (W - I)
M with M = diag(mask), which stays symmetric doubly stochastic (inactive
rows are the identity, dropped mass folds back onto the diagonal). On a
node mesh W and W_eff are replicated [n, n] on every rank, the mix
all-gathers the ranks' packed models and each rank keeps its row of W X.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.algorithms.common import (fold_batch, gated_grad_step,
                                           metrics_of, node_grad_step,
                                           transport_of)
from repro_torch.core.exchange import EngineStep, GossipTransport, own_rows
from repro_torch.core.graph import Graph
from repro_torch.core.swarm import SwarmState


def metropolis_weights(graph: Graph) -> np.ndarray:
    n = graph.n
    W = np.zeros((n, n))
    deg = np.zeros(n, int)
    for a, b in graph.edges:
        deg[a] += 1
        deg[b] += 1
    for a, b in graph.edges:
        w = 1.0 / (max(deg[a], deg[b]) + 1)
        W[a, b] = W[b, a] = w
    W[np.arange(n), np.arange(n)] = 1.0 - W.sum(axis=1)
    return W


def masked_metropolis(W: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mixing restricted to edges whose BOTH endpoints are active, on W's
    device: off-diagonal m_i m_j W_ij, each row's dropped mass folded back
    onto its diagonal (W_eff[i,i] = 1 - sum_{j!=i} m_i m_j W_ij); equals W
    at the all-True mask."""
    m = mask.to(torch.float32)
    eye = torch.eye(W.shape[0], dtype=torch.float32, device=W.device)
    off = W * m[:, None] * m[None, :] * (1.0 - eye)
    return off + torch.diag(1.0 - off.sum(dim=1))


def make_step(loss_fn, opt_update, lr_fn, n_nodes, graph: Graph,
              track_potential: bool = True,
              transport: GossipTransport = None, *, mesh=None):
    tr = transport_of(transport, n_nodes, mesh)
    mesh = tr.mesh
    W = torch.from_numpy(metropolis_weights(graph).astype(np.float32))
    gs_plain = node_grad_step(loss_fn, opt_update)
    gs_gated = gated_grad_step(loss_fn, opt_update)

    W_on = {}                 # device -> W, copied there once

    def step(state: SwarmState, batch, inp, rng, *, u=None):
        del rng, u
        lr, mask = inp.lr, inp.mask
        mb = fold_batch(batch)
        W_dev = W_on.get(lr.device)
        if W_dev is None:
            W_dev = W_on[lr.device] = W.to(lr.device)
        if mask is None:
            params, opt, losses = gs_plain(state.params, state.opt, mb, lr)
            W_eff = W_dev
        else:
            params, opt, losses = gs_gated(state.params, state.opt, mb, lr,
                                           own_rows(mask, mesh))
            W_eff = masked_metropolis(W_dev, mask)
        # gossip-matrix mixing: X <- W X over the packed node axis
        with record_function("swarm.gossip"):
            params = tr.matrix_mix(params, W_eff)
        return (SwarmState(params, opt, state.prev, state.step + 1),
                metrics_of(params, losses, lr, track_potential, mask,
                           mesh=mesh))
    return EngineStep(step, lr_fn, mesh=mesh)
