"""Stochastic Gradient Push (Assran et al.; counterpart of
``repro/algorithms/sgp.py``): push-sum gossip over a directed one-peer
exponential graph. Each node keeps (X, w); every step it averages both
with its in-neighbour (cyclic offset 2^(t mod log2 n)); the de-biased
model is X / w.

The push-sum pair rides as ONE payload, ``state.params = {"model": X,
"w": w}``: flattened in sorted-key order, w packs as one extra 256-wide row
group after the model, so the exchange is a single flat-buffer `mix_pair`
(every stateless codec included: the lattice family and bf16; top-k's
residual would hold back mass the push-sum de-biasing counts) whose perm
is the cyclic shift — a permutation but
not an involution — and `state.prev` is the comm copy of that payload.

Under a participation mask node i averages with its in-neighbour only
when BOTH are active; that mixing is row- but not column-stochastic, which
is what the push-sum weights correct for.

On a node mesh each rank holds its node's (X, w) (w its [1]) and the
shift crosses as one message a wire tensor from its in-neighbour and one
to its out-neighbour, two different ranks: the mesh's first exchange by a
permutation that is not an involution.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.algorithms.common import (fold_batch, metrics_of,
                                           node_grad_step, refresh_prev,
                                           select, transport_of)
from repro_torch.core.exchange import (EngineStep, GossipTransport, _rows,
                                       own_rows)
from repro_torch.core.swarm import SwarmState
from repro_torch.tree import tree_leaves, tree_map


def sgp_init_state(state: SwarmState, n_nodes: int,
                   quantize: bool = False, *, mesh=None) -> SwarmState:
    """Wrap a fresh swarm state into SGP's payload layout: params becomes
    the push-sum pair {"model": X, "w": 1}, prev (quantized runs only) its
    comm copy — the quantizer's distance proxy, w included. On a node
    `mesh` the state is the rank's node and w its [1]."""
    device = tree_leaves(state.params)[0].device
    payload = {"model": state.params,
               "w": torch.ones((n_nodes if mesh is None else 1,),
                               dtype=torch.float32, device=device)}
    prev = tree_map(torch.clone, payload) if quantize else None
    return SwarmState(payload, state.opt, prev, state.step)


def _scale(tree, w, op):
    """Each node's leaves times (or over) its w, in fp32, back in the leaf
    dtype."""
    def f(x):
        wi = _rows(w, x.ndim)
        xf = x.to(torch.float32)
        return (xf * wi if op == "mul" else xf / wi).to(x.dtype)
    return tree_map(f, tree)


def sgp_debias(payload) -> dict:
    """De-biased node-stacked model tree X / w from the push-sum payload
    ``{"model": X, "w": w}`` — what evaluation reads."""
    return _scale(payload["model"], payload["w"], "div")


def make_step(loss_fn, opt_update, lr_fn, n_nodes,
              track_potential: bool = True,
              transport: GossipTransport = None, quantize: bool = False, *,
              mesh=None):
    tr = transport_of(transport, n_nodes, mesh)
    mesh = tr.mesh
    log_n = max(1, int(math.log2(n_nodes)))
    gs = node_grad_step(loss_fn, opt_update)

    def step(state: SwarmState, batch, inp, rng, *, u=None):
        X, w = state.params["model"], state.params["w"]
        lr, mask = inp.lr, inp.mask
        device = lr.device
        # de-bias before the gradient step (SGP evaluates at X / w), then
        # re-bias: the push-sum numerator stays consistent
        Xd = sgp_debias(state.params)
        X2, opt2, losses = gs(Xd, state.opt, fold_batch(batch), lr)
        del Xd
        X2 = _scale(X2, w, "mul")
        if mask is None:
            X, opt = X2, opt2
        else:
            mine = own_rows(mask, mesh)
            X, opt = select(mine, X2, X), select(mine, opt2, state.opt)
            losses = torch.where(mine, losses, 0.0)
        del X2, opt2

        # one-peer exponential: average with in-neighbour (i - 2^(t mod k));
        # the offset is host-side, so a captured graph serves one t mod k
        shift = 2 ** (state.step % log_n)
        idx = torch.arange(n_nodes, device=device)
        src = (idx - shift) % n_nodes
        # a directed edge lands only when BOTH endpoints are active
        gate = torch.ones((n_nodes,), dtype=torch.bool, device=device) \
            if mask is None else mask & mask[src]
        # on a node mesh the shift goes by the host perm, and the rank
        # lands by its own gate
        perm_t = src if mesh is None else \
            (np.arange(n_nodes) - shift) % n_nodes
        with record_function("swarm.gossip"):
            mixed = tr.mix_pair({"model": X, "w": w}, perm_t,
                                own_rows(gate, mesh), quantize=quantize,
                                prev=state.prev, rng=rng, u=u, mask=mask)
        del X
        new_prev = refresh_prev(state.prev, mixed, own_rows(gate, mesh))
        return (SwarmState(mixed, opt, new_prev, state.step + 1),
                metrics_of(sgp_debias(mixed) if track_potential else None,
                           losses, lr, track_potential, mask, mesh=mesh,
                           matched_frac=torch.mean(gate.to(torch.float32))))
    return EngineStep(step, lr_fn, key_fn=lambda state: state.step % log_n,
                      mesh=mesh)
