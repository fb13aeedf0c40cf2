"""AD-PSGD (Lian et al.; counterpart of ``repro/algorithms/adpsgd.py``):
one gradient step, then a pairwise average with a random matching partner
every interaction — SwarmSGD with H = 1, the paper's closest prior art.

The pairwise average is the swarm engine's `mix_pair` over the flat
buffer: exact fp32, or any codec of the transport (the `prev` comm copy as
the distance proxy; top-k threads its error-feedback residual through the
state), blocking or non-blocking (the stale Algorithm-2 combine:
the partner contributes its pre-step model, each node's own gradient
delta rides on top), under an optional participation mask. On a node mesh
each rank averages its node with its partner's by the global host perm
(any transport), landing by its own entry of the matched mask.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from repro_torch.algorithms.common import (fold_batch, gated_grad_step,
                                           metrics_of, node_grad_step,
                                           refresh_prev, transport_of)
from repro_torch.core.exchange import (EngineStep, GossipTransport, matching,
                                       own_rows, stale_combine)
from repro_torch.core.swarm import SwarmState


def make_step(loss_fn, opt_update, lr_fn, n_nodes,
              track_potential: bool = True,
              transport: GossipTransport = None,
              quantize: bool = False, nonblocking: bool = False, *,
              mesh=None):
    tr = transport_of(transport, n_nodes, mesh)
    mesh = tr.mesh
    gs_plain = node_grad_step(loss_fn, opt_update)
    gs_gated = gated_grad_step(loss_fn, opt_update)

    ef = quantize and tr.codec.carries_residual

    def step(state: SwarmState, batch, inp, rng, *, u=None):
        lr, mask = inp.lr, inp.mask
        S = state.params                  # pre-step models (staleness ref)
        mb = fold_batch(batch)
        if mask is None:
            params, opt, losses = gs_plain(S, state.opt, mb, lr)
        else:
            params, opt, losses = gs_gated(S, state.opt, mb, lr,
                                           own_rows(mask, mesh))
        # the matching; `matched` is what this process lands by (on a node
        # mesh the rank's entry of `matched_all`)
        perm_t, _, matched_all, matched = matching(tr, inp, n_nodes)

        new_residual = state.residual

        def mix(tree):
            nonlocal new_residual
            out = tr.mix_pair(tree, perm_t, matched, quantize=quantize,
                              prev=state.prev if quantize else None,
                              rng=rng, u=u, mask=mask,
                              residual=state.residual)
            if ef:
                out, new_residual = out
            return out

        with record_function("swarm.gossip"):
            if nonblocking:
                # stale averaging (the original asynchronous AD-PSGD): the
                # partner contributes its PRE-STEP model, each node's fresh
                # gradient delta rides on top — Algorithm 2 with H = 1
                base = mix(S)
                params = stale_combine(base, params, S, matched)
                del base
            else:
                params = mix(params)
        new_prev = refresh_prev(state.prev, S if nonblocking else params,
                                matched)
        return (SwarmState(params, opt, new_prev, state.step + 1, None,
                           new_residual),
                metrics_of(params, losses, lr, track_potential, mask,
                           mesh=mesh, matched_frac=torch.mean(
                               matched_all.to(torch.float32))))
    return EngineStep(step, lr_fn, mesh=mesh,
                      peers_fn=None if mesh is None else tr.mesh_route)
