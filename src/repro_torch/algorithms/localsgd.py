"""Local SGD (counterpart of ``repro/algorithms/localsgd.py``): every node
takes its h_i <= h_max local steps, then the models are averaged globally
(the paper's Local-SGD baseline, communicating globally every H steps).

The resync is the transport's `global_mean` over the packed parameters:
under a participation mask the mean runs over the participants and is
broadcast to every node (server-broadcast semantics). On a node mesh each
rank runs its own node's h_i steps and the resync all-gathers the ranks'
packed models.
"""
from __future__ import annotations

from torch.profiler import record_function

from repro_torch.algorithms.common import (gated_local_loop, metrics_of,
                                           transport_of)
from repro_torch.core.exchange import EngineStep, GossipTransport, \
    rank_inputs
from repro_torch.core.swarm import SwarmState


def make_step(loss_fn, opt_update, lr_fn, n_nodes, H: int = 2,
              track_potential: bool = True,
              transport: GossipTransport = None, h_max: int = None, *,
              mesh=None):
    tr = transport_of(transport, n_nodes, mesh)
    mesh = tr.mesh
    local = gated_local_loop(loss_fn, opt_update, h_max or H)

    def step(state: SwarmState, batch, inp, rng, *, u=None):
        del rng, u
        lr, mask = inp.lr, inp.mask
        params, opt, losses = local(state.params, state.opt, batch,
                                    rank_inputs(inp, mesh, n_nodes))
        # periodic global model average (participants -> mean -> everyone)
        with record_function("swarm.gossip"):
            params = tr.global_mean(params, mask)
        return (SwarmState(params, opt, state.prev, state.step + 1),
                metrics_of(params, losses, lr, track_potential, mask,
                           mesh=mesh))
    return EngineStep(step, lr_fn, h_max=h_max or H, mesh=mesh)
