"""Large-batch data-parallel SGD (the paper's LB-SGD baseline; counterpart
of ``repro/algorithms/allreduce.py``): every step the gradients are
averaged over ALL nodes and the mean is applied everywhere.

The node-stacked bf16 gradients pack into one fp32 flat buffer, the
transport's `global_mean` takes their node mean (over the participants
under a mask, applied everywhere: backup-worker semantics), unpacks it to
bf16, and one optimizer sweep applies it — so nodes that start equal stay
bitwise equal. On a node mesh the mean all-gathers the ranks' packed
gradients and reduces them as on one shard, so every rank applies the
same bits.
"""
from __future__ import annotations

from torch.profiler import record_function

from repro_torch.algorithms.common import (fold_batch, metrics_of,
                                           transport_of)
from repro_torch.core.exchange import EngineStep, GossipTransport, \
    node_grads_fn
from repro_torch.core.swarm import SwarmState


def make_step(loss_fn, opt_update, lr_fn, n_nodes,
              track_potential: bool = True,
              transport: GossipTransport = None, *, mesh=None):
    tr = transport_of(transport, n_nodes, mesh)
    mesh = tr.mesh
    node_grads = node_grads_fn(loss_fn)

    def step(state: SwarmState, batch, inp, rng, *, u=None):
        del rng, u
        lr, mask = inp.lr, inp.mask
        # every node contributes one microbatch: its H slots folded in
        with record_function("swarm.grad"):
            grads, losses = node_grads(state.params, fold_batch(batch))
        # all-reduce: the (participants') mean gradient, applied everywhere
        with record_function("swarm.gossip"):
            grads = tr.global_mean(grads, mask)
        with record_function("swarm.sgd"):
            params, opt = opt_update(state.params, grads, state.opt, lr)
        del grads
        return (SwarmState(params, opt, state.prev, state.step + 1),
                metrics_of(params, losses, lr, track_potential, mask,
                           mesh=mesh))
    return EngineStep(step, lr_fn, mesh=mesh)
