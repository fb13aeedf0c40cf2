"""Shared scaffolding for the baselines (counterpart of
``repro/algorithms/common.py``).

Every baseline is a superstep factory over the same node-stacked
``SwarmState`` as SwarmSGD, with the same step signature
``step(state, batch, perm, h_counts, rng, mask=None, *, u=None)`` (`u`:
the encode's uniforms, drawn from `rng` unless given), built as an
:class:`~repro_torch.core.exchange.EngineStep` whose ``run`` half reads
its inputs from device tensors (so ``core/scan.py`` can capture it), and
its exchange runs through the gather
:class:`~repro_torch.core.exchange.GossipTransport`.

The reference vmaps "gradient plus optimizer update" per node; here a step
is one vmapped gradient over the node axis, then ONE fused ``sgd_update``
sweep over every node (elementwise, so bitwise the per-node update), and a
participation gate is a ``torch.where`` after the sweep — never a loop over
nodes, so a step launches the kernel once.

On a node mesh (``launch/mesh.py``; ``make_algorithm(name, mesh=...)``)
each rank holds its node's state (leading axis 1) and the step's `perm`,
`h_counts` and `mask` stay the global [n] vectors, `perm` on the host: a
rank gates its own update by its entry of the mask, the transport
exchanges over the mesh, and the metrics are the global ones.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.profiler import record_function

from repro_torch.core.exchange import (  # noqa: F401
    GossipTransport, global_scalars, make_local_steps, masked_mean_loss,
    node_grads_fn, select, select_into,
)
from repro_torch.core.potential import gamma_potential


def transport_of(transport, n_nodes: int, mesh) -> GossipTransport:
    """The baseline's transport: the one given, or gather on `mesh` (None:
    one shard); a transport built on another mesh than `mesh` raises."""
    tr = transport or GossipTransport(n_nodes, mesh=mesh)
    if mesh is not None and tr.mesh is not mesh:
        raise ValueError("the transport is not built on the step's mesh "
                         "(GossipTransport(..., mesh=mesh))")
    return tr


def fold_batch(batch: dict) -> dict:
    """[n, h, b, ...] node batches -> [n, h*b, ...]: one microbatch per
    node (the per-interaction batch of the H=1 baselines)."""
    return {k: v.reshape((v.shape[0], -1) + tuple(v.shape[3:]))
            for k, v in batch.items()}


def node_grad_step(loss_fn: Callable, opt_update: Callable):
    """One SGD step on every node: (params, opt, microbatch, lr) ->
    (params', opt', per-node losses), params/opt/microbatch node-stacked.
    Gradients come from one vmap over the node axis (`node_grads_fn`),
    the update from one optimizer sweep."""
    node_grads = node_grads_fn(loss_fn)

    def f(params, opt, mb, lr):
        with record_function("swarm.grad"):
            grads, losses = node_grads(params, mb)
        with record_function("swarm.sgd"):
            p, o = opt_update(params, grads, opt, lr)
        return p, o, losses
    return f


def gated_grad_step(loss_fn: Callable, opt_update: Callable):
    """`node_grad_step` gated by participation: inactive nodes keep their
    parameters and optimizer state bitwise and report a zero loss. With
    every node active the values are bitwise the ungated step's."""
    gs = node_grad_step(loss_fn, opt_update)

    def f(params, opt, mb, lr, active):
        p2, o2, losses = gs(params, opt, mb, lr)
        # in place into the fresh update (nothing else holds it)
        p, o = select_into(active, p2, params), select_into(active, o2, opt)
        del p2, o2
        return p, o, torch.where(active, losses, 0.0)
    return f


# the gated local loop IS the swarm engine's local-step loop — one
# definition in core/exchange.py, so the h-gating and loss convention
# cannot diverge
gated_local_loop = make_local_steps


def metrics_of(params, losses, lr, track_potential=True, mask=None, *,
               mesh=None, **extra):
    """The step's metrics: the loss over the participants, Γ and `extra`.
    On a node `mesh` (the rank's `losses` [1], the global `mask`) the
    losses are all-gathered and Γ all-reduced, so every rank reports the
    global metrics."""
    if mesh is not None:
        losses = global_scalars(mesh, losses)
    m = {"loss": masked_mean_loss(losses, mask), "lr": lr, **extra}
    if track_potential:
        with record_function("swarm.gamma"):
            m["gamma"] = gamma_potential(params, mesh=mesh)
    return m


def refresh_prev(prev, src, matched):
    """Comm-copy refresh on interaction: matched nodes take `src` (what the
    next quantized encode measures its distance against), the others keep
    their copy — the swarm engine's rule."""
    if prev is None:
        return None
    with record_function("swarm.prev"):
        return select(matched, src, prev)
