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
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.profiler import record_function

from repro_torch.core.exchange import (  # noqa: F401
    make_local_steps, masked_mean_loss, node_grads_fn, select, select_into,
)
from repro_torch.core.potential import gamma_potential


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


def metrics_of(params, losses, lr, track_potential=True, mask=None,
               **extra):
    m = {"loss": masked_mean_loss(losses, mask), "lr": lr, **extra}
    if track_potential:
        with record_function("swarm.gamma"):
            m["gamma"] = gamma_potential(params)
    return m


def refresh_prev(prev, src, matched):
    """Comm-copy refresh on interaction: matched nodes take `src` (what the
    next quantized encode measures its distance against), the others keep
    their copy — the swarm engine's rule."""
    if prev is None:
        return None
    with record_function("swarm.prev"):
        return select(matched, src, prev)
