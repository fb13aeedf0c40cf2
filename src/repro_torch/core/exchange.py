"""Gossip exchange layer (gather slice of ``repro/core/exchange.py``).

``make_local_steps`` is every node's loop of h_i <= h_max local SGD steps;
:class:`GossipTransport` owns every exchange over the bucketed flat buffer
(``core/bucket.py``), for SwarmSGD and the baselines alike:

  ``mix_pair``    — pairwise average by a node permutation (SwarmSGD and
                    AD-PSGD matchings; SGP's directed one-peer shift is the
                    same primitive with a perm that is not an involution):
                    an fp32 gather, or the codec's encode / permute / fused
                    decode-average through the kernels;
  ``global_mean`` — (masked) mean over the node axis, broadcast back
                    (LocalSGD's resync, AllReduce's gradient mean);
  ``matrix_mix``  — dense mixing X <- W X (D-PSGD);
  ``permute_inflight`` — the wire half of the overlapped pipeline, which on
                    the card runs on a side CUDA stream under the local-step
                    loop.

The transport is the reference's ``gossip_impl``: ``gather`` (the engine's
matching, gathered), ``ppermute`` (one static matching, fixed at build) or
``ppermute_pool`` (an index per superstep into K precompiled matchings,
which the engine's `perm` input carries broadcast to [n]), each over the
flat buffer; ``*_legacy`` selects the reference's per-leaf oracle of the
same transport (``gossip_exact`` / ``gossip_quantized`` and their
ppermute forms), against which the flat paths are held. With every node in
one process on one device — one shard — the ppermute transports permute
locally, as the reference's one-shard branch does. On a node mesh
(``launch/mesh.py``, one node a rank; ``GossipTransport(mesh=...)``) every
transport and its per-leaf oracle exchanges point to point
(``core/bucket.py``): the ppermute transports by their static pairs, the
gather transport by the engine's host perm; ``global_mean`` and
``matrix_mix`` all-gather the ranks' rows and reduce them as on one shard.
What a mesh does not carry yet is ``bucket.NOT_ON_A_MESH``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from repro_torch.core import bucket as B
from repro_torch.quant.codecs import LatticeCodec, WireCodec, make_codec
from repro_torch.quant.schemes import (
    ModularQuantConfig, decode_modular, encode_modular,
)
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten

BASE_IMPLS = ("gather", "ppermute", "ppermute_pool")
GOSSIP_IMPLS = BASE_IMPLS + tuple(f"{b}_legacy" for b in BASE_IMPLS)


def _rows(mask: torch.Tensor, ndim: int):
    return mask.reshape((-1,) + (1,) * (ndim - 1))


def select(active, new, old):
    """Per node: the `new` tree where `active`, else `old` (bitwise)."""
    return tree_map(lambda a, b: torch.where(_rows(active, b.ndim), b, a),
                    old, new)


def select_into(active, new, old):
    """`select`, written into `new`'s own tensors (the caller's fresh
    update, which nothing else holds): one model and momentum less at a
    partial local step's peak."""
    return tree_map(
        lambda a, b: torch.where(_rows(active, b.ndim), b, a, out=b),
        old, new)


def stale_combine(base, params, S, matched):
    """Algorithm 2's landing, X_i <- (S_i + X_j')/2 + (X_i - S_i), for the
    matched nodes: `base` is the averaged superstep-start model, rounded
    to the leaf dtype before the fp32 local delta is added, as the
    reference's tree-level combine does; unmatched nodes keep `params`."""
    return tree_map(
        lambda b, p, s: torch.where(
            _rows(matched, p.ndim),
            (b.to(torch.float32) + (p.to(torch.float32) -
                                    s.to(torch.float32))).to(p.dtype), p),
        base, params, S)


class StepInputs:
    """The per-superstep inputs of an engine step, on the device: the
    learning rate (a 0-d fp32 tensor the optimizer sweep reads through a
    pointer), the matching `perm` (int64 [n]), the local-step counts `h`
    (int32 [n]) and the participation `mask` (bool [n] or None), plus the
    host copy of h (`h_host`), which decides how many local-step sweeps
    run. A CUDA graph reads these tensors where they lie, so the chunk
    driver (``core/scan.py``) refills one StepInputs before each replay;
    the per-step driver builds a fresh one each superstep. `perm_host` is
    the host copy of the matching where the caller gave it on the host
    (None otherwise): a node mesh posts its messages by it."""

    def __init__(self, lr, perm, h, mask, h_host, perm_host=None):
        self.lr, self.perm, self.h, self.mask = lr, perm, h, mask
        self.h_host, self.perm_host = h_host, perm_host

    @classmethod
    def from_host(cls, lr: float, perm, h_counts, mask, device):
        """Host values -> a fresh StepInputs on `device` (each tensor
        that is already on the device passes through)."""
        h_host = tuple(int(x) for x in np.asarray(
            h_counts.cpu() if isinstance(h_counts, torch.Tensor)
            else h_counts).reshape(-1))
        lr_t = torch.tensor(lr, dtype=torch.float32, device=device)
        perm_t = torch.as_tensor(
            perm if isinstance(perm, torch.Tensor) else np.asarray(perm),
            dtype=torch.int64, device=device)
        h_t = torch.as_tensor(
            h_counts if isinstance(h_counts, torch.Tensor)
            else np.asarray(h_counts), dtype=torch.int32, device=device)
        perm_host = None if isinstance(perm, torch.Tensor) \
            and perm.device.type != "cpu" else np.asarray(perm)
        return cls(lr_t, perm_t, h_t, as_mask(mask, device), h_host,
                   perm_host)

    @classmethod
    def static(cls, n_nodes: int, device, masked: bool):
        """Zero-filled buffers a CUDA graph is captured against; the chunk
        driver refills them and sets the host values (`h_host`, and on a
        node mesh `perm_host`, by which the rank posts) before each
        superstep."""
        def z(dt):
            return torch.zeros((n_nodes,), dtype=dt, device=device)
        return cls(torch.zeros((), dtype=torch.float32, device=device),
                   z(torch.int64), z(torch.int32),
                   z(torch.bool) if masked else None, None)


def local_signature(h_host, h_max: int) -> Tuple[int, int]:
    """What the local-step loop's control flow reads from h: the sweeps q
    with some node active (q < max h) and those with every node active (q
    < min h), both bounded by the loop's `h_max`."""
    return (min(max(min(h_host), 0), h_max), min(max(h_host), h_max))


class EngineStep:
    """A superstep in two halves: ``run(state, batch, inputs, rng, **kw)``
    reads its per-superstep inputs from a :class:`StepInputs` and does no
    host work that depends on their values, so it can be captured as a
    CUDA graph; calling the step the uniform way, ``step(state, batch,
    perm, h_counts, rng, mask=None, **kw)``, stages host inputs into a
    fresh StepInputs first. `graph_key(state, h_host, perm_host)` names
    the host values `run`'s control flow depends on (the local-step
    signature for the steps that take h — on a node mesh of the rank's
    own count —, anything algorithm-specific from `key_fn`, and on a node
    mesh the peers `peers_fn` gives for the host perm — a captured graph
    posts to fixed ranks): one captured graph
    serves every superstep with the same key. `mesh` is the node mesh the
    step runs on (None: one shard)."""

    def __init__(self, run, lr_fn, *, h_max: Optional[int] = None,
                 key_fn=None, mesh=None, peers_fn=None):
        self.run = run
        self.lr_fn = lr_fn
        self.h_max = h_max          # None: the step ignores h
        self.key_fn = key_fn
        self.mesh = mesh
        # host perm -> the ranks this rank posts to and from (a step that
        # posts by the perm on a node mesh), else None
        self.peers_fn = peers_fn

    def graph_key(self, state, h_host, perm_host=None) -> tuple:
        if self.mesh is not None:
            # a rank's local steps read its own count (`rank_inputs`)
            h_host = h_host[self.mesh.rank:self.mesh.rank + 1]
        key = () if self.h_max is None else \
            local_signature(h_host, self.h_max)
        if self.key_fn is not None:
            key += (self.key_fn(state),)
        if self.peers_fn is not None:
            key += (self.peers_fn(perm_host),)
        return key

    def __call__(self, state, batch, perm, h_counts, rng, mask=None, **kw):
        device = tree_flatten(state.params)[0][0].device
        inp = StepInputs.from_host(self.lr_fn(state.step), perm, h_counts,
                                   mask, device)
        return self.run(state, batch, inp, rng, **kw)


def node_losses_of(loss_fn):
    """The node-stacked form of a per-node loss: the model's own when
    `loss_fn` is a model's ``functional_loss`` (``TransformerLM.
    functional_node_losses``, which recomputes each block in the backward
    pass under ``cfg.remat``), else ``torch.func.vmap(loss_fn)``."""
    own = getattr(getattr(loss_fn, "__self__", None),
                  "functional_node_losses", None)
    return own if own is not None else torch.func.vmap(loss_fn)


def node_grads_fn(loss_fn):
    """(params, batch) -> (grads, losses) for node-stacked params and
    batches: every node's loss at once over the node axis
    (:func:`node_losses_of`; the reference vmaps), then ONE reverse pass for
    the gradient of the losses' sum — each node's parameters reach only
    its own loss, so a node's gradient is its loss's. The pass runs with
    create_graph off and frees each saved activation as it goes. (Inside
    the vmap, ``torch.func.grad`` builds its backward with create_graph
    on: the double-backward graph, and every activation with it, then
    lives as long as the gradients' wrappers, which the autograd engine's
    device thread lets go of when it next runs — on the card the next
    allocations sometimes found those ~7 GB still held.)"""
    node_losses = node_losses_of(loss_fn)

    def grads_and_losses(params, batch):
        leaves, treedef = tree_flatten(params)
        with torch.enable_grad():
            xs = [x.detach().requires_grad_() for x in leaves]
            losses = node_losses(tree_unflatten(treedef, xs), batch)
            gs = torch.autograd.grad(losses.sum(), xs, allow_unused=True)
        gs = [torch.zeros_like(x) if g is None else g
              for g, x in zip(gs, leaves)]
        return tree_unflatten(treedef, gs), losses.detach()
    return grads_and_losses


def make_local_steps(loss_fn, opt_update, h_max: int):
    """Returns local_steps(params, opt, batch, inp) -> (params, opt,
    per-node mean loss over the h_i active steps).

    params/opt are node-stacked; batch leaves are [n_nodes, h_max, ...];
    `inp` is the superstep's :class:`StepInputs`: its host counts h_host
    decide which sweeps run, the device counts h give each sweep's active
    mask and lr the rate, so the loop does no host to device copy. Step q computes every node's loss and gradient at once
    (:func:`node_grads_fn`), then ONE optimizer sweep updates every node;
    nodes past their h_i (``q >= h_i``, the reference's masked loop) keep
    their parameters and momentum."""
    node_grads = node_grads_fn(loss_fn)

    def local_steps(params, opt, batch, inp):
        h, lr = inp.h_host, inp.lr
        n = len(h)
        device = lr.device
        hc = inp.h.to(torch.float32)
        lsum = torch.zeros((n,), dtype=torch.float32, device=device)
        for q in range(h_max):
            if not any(q < hi for hi in h):
                continue
            with record_function("swarm.grad"):
                grads, losses = node_grads(
                    params, {k: v[:, q] for k, v in batch.items()})
            active = q < hc
            lsum = lsum + torch.where(active, losses.to(torch.float32), 0.0)
            with record_function("swarm.sgd"):
                p2, o2 = opt_update(params, grads, opt, lr)
            del grads
            if not all(q < hi for hi in h):
                # in place into the fresh update: the idle nodes' rows
                # take their parameters and momentum back
                p2, o2 = select_into(active, p2, params), \
                    select_into(active, o2, opt)
            params, opt = p2, o2
            del p2, o2
        return params, opt, lsum / torch.clamp_min(hc, 1.0)
    return local_steps


def as_mask(mask, device) -> Optional[torch.Tensor]:
    """A participation mask (bool [n_nodes], host array or tensor) as a
    bool tensor on `device` (a bool tensor there passes through); None
    stays None."""
    if mask is None:
        return None
    if isinstance(mask, torch.Tensor):
        return mask.to(device=device, dtype=torch.bool)
    return torch.as_tensor(np.asarray(mask, bool), device=device)


def land(ready) -> None:
    """Order the current stream after an in-flight permute
    (``GossipTransport.permute_inflight``'s `ready`: the side stream's
    event, a node mesh's posted work, None on one shard on the CPU)."""
    if ready is not None:
        ready.wait()


def masked_mean_loss(losses, mask):
    """Loss over participants; the plain mean for mask=None."""
    if mask is None:
        return torch.mean(losses)
    m = mask.to(torch.float32)
    return torch.sum(torch.where(mask, losses, 0.0)) / \
        torch.clamp_min(torch.sum(m), 1.0)


def global_scalars(mesh, x) -> torch.Tensor:
    """On a node mesh, every rank's scalar `x` (a 0-d or [1] tensor: the
    rank's loss), all-gathered -> fp32 [mesh.size], in rank order."""
    mine = x.reshape(1).to(torch.float32)
    parts = [torch.empty_like(mine) for _ in range(mesh.size)]
    dist.all_gather(parts, mine, group=mesh.group)
    return torch.cat(parts)


def own_rows(x, mesh):
    """The rank's entry ([1]) of a global per-node vector on a node mesh
    (a mask, a landing mask); the vector itself on one shard (None stays
    None)."""
    if mesh is None or x is None:
        return x
    return x[mesh.rank:mesh.rank + 1]


def rank_inputs(inp: "StepInputs", mesh, n_nodes: int) -> "StepInputs":
    """The rank's own entries of the global inputs, for its local steps
    (the inputs themselves on one shard)."""
    if mesh is None:
        return inp
    if len(inp.h_host) != n_nodes:
        raise ValueError(f"h_counts of {len(inp.h_host)} on a node mesh of "
                         f"{n_nodes}: the global vector")
    r = slice(mesh.rank, mesh.rank + 1)
    return StepInputs(inp.lr, inp.perm, inp.h[r], own_rows(inp.mask, mesh),
                      inp.h_host[r], inp.perm_host)


def matching(tr: "GossipTransport", inp: "StepInputs", n_nodes: int):
    """-> (the perm the transport takes, the node perm [n], the landing
    mask [n] (the matching's non-fixed points gated by the participation
    mask), the landing mask this process lands by). On one shard the
    transport takes `inp.perm` and lands by the whole mask; on a node mesh
    it takes the global host perm (under ppermute_pool the pool index
    broadcast) and the rank lands by its own entry ([1])."""
    mesh, perm_h = tr.mesh, inp.perm_host
    if mesh is not None:
        if perm_h is None or perm_h.shape != (n_nodes,):
            raise ValueError("on a node mesh the step takes the global "
                             f"[{n_nodes}] perm on the host (numpy or a CPU "
                             "tensor)")
        if tr.base_impl == "ppermute" and not np.array_equal(
                perm_h, B._perm_from_pairs(n_nodes, tr.static_pairs)):
            raise ValueError(f"perm {perm_h.tolist()} disagrees with the "
                             f"transport's static pairs {tr.static_pairs}")
    node_perm, _ = tr.resolve_perm(inp.perm)
    matched = node_perm != torch.arange(n_nodes, device=node_perm.device)
    if inp.mask is not None:
        matched = matched & inp.mask
    if mesh is None:
        return inp.perm, node_perm, matched, matched
    return perm_h, node_perm, matched, own_rows(matched, mesh)


# ---------------------------------------------------------------------------
# The per-leaf oracles (one exchange per tree leaf)
# ---------------------------------------------------------------------------


def _avg(x, xp, matched):
    """(x + xp) / 2 in fp32, cast back, where matched; else x."""
    out = (x.to(torch.float32) + xp.to(torch.float32)) * 0.5
    return torch.where(_rows(matched, x.ndim), out.to(x.dtype), x)


def gossip_exact(params, perm, matched, *, mesh=None):
    """The per-leaf exact gather: each leaf averaged with its perm[i]
    row, where matched. On a node `mesh` (the rank's leaves, the global
    host `perm`, the rank's `matched` [1]) each leaf crosses as one
    message (``bucket.post_gather``)."""
    if mesh is not None:
        return _per_leaf_on_mesh(
            params, lambda p: B.post_gather(p, mesh, perm), matched, None,
            None, None, None, mesh)
    return tree_map(lambda x: _avg(x, x[perm], matched), params)


def gossip_quantized(qcfg: ModularQuantConfig, params, prev, perm, matched,
                     rng, *, u=None, mesh=None):
    """The per-leaf lattice exchange: each node encodes each leaf against
    its own comm copy `prev` (every node's leaf blocked on its own), the
    codes and scales move by `perm`, and the receiver decodes against its
    own leaf and averages where matched. `u` lists each leaf's uniforms
    ([n_nodes, nblocks, block], in flatten order); drawn from `rng` leaf
    by leaf when not given. On a node `mesh` as :func:`gossip_exact`, the
    codes and scales of each leaf one message each."""
    if mesh is not None:
        return _per_leaf_on_mesh(
            params, lambda p: B.post_gather(p, mesh, perm), matched, qcfg,
            prev, rng, u, mesh)
    leaves, tdef = tree_flatten(params)
    prev_leaves = tree_leaves(prev)
    out = []
    for i, (x, pv) in enumerate(zip(leaves, prev_leaves)):
        n = x.shape[0]
        q, s = encode_modular(qcfg, x, pv, rng,
                              u=None if u is None else u[i], lead=1)
        qp = B.permute_rows(q, perm, n)   # <- the payload crosses nodes
        sp = s[perm]
        xh = decode_modular(qcfg, qp, sp, x, lead=1)
        out.append(_avg(x, xh, matched))
    return tree_unflatten(tdef, out)


def _per_leaf_on_mesh(params, post, matched, quant, prev, rng, u, mesh,
                      idle: bool = False):
    """The per-leaf oracle's share of one rank of a node mesh: one message
    per leaf (per leaf and wire group when quantized) through `post`
    (payload -> ``bucket.Posted``), one leaf at a time, landing where
    `matched` ([1]) says; an `idle` rank (no partner) keeps its leaves.
    The uniforms, unless given, come from `rng` itself, drawn by every
    rank, idle or not: the reference's per-leaf ``shard_map`` splits the
    same key on every shard, so every rank draws the same ones."""
    leaves, tdef = tree_flatten(params)
    for x in leaves:
        B._one_node_a_rank(x, mesh)
    if quant is not None and u is None:
        u = [torch.rand((x.shape[0], -(-x[0].numel() // quant.block),
                         quant.block), generator=rng, dtype=torch.float32,
                        device=x.device) for x in leaves]
    if idle:
        return tree_unflatten(tdef, list(leaves))
    prev_leaves = tree_leaves(prev) if quant is not None else leaves
    out = []
    for i, (x, pv) in enumerate(zip(leaves, prev_leaves)):
        if quant is None:
            xh, = post((x,)).wait()
        else:
            q, s = encode_modular(quant, x, pv, None, u=u[i], lead=1)
            qp, sp = post((q, s)).wait()
            xh = decode_modular(quant, qp, sp, x, lead=1)
        out.append(_avg(x, xh, matched))
    return tree_unflatten(tdef, out)


def _per_leaf_by_pairs(params, pairs, quant, prev, rng, u, mesh):
    """The per-leaf ppermute oracle's share of one rank (the reference's
    per-leaf ``shard_map``): by the static `pairs`, to and from the rank's
    partner."""
    return _per_leaf_on_mesh(
        params, lambda p: B.post_exchange(p, mesh, pairs),
        B.mesh_landing(mesh, pairs, None, tree_leaves(params)[0].device),
        quant, prev, rng, u, mesh,
        idle=B.mesh_peers(pairs, mesh) == (None, None))


def gossip_ppermute(params, pairs, quant: Optional[ModularQuantConfig] = None,
                    prev=None, rng=None, *, u=None, mesh=None):
    """The per-leaf oracle of the static-matching transport: on one shard
    a local permute by the static (src, dst) `pairs`, exact or through
    the lattice of `quant`; on a node `mesh` the rank's leaves ([1, ...]
    each) cross leaf by leaf to and from its partner."""
    if mesh is not None:
        return _per_leaf_by_pairs(params, pairs, quant, prev, rng, u, mesh)
    x0 = tree_leaves(params)[0]
    perm = B.device_constant(B._perm_from_pairs(x0.shape[0], pairs),
                             x0.device)
    matched = perm != torch.arange(x0.shape[0], device=x0.device)
    return gossip_exact(params, perm, matched) if quant is None else \
        gossip_quantized(quant, params, prev, perm, matched, rng, u=u)


def gossip_ppermute_pool(params, pool, pool_idx, quant=None, prev=None,
                         rng=None, *, u=None, mesh=None):
    """`gossip_ppermute` by the pool entry `pool_idx` selects (on a node
    `mesh` a host index, ``bucket.pool_pairs``)."""
    if mesh is not None:
        return _per_leaf_by_pairs(params, B.pool_pairs(pool, pool_idx),
                                  quant, prev, rng, u, mesh)
    x0 = tree_leaves(params)[0]
    perm = B.pool_perm(pool, pool_idx, x0.device)
    matched = perm != torch.arange(x0.shape[0], device=x0.device)
    return gossip_exact(params, perm, matched) if quant is None else \
        gossip_quantized(quant, params, prev, perm, matched, rng, u=u)


def make_matching_pool(graph, K: int, seed: int = 0):
    """K precompiled random matchings of G (involution perms), drawn from
    one generator seeded `seed`, as the reference draws them."""
    from repro_torch.core.graph import sample_matching
    rng = np.random.default_rng(seed)
    return [sample_matching(graph, rng) for _ in range(K)]


def static_ppermute_matching(graph, seed: int) -> np.ndarray:
    """THE static involution of the plain ppermute transport, shared by
    `transport_from_config` (its wire pairs) and the driver's
    `sample_gossip_perm` (the engine's matched mask), which must agree."""
    from repro_torch.core.graph import sample_matching
    return sample_matching(graph, np.random.default_rng(seed))


class GossipTransport:
    """Every exchange of one ``gossip_impl`` (see the module docstring):
    the flat buffer for ``gather`` / ``ppermute`` / ``ppermute_pool``, the
    per-leaf oracle for their ``*_legacy`` forms. ``ppermute`` needs its
    `static_pairs` and ``ppermute_pool`` its `matching_pool` (as
    `transport_from_config` builds them). The codec owns the quantized
    wire format; `quant` seeds the lattice family when no codec is given.
    The refusals are the reference's: a codec other than the lattice on a
    per-leaf oracle, a residual codec off ``gather``.

    On a node `mesh` (``launch/mesh.py``; `n_nodes` its size) every
    transport and its oracle exchanges the rank's node point to point, and
    the node perm a method takes is the host array (``ppermute_pool``: the
    pool index broadcast), by which the messages are posted: the
    ppermute transports by their static pairs, ``gather`` by the perm
    itself (any permutation). ``global_mean`` and ``matrix_mix`` take the
    rank's rows and all-gather them."""

    def __init__(self, n_nodes: int, *, impl: str = "gather",
                 quant: Optional[ModularQuantConfig] = None,
                 codec: Optional[WireCodec] = None, static_pairs=None,
                 matching_pool=None, mesh=None):
        if impl not in GOSSIP_IMPLS:
            raise ValueError(f"unknown gossip impl {impl!r}; known: "
                             f"{list(GOSSIP_IMPLS)}")
        self.impl = impl
        self.legacy = impl.endswith("_legacy")
        self.base_impl = impl[:-len("_legacy")] if self.legacy else impl
        if mesh is not None:
            B.check_mesh_nodes(n_nodes, mesh)
        self.n_nodes = n_nodes
        self.codec = codec if codec is not None \
            else LatticeCodec(quant or ModularQuantConfig())
        # the per-leaf oracles speak encode/decode_modular: lattice only
        self.quant = self.codec.quant \
            if isinstance(self.codec, LatticeCodec) \
            else (quant or ModularQuantConfig(block=self.codec.block))
        if self.legacy and not isinstance(self.codec, LatticeCodec):
            raise ValueError(
                f"codec {self.codec.name!r} has no per-leaf form: the "
                "*_legacy oracles exchange encode_modular payloads "
                "(lattice q2..q16 only; see the codec axis of "
                "algorithms/registry.py CAPABILITIES)")
        if self.codec.carries_residual and self.base_impl != "gather":
            raise ValueError(
                f"codec {self.codec.name!r} carries an error-feedback "
                "residual, which only the gather transport threads "
                f"(got --gossip-impl {impl}; see the codec axis of "
                "algorithms/registry.py CAPABILITIES)")
        if self.base_impl == "ppermute" and static_pairs is None:
            raise ValueError("the ppermute transport needs its static_pairs")
        if self.base_impl == "ppermute_pool" and (matching_pool is None
                                                  or len(matching_pool) == 0):
            raise ValueError("the ppermute_pool transport needs its "
                             "matching_pool")
        self.mesh = mesh
        self.static_pairs = static_pairs
        self.matching_pool = matching_pool
        self._side_streams = {}     # CUDA device -> permute_inflight stream

    def routes_per_leaf(self, quantize: bool) -> bool:
        """True when the exchange runs the per-leaf oracle: the *_legacy
        impls only (every codec runs flat)."""
        del quantize
        return self.legacy

    def check_overlap(self, quantize: bool):
        """The pipelined superstep runs on the flat transport only, and
        encodes before it learns the next matching, so a codec whose
        residual updates against the matched mask at encode time cannot
        ride it."""
        if self.legacy:
            raise ValueError("the pipelined overlap mode runs on the flat "
                             "transport only (no *_legacy per-leaf oracles)")
        if quantize and self.codec.carries_residual:
            raise ValueError(
                f"codec {self.codec.name}: the error-feedback residual "
                "updates at encode time against the matched mask, which the "
                "pipelined superstep only learns one interaction later")

    def resolve_perm(self, perm) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The node -> partner permutation of the engine input `perm`, and
        the pool index: ``ppermute_pool``'s `perm` carries the index
        broadcast to [n], and the matching is gathered on the device from
        the stacked pool (no host sync, so a CUDA graph can replay it);
        the other transports take the perm itself (None)."""
        if self.base_impl == "ppermute_pool":
            pool_idx = perm.reshape(-1)[:1]
            return B.pool_perm(self.matching_pool, pool_idx,
                               perm.device), pool_idx
        return perm, None

    def mesh_pairs(self, perm):
        """On a node mesh, the static pairs this superstep's messages go
        by: ``ppermute``'s own, or the pool entry the host `perm` carries
        (``ppermute_pool``)."""
        if self.base_impl == "ppermute":
            return self.static_pairs
        return B.pool_pairs(self.matching_pool, perm)

    def mesh_route(self, perm) -> tuple:
        """On a node mesh, ((dsts...), src): the ranks this rank sends to
        and receives from when it posts by the host `perm` — the same
        functions the posting calls (``bucket.gather_peers`` for gather,
        ``bucket.mesh_peers`` of the static pairs or the pool entry for
        the ppermute transports); a chunk keys its graphs by it."""
        if self.base_impl == "gather":
            dsts, src = B.gather_peers(perm, self.mesh)
            return tuple(dsts), src
        dst, src = B.mesh_peers(self.mesh_pairs(perm), self.mesh)
        return (() if dst is None else (dst,)), src

    def mesh_post(self, payload, perm) -> B.Posted:
        """On a node mesh, post this rank's share of one permute of
        `payload` by the host `perm`: the gather by the perm itself, the
        ppermute transports by their static pairs."""
        if self.base_impl == "gather":
            return B.post_gather(payload, self.mesh, perm)
        return B.post_exchange(payload, self.mesh, self.mesh_pairs(perm))

    def _wire_permute(self, payload, perm):
        if self.base_impl == "ppermute":
            return B.permute_payload_ppermute(payload, self.static_pairs,
                                              self.n_nodes)
        if self.base_impl == "ppermute_pool":
            return B.permute_payload_pool(payload, self.matching_pool,
                                          perm.reshape(-1)[:1], self.n_nodes)
        return tuple(B.permute_rows(x, perm, self.n_nodes) for x in payload)

    def permute_inflight(self, payload: Sequence[torch.Tensor], perm):
        """The wire half of the overlapped pipeline: ONE permute per
        already-encoded payload tensor (by the engine's matching, the
        static pairs or the pool entry) -> (received tuple, ready). On
        the card the permutes run on a side stream, so they overlap the
        local steps the caller launches next on the current stream; the
        caller makes the current stream wait on `ready` (:func:`land`)
        before it reads the received tensors. On the CPU, ready is None.

        On a node mesh the rank posts its messages to and from its
        partners here (`perm` the host array, :meth:`mesh_post`) and
        `ready` is the posted work: the transfer is in flight across
        whatever the caller launches next, and :func:`land` waits on it."""
        if self.mesh is not None:
            posted = self.mesh_post(payload, perm)
            return posted.recv, posted
        if perm.device.type != "cuda":
            return self._wire_permute(payload, perm), None
        dev = perm.device
        current = torch.cuda.current_stream(dev)
        side = self._side_streams.get(dev)
        if side is None:
            side = self._side_streams[dev] = torch.cuda.Stream(device=dev)
        # the wire (and the perm) were produced on the current stream
        side.wait_stream(current)
        with torch.cuda.stream(side):
            recv = self._wire_permute(payload, perm)
            ready = torch.cuda.Event()
            ready.record(side)
        # the allocator may hand the inputs' memory on only after the side
        # stream's reads, and the outputs' only after the current stream's
        for x in payload:
            x.record_stream(side)
        perm.record_stream(side)
        for y in recv:
            y.record_stream(current)
        return recv, ready

    def mix_pair(self, tree, perm, matched, *, quantize: bool = False,
                 prev=None, prev_buf=None, rng=None, u=None, mask=None,
                 residual=None):
        """Average each node's `tree` entry with the entry of node perm[i]
        (a matching's involution, fixed points unmatched, or SGP's directed
        shift); `matched` is the landing mask, already gated by the
        participation `mask`. As in the reference, the exact gather applies
        `matched` only when a `mask` is given (an involution's fixed points
        average with themselves unchanged). Quantized, each node encodes
        against its comm copy — the tree `prev`, or under
        ``compress_state`` the packed buffer `prev_buf` decoded from the
        compressed copy — with uniforms `u` (drawn from `rng` unless
        given), and the receiver decodes against its own model; unmatched
        rows keep their model.

        The ppermute transports exchange by their static pairs or by the
        pool entry `perm` carries, `mask` gating which of its pairs land;
        the *_legacy oracles run the same exchange leaf by leaf (their
        uniforms `u` a list, one [n, nblocks, block] tensor a leaf), and
        the ppermute oracles refuse a `mask`, as the reference's do.

        On a node mesh `tree`, `prev`, `prev_buf`, `u` and `residual` are
        the rank's rows, `perm` and `mask` the global host perm and mask,
        and `matched` the rank's landing flag ([1]; :func:`matching`).

        With an error-feedback codec (``codec.carries_residual``) a
        quantized call takes and returns the buffer-shaped residual: ->
        (mixed tree, new residual); every other call returns the tree."""
        if self.legacy:
            return self._mix_per_leaf(tree, perm, matched, quantize, prev,
                                      prev_buf, rng, u, mask)
        ef = quantize and self.codec.carries_residual
        layout = B.build_layout(tree, block=self.codec.block)
        with record_function("gossip.pack"):
            buf = B.pack(layout, tree)
            pbuf = None
            if quantize:
                pbuf = prev_buf if prev_buf is not None else \
                    B.pack(layout, prev)
        new_residual = None
        codec = self.codec if quantize else None
        if self.mesh is not None and self.base_impl != "gather":
            out = B.gossip_flat_ppermute(buf, self.mesh_pairs(perm),
                                         quant=codec, prev_buf=pbuf, rng=rng,
                                         u=u, mask=mask, mesh=self.mesh)
        elif self.base_impl == "ppermute":
            out = B.gossip_flat_ppermute(buf, self.static_pairs, quant=codec,
                                         prev_buf=pbuf, rng=rng, u=u,
                                         mask=mask)
        elif self.base_impl == "ppermute_pool":
            out = B.gossip_flat_ppermute_pool(
                buf, self.matching_pool, perm.reshape(-1)[:1], quant=codec,
                prev_buf=pbuf, rng=rng, u=u, mask=mask)
        elif quantize:
            out, new_residual = B.gossip_flat_coded(
                self.codec, buf, pbuf, perm, matched, rng,
                residual=residual, u=u, mesh=self.mesh)
        else:
            out = B.gossip_flat_exact(buf, perm,
                                      matched if mask is not None else None,
                                      mesh=self.mesh)
        del buf, pbuf
        with record_function("gossip.unpack"):
            mixed = B.unpack(layout, out)
        return (mixed, new_residual) if ef else mixed

    def _mix_per_leaf(self, tree, perm, matched, quantize, prev, prev_buf,
                      rng, u, mask):
        if mask is not None and self.base_impl != "gather":
            raise NotImplementedError(
                "participation masks run on the flat transports and the "
                "gather_legacy oracle only; the per-leaf ppermute oracles "
                "bake a full static matching")
        if prev_buf is not None:
            raise ValueError("prev_buf (compress_state) needs the flat "
                             "packed transport")
        lat = self.quant if quantize else None
        with record_function("gossip.legacy"):
            if self.mesh is not None and self.base_impl != "gather":
                return gossip_ppermute(tree, self.mesh_pairs(perm), lat,
                                       prev, rng, u=u, mesh=self.mesh)
            if self.base_impl == "ppermute":
                return gossip_ppermute(tree, self.static_pairs, lat, prev,
                                       rng, u=u)
            if self.base_impl == "ppermute_pool":
                return gossip_ppermute_pool(tree, self.matching_pool,
                                            perm.reshape(-1)[:1], lat, prev,
                                            rng, u=u)
            if quantize:
                return gossip_quantized(lat, tree, prev, perm, matched, rng,
                                        u=u, mesh=self.mesh)
            return gossip_exact(tree, perm, matched, mesh=self.mesh)

    def global_mean(self, tree, mask=None):
        """(Masked) mean over the node axis, broadcast back to every node —
        LocalSGD's resync and AllReduce's gradient mean. With `mask` the
        mean runs over the participants only and is still broadcast
        everywhere. A *_legacy oracle takes it leaf by leaf. On a node
        mesh (the rank's rows, the global `mask`) the rows are
        all-gathered and reduced as on one shard, bitwise."""
        if self.legacy:
            return tree_map(lambda x: self._on_rows(
                lambda rows: _leaf_mean(rows, mask), x), tree)
        layout = B.build_layout(tree, block=self.codec.block)
        with record_function("gossip.pack"):
            buf = B.pack(layout, tree)
        with record_function("gossip.mean"):
            out = B.gossip_flat_mean(buf, mask, mesh=self.mesh)
        del buf
        with record_function("gossip.unpack"):
            return B.unpack(layout, out)

    def matrix_mix(self, tree, W):
        """Dense mixing X <- W X (D-PSGD): one [n, n] x [n, n_padded] fp32
        product over the packed buffer (one per leaf for a *_legacy
        oracle). On a node mesh (the rank's rows, `W` the replicated
        [n, n]) the rows are all-gathered, the same product runs, and the
        rank keeps its row."""
        if self.legacy:
            return tree_map(lambda x: self._on_rows(lambda rows: torch.einsum(
                "nm,m...->n...", W.to(torch.float32),
                rows.to(torch.float32)).to(x.dtype), x), tree)
        layout = B.build_layout(tree, block=self.codec.block)
        with record_function("gossip.pack"):
            buf = B.pack(layout, tree)
        with record_function("gossip.matrix"):
            out = B.gossip_flat_matrix(W, buf, mesh=self.mesh)
        del buf
        with record_function("gossip.unpack"):
            return B.unpack(layout, out)

    def _on_rows(self, fn, x):
        """fn over every node's rows of one leaf: `x` itself on one shard;
        on a node mesh every rank's row all-gathered, and the rank's row
        of the result."""
        if self.mesh is None:
            return fn(x)
        r = self.mesh.rank
        return fn(B.all_gather_rows(x, self.mesh))[r:r + 1].contiguous()

    def partner_tree(self, tree, perm):
        """On a node mesh, the partner's `tree` (the rank's leaves,
        [1, ...] each): packed to one fp32 buffer, ONE message each way
        (:meth:`mesh_post`), unpacked to the leaf dtypes (exact: every
        leaf dtype is carried by fp32); zeros where a ppermute pairing
        gives the rank no partner, its own tree at a gather's fixed
        point."""
        layout = B.build_layout(tree, block=self.codec.block)
        recv, = self.mesh_post((B.pack(layout, tree),), perm).wait()
        return B.unpack(layout, recv)

    def payload_num_bytes(self, tree, quantize: bool = False) -> int:
        """Exact wire bytes per node for one gossip send of `tree`, from
        the codec's declared layout (fp32 when not quantized)."""
        layout = B.build_layout(tree, block=self.codec.block)
        return layout.payload_num_bytes(self.codec if quantize else None)

    def residual_like(self, tree) -> Optional[torch.Tensor]:
        """The zero error-feedback residual for `tree` ([n_nodes,
        n_padded] fp32 on its device), or None for a codec without one."""
        if not self.codec.carries_residual:
            return None
        layout = B.build_layout(tree, block=self.codec.block)
        return torch.zeros((layout.n_nodes, layout.n_padded),
                           dtype=torch.float32,
                           device=tree_flatten(tree)[0][0].device)


def _leaf_mean(x, mask):
    """One leaf's (masked) fp32 mean over the node axis, broadcast back:
    the terms summed node by node in node order, as the flat buffer's
    reduction over its rows sums them on the CPU (so the oracle equals the
    flat transport bitwise there, as the reference's does)."""
    xf = x.to(torch.float32)
    if mask is not None:
        w = mask.to(torch.float32)
        xf = _rows(w, x.ndim) * xf
    acc = xf[0]
    for i in range(1, xf.shape[0]):
        acc = acc + xf[i]
    mu = acc / xf.shape[0] if mask is None else \
        acc / torch.clamp_min(torch.sum(w), 1.0)
    return mu.to(x.dtype).expand(x.shape).contiguous()


def transport_from_config(scfg, graph=None, seed: int = 0,
                          mesh=None) -> GossipTransport:
    """The driver's one transport for every algorithm: `scfg.gossip_impl`
    on the codec of `scfg.codec` (the lattice family seeded by
    `scfg.quant`). ``ppermute`` bakes in the static matching of `graph`
    drawn from `seed` (``static_ppermute_matching``, which the driver
    feeds the engine too); ``ppermute_pool`` the `scfg.pool_size`
    matchings of `make_matching_pool(graph, K, seed)`, or under a
    two-tier `scfg.topology` its intra matchings followed by the
    inter-group perms (``HierTopology.matching_pool``). On a node `mesh`
    the transport is the mesh's (``GossipTransport(..., mesh=)``)."""
    impl = scfg.gossip_impl
    base = impl[:-len("_legacy")] if impl.endswith("_legacy") else impl
    quant = getattr(scfg, "quant", None)
    kw = {}
    if base == "ppermute":
        kw["static_pairs"] = B.pairs_from_perm(
            static_ppermute_matching(graph, seed))
    elif base == "ppermute_pool":
        from repro_torch.core.hier import parse_topology
        topo = parse_topology(scfg.topology, scfg.n_nodes)
        K = scfg.pool_size
        if topo is not None:
            kw["matching_pool"], _ = topo.matching_pool(K, seed)
        else:
            kw["matching_pool"] = make_matching_pool(graph, K=K, seed=seed)
    return GossipTransport(scfg.n_nodes, impl=impl, quant=quant,
                           codec=make_codec(getattr(scfg, "codec", None),
                                            quant), mesh=mesh, **kw)
