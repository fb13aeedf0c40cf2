"""SwarmSGD training engine (counterpart of ``repro/core/swarm.py``): the
blocking superstep (Algorithm 1), the non-blocking one (Algorithm 2) and
the overlapped pipeline of the non-blocking one.

Node state is node-stacked (every parameter and optimizer leaf has a
leading [n_nodes] dim). A superstep is

  1. every node's h_i <= h_max local momentum-SGD steps (gradients per
     node, one fused ``sgd_update`` sweep over all nodes per step); h_i is
     H (``h_mode="fixed"``), a clipped geometric draw of mean H, or the
     scheduler bridge's count (``h_mode="trace"``: 0 at non-participants);
  2. one uniformly sampled matching of the interaction graph: matched
     pairs average over the flat-buffer transport — fp32 exact, or with
     ``quantize`` the lattice codec (``quantize_mod`` encode, permute,
     fused ``decode_avg``). Blocking averages the post-local-step models;
     non-blocking averages the superstep-start models S and adds each
     node's own local delta: X_i <- (S_i + S_j) / 2 + (X_i - S_i);
  3. matched nodes refresh their comm copy ``prev`` (the quantized
     encode's distance proxy): blocking to the post-interaction model,
     non-blocking to S, the value it sent.

A participation ``mask`` (bool [n_nodes]) gates the landing: the effective
matching is ``(perm != arange) & mask`` and the loss averages the
participants; with mask=None, or an all-True mask, every path is bitwise
the unmasked engine.

With ``overlap`` the non-blocking superstep is software-pipelined: the
payload of interaction t is encoded at the end of superstep t-1 and rides
in ``SwarmState.inflight``; its permute is dispatched before the local
steps (on a side CUDA stream on the card) and lands against the stale
packed S. ``pipeline_prologue`` primes it, ``pipeline_epilogue`` drains it.

The wire codec is ``cfg.codec`` (``quant/codecs.py``: q2..q16, bf16,
top-k with its error-feedback residual in ``SwarmState.residual``); with
``compress_state`` the blocking path keeps its comm copy as the codec's
wire tuple encoded against zeros, decoded at the top of each superstep.

Every step is an :class:`~repro_torch.core.exchange.EngineStep`: its
``run`` half reads the superstep's inputs from device tensors and can be
captured as a CUDA graph (``core/scan.py``).

On a node mesh (``launch/mesh.py``: one node a ``torch.distributed`` rank,
NCCL on the card, gloo on the CPU; ``swarm_init(mesh=...)`` and
``make_swarm_step(mesh=...)`` on any transport) each rank holds its own
node's state and runs its local steps, its encode and its fused decode on
its own device; the exchange and the momentum average cross point to
point between partners (by the static pairs, or the gather's host perm),
and the metrics are the global ones.

With a model axis (``launch/mesh.py`` ``init_node_mesh(...,
model_parallel=K)``: a node split over K ranks, ``make_swarm_step(...,
param_specs=)``) each rank holds its slices of its node's state and
takes its local steps on them, the model's collectives running over its
node's K ranks; the exchange runs between the ranks of one model index,
each on its own slice's buffer, and Γ is summed over the whole mesh.
The blocking, non-blocking and overlapped supersteps run there, exact or
q8, on gather, ppermute or their per-leaf oracles. The overlapped
pipeline's in-flight buffers are packed from the rank's own slices, and
its permute is posted to the node group before the local steps issue
the model group's all-reduces, the same order on every rank. An encode
folds the run's generator by node, so a node's K ranks draw the same
uniforms and the leaves they hold whole stay bitwise equal.

Elastic membership (a scheduler trace with ``--avail``): a join bin runs
``make_join_step`` — the joiner copies its donor's model, one row gather
on the packed buffer (on a node mesh one message, donor to joiner), no
batch, no encode — in place of a superstep, and ``retire_nodes`` retires
a permanently left node's codec state.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core import bucket as B
from repro_torch.core.exchange import (
    GOSSIP_IMPLS, EngineStep, GossipTransport, _avg, as_mask, global_scalars,
    land, make_local_steps, masked_mean_loss, matching, own_rows,
    rank_inputs, select, stale_combine,
)
from repro_torch.core.potential import gamma_potential
from repro_torch.models.split import NOT_ON_THE_MODEL_AXIS
from repro_torch.quant.codecs import make_codec
from repro_torch.quant.schemes import ModularQuantConfig
from repro_torch.tree import tree_leaves, tree_map

H_MODES = ("fixed", "geometric", "trace")


@dataclass(frozen=True)
class SwarmConfig:
    n_nodes: int
    H: int = 2                   # (mean) local steps per interaction
    h_mode: str = "fixed"        # fixed | geometric (h_i ~ Geom(1/H)) |
    # trace (h supplied by the scheduler bridge, sched/bridge.py)
    h_max: int = 8               # loop bound of the variable h modes
    nonblocking: bool = False    # Algorithm 2 semantics
    overlap: bool = False        # pipelined non-blocking superstep
    quantize: bool = False       # Extension 3: codec-compressed gossip
    quant: ModularQuantConfig = ModularQuantConfig()
    # the wire codec (quant/codecs.py): None follows `quant` (the lattice
    # at quant.bits, q8 by default); "q2".."q16" | "bf16" | "topk:<frac>"
    codec: Optional[str] = None
    average_momentum: bool = False  # the paper averages models only
    track_potential: bool = True    # Γ in the metrics
    # keep the comm copy as the codec's wire tuple, encoded against zeros
    # and decoded lazily in the superstep (quantized blocking path, lattice
    # codecs; validated in algorithms/registry.py)
    compress_state: bool = False
    # the transport (core/exchange.py): gather | ppermute (one static
    # matching) | ppermute_pool (an index a superstep into `pool_size`
    # precompiled matchings), each on the flat buffer; "_legacy" appended
    # selects the per-leaf oracle. The default is gather, as the
    # reference's; unlike the reference the port reads no environment
    # default (REPRO_DEFAULT_GOSSIP_IMPL is not consulted).
    gossip_impl: str = "gather"
    pool_size: int = 8
    # "hier:G[:inter_frac]" two-tier topology (core/hier.py): shapes how
    # the driver samples the matchings and the pool's inter-group suffix
    topology: Optional[str] = None

    def __post_init__(self):
        if self.gossip_impl not in GOSSIP_IMPLS:
            raise ValueError(f"gossip_impl={self.gossip_impl!r}: one of "
                             f"{GOSSIP_IMPLS}")
        if self.h_mode not in H_MODES:
            raise ValueError(f"h_mode={self.h_mode!r}: one of {H_MODES}")
        if self.overlap and not self.nonblocking:
            raise ValueError("overlap=True pipelines Algorithm 2: set "
                             "nonblocking=True")

    def make_codec(self):
        """The run's wire codec (the lattice of `quant` when codec is
        None)."""
        return make_codec(self.codec, self.quant)

    @property
    def h_loop_bound(self) -> int:
        """Bound of the local-step loop and depth of a superstep's batch:
        H for fixed h, h_max for the variable modes (geometric sampling,
        scheduler traces)."""
        return self.H if self.h_mode == "fixed" else self.h_max


@dataclass
class SwarmState:
    params: Any                  # node-stacked tree
    opt: Any                     # node-stacked optimizer state
    prev: Any                    # comm copy: params at last interaction
    step: int
    # overlap only: {"sbuf": packed params at the last superstep boundary,
    # and when quantized "prev": the packed comm copy, "wire": the encoded
    # payload in flight}
    inflight: Any = None
    # error-feedback codecs only: the untransmitted remainder of the last
    # encode, [n_nodes, n_padded] fp32; it re-enters the next encode
    residual: Any = None


def swarm_init(gen: torch.Generator, cfg: SwarmConfig,
               param_init: Callable, opt_init: Callable, *,
               mesh=None) -> SwarmState:
    """Every node starts from the same model, drawn once from `gen`. In
    overlap mode the pipeline is primed here (its encode draws from
    `gen`); under compress_state the comm copy is encoded here (its
    uniforms drawn from `gen`); an error-feedback codec starts from a zero
    residual. On a node `mesh` the state is the rank's one node (leading
    axis 1; every rank draws the same model from `gen`), and an encode
    here draws from the rank's generator folded from `gen`."""
    n_local = cfg.n_nodes
    if mesh is not None:
        B.check_mesh_nodes(cfg.n_nodes, mesh)
        n_local = 1
    one = param_init(gen)
    params = tree_map(lambda x: x.unsqueeze(0).repeat(
        (n_local,) + (1,) * x.ndim), one)
    del one
    opt = opt_init(params)
    enc_gen = (lambda: gen) if mesh is None \
        else (lambda: mesh.fold_generator(gen))
    if cfg.overlap:
        # pipelined mode: the comm copy lives packed in `inflight`
        return pipeline_prologue(cfg, SwarmState(params, opt, None, 0),
                                 enc_gen())
    codec = cfg.make_codec()
    prev = residual = None
    if cfg.compress_state:
        layout = B.build_layout(params, block=codec.block)
        prev = codec.encode_state(B.pack(layout, params), enc_gen())
    elif cfg.quantize or cfg.nonblocking:
        prev = tree_map(torch.clone, params)
    if cfg.quantize and codec.carries_residual:
        layout = B.build_layout(params, block=codec.block)
        residual = torch.zeros((n_local, layout.n_padded),
                               dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
    return SwarmState(params, opt, prev, 0, None, residual)


def pipeline_prologue(cfg: SwarmConfig, state: SwarmState, rng, *,
                      u: Optional[torch.Tensor] = None) -> SwarmState:
    """Prime the pipeline: pack (and, quantized, encode against the comm
    copy with the codec of `cfg`, with uniforms `u` or drawn from `rng`)
    the first in-flight payload. `swarm_init` calls it in
    overlap mode; it is also the re-entry point after
    `pipeline_epilogue`."""
    if not cfg.nonblocking:
        raise ValueError("overlap pipelining implements Algorithm 2: set "
                         "nonblocking=True")
    codec = cfg.make_codec()
    layout = B.build_layout(state.params, block=codec.block)
    buf = B.pack(layout, state.params)
    if cfg.quantize:
        # the first comm copy is a distinct buffer even when it equals the
        # model: the superstep replaces sbuf and prev independently
        prev_buf = B.pack(layout, state.prev) if state.prev is not None \
            else buf.clone()
        wire = codec.encode(buf, prev_buf, rng, u=u)
        infl = {"sbuf": buf, "prev": prev_buf, "wire": wire}
    else:
        infl = {"sbuf": buf}
    return SwarmState(state.params, state.opt, None, state.step, infl)


def pipeline_epilogue(cfg: SwarmConfig, state: SwarmState) -> SwarmState:
    """Drain the pipeline: drop the in-flight payload (the model is already
    final) and unpack the packed comm copy back into `prev`, so a later
    `pipeline_prologue` re-primes with a live distance proxy. Returns a
    new state; `state` itself is left as it was."""
    prev = state.prev
    if state.inflight is not None and "prev" in state.inflight:
        layout = B.build_layout(state.params, block=cfg.make_codec().block)
        prev = B.unpack(layout, state.inflight["prev"])
    return SwarmState(state.params, state.opt, prev, state.step, None)


def codec_checkpoint_tree(state: SwarmState) -> dict:
    """What a quantized run persists to resume its codec state: params,
    the comm copy (a tree, or compress_state's wire tuple) and an
    error-feedback codec's residual (drain an overlapped state with
    `pipeline_epilogue` first). Feed to ``checkpoint.save_checkpoint``."""
    tree = {"params": state.params}
    if state.prev is not None:
        tree["prev"] = state.prev
    if state.residual is not None:
        tree["residual"] = state.residual
    return tree


def restore_codec_state(state: SwarmState, tree: dict) -> SwarmState:
    """Inverse of `codec_checkpoint_tree`: overlay the persisted codec
    state onto a freshly initialized SwarmState (same config)."""
    return SwarmState(tree["params"], state.opt,
                      tree.get("prev", state.prev), state.step,
                      state.inflight, tree.get("residual", state.residual))


def select_rows(m_rows, new, old):
    """Per wire row: `new` where m_rows, else `old` (bitwise; uint16
    codes through an int16 view)."""
    if new.dtype == torch.uint16:
        return select_rows(m_rows, new.view(torch.int16),
                           old.view(torch.int16)).view(torch.uint16)
    return torch.where(m_rows.reshape((-1,) + (1,) * (new.ndim - 1)), new,
                       old)


#: the transports a split node exchanges over; the pool's wait for
#: ROADMAP.md Queue A 15
MODEL_AXIS_IMPLS = ("gather", "ppermute", "gather_legacy", "ppermute_legacy")


def check_model_axis_run(*, algo: str = "swarm", gossip_impl: str = None,
                         quantize: bool = False, codec=None,
                         compress_state: bool = False,
                         rate_profile: str = None, avail: str = None,
                         topology: str = None, scan_chunk: int = 0) -> None:
    """Raise ValueError (ROADMAP.md Queue A 15) for a run the model axis
    does not carry yet: it carries the swarm's blocking, non-blocking and
    overlapped supersteps on the gather and ppermute transports and their
    per-leaf oracles (``*_legacy``; overlap refuses those itself,
    ``GossipTransport.check_overlap``), exact or with the q8 lattice —
    the grid the reference's dry run builds on its "model" axis. The
    run's validation (``algorithms/registry.py`` ``validate_run_config``)
    passes every flag; ``make_algorithm`` and :func:`make_swarm_step`,
    which a library caller may reach without it, pass what they see."""
    why = []
    if algo != "swarm":
        why.append(f"--algo {algo}")
    if (gossip_impl or "gather") not in MODEL_AXIS_IMPLS:
        why.append(f"--gossip-impl {gossip_impl}")
    if quantize:
        c = codec if codec is not None and not isinstance(codec, str) \
            else make_codec(codec)
        if c.name != "q8":
            why.append(f"--codec {c.name}")
    for flag, on in (("--compress-state", compress_state),
                     ("--scan-chunk", scan_chunk),
                     (f"--rate-profile {rate_profile}",
                      rate_profile not in (None, "none")),
                     (f"--avail {avail}", avail is not None),
                     (f"--topology {topology}", topology not in
                      (None, "", "flat", "none"))):
        if on:
            why.append(flag)
    if why:
        raise ValueError(f"{', '.join(why)}: "
                         f"{NOT_ON_THE_MODEL_AXIS['run']}")


def make_swarm_step(cfg: SwarmConfig, loss_fn: Callable, opt_update: Callable,
                    lr_fn: Callable,
                    transport: Optional[GossipTransport] = None, *,
                    mesh=None, param_specs=None):
    """Returns the superstep, an :class:`EngineStep`: step(state, batch,
    perm, h_counts, rng, mask=None, *, u=None, u_state=None) -> (state,
    metrics). batch leaves are [n_nodes, h_loop_bound, local_batch, ...]
    tensors on the device; perm is an involution [n_nodes] (under
    ppermute_pool the pool index broadcast to [n_nodes], resolved through
    ``GossipTransport.resolve_perm``); h_counts the
    per-node local-step counts; rng the torch.Generator of the encode's
    uniforms, or `u` the uniforms themselves ([n_nodes, n_padded]; under
    compress_state `u_state` those of the comm copy's re-encode); `mask`
    the optional participation gate (bool [n_nodes]). With cfg.overlap the
    step is the pipelined steady state and needs a primed state.

    On a node `mesh` (``launch/mesh.py``; cfg.n_nodes its size) the
    transport is built on that mesh (``GossipTransport(..., mesh=mesh)``;
    any impl). The state is the rank's node (``swarm_init(mesh=...)``; an
    error-feedback residual is its row [1, n_padded]) and `batch` its
    node's slice ([1, h_loop_bound, ...]); `perm`, `h_counts` and `mask`
    stay the global [n] vectors, `perm` on the host, and each rank reads
    its own entries: its matched flag is ``perm[rank] != rank`` (under
    ppermute_pool the pool entry's) gated by ``mask[rank]``; under
    ppermute the perm must agree with the static pairs. `u` is the rank's
    own uniforms ([1, n_padded]); drawn, they come from the rank's
    generator folded from `rng`. The loss comes from all-gathered
    per-node losses, matched_frac from the global perm and mask, and Γ
    from all-reduces, so every rank reports the global metrics.

    On a mesh with a model axis the state is the rank's slices of its
    node, `loss_fn` the model's share of the node (``TransformerLM(cfg,
    tp=mesh.model_shard).functional_loss``) and `param_specs` the
    parameters' split (``models/transformer.py`` ``param_split``), by
    which Γ counts a whole leaf once; what the model axis does not carry
    yet raises (:func:`check_model_axis_run`)."""
    tr = transport or GossipTransport(cfg.n_nodes, impl=cfg.gossip_impl,
                                      quant=cfg.quant,
                                      codec=cfg.make_codec(), mesh=mesh)
    if mesh is not None and tr.mesh is not mesh:
        raise ValueError("the transport is not built on the step's mesh "
                         "(GossipTransport(..., mesh=mesh))")
    mesh = tr.mesh
    if mesh is not None:
        B.check_mesh_nodes(cfg.n_nodes, mesh)
        if mesh.model_size > 1:
            check_model_axis_run(gossip_impl=tr.impl, quantize=cfg.quantize,
                                 codec=tr.codec,
                                 compress_state=cfg.compress_state)
            if param_specs is None:
                raise ValueError("a step on the model axis needs the "
                                 "parameters' split (param_specs=, "
                                 "models/transformer.py param_split)")
    ef = cfg.quantize and tr.codec.carries_residual
    cs = cfg.compress_state
    if cs and (tr.codec.carries_residual or not cfg.quantize
               or cfg.nonblocking or tr.legacy):
        raise ValueError("compress_state keeps the quantized blocking "
                         f"path's comm copy, lattice codecs only, on the "
                         f"flat transport (codec {tr.codec.name}, quantize="
                         f"{cfg.quantize}, nonblocking={cfg.nonblocking}, "
                         f"gossip_impl={tr.impl})")
    if cfg.overlap:
        tr.check_overlap(cfg.quantize)
    local_steps = make_local_steps(loss_fn, opt_update, cfg.h_loop_bound)

    def folded(rng, u):
        """The encode's generator: on a node mesh the rank's own, folded
        from `rng` (unless the uniforms are given)."""
        if mesh is None or u is not None or rng is None:
            return rng
        return mesh.fold_generator(rng)

    def average_momentum(opt, perm_x, node_perm, matched):
        if not cfg.average_momentum or not tree_leaves(opt):
            return opt
        if mesh is not None:
            partner = tr.partner_tree(opt, perm_x)
            return tree_map(lambda x, p: _avg(x, p, matched), opt, partner)
        return tree_map(lambda x: _avg(x, x[node_perm], matched), opt)

    def finish(state, params, opt, prev, inflight, residual, losses,
               matched, mask, lr):
        if mesh is not None:
            losses = global_scalars(mesh, losses)
        metrics = {"loss": masked_mean_loss(losses, mask), "lr": lr,
                   "matched_frac": torch.mean(matched.to(torch.float32))}
        if cfg.track_potential:
            with record_function("swarm.gamma"):
                metrics["gamma"] = gamma_potential(params, mesh=mesh,
                                                   split=param_specs)
        return SwarmState(params, opt, prev, state.step + 1,
                          inflight, residual), metrics

    def superstep(state: SwarmState, batch, inp, rng, *, u=None,
                  u_state=None):
        lr = inp.lr
        S = state.params                      # superstep-start models
        params, opt, losses = local_steps(S, state.opt, batch,
                                          rank_inputs(inp, mesh, cfg.n_nodes))
        perm_t, node_perm, matched_all, matched = matching(tr, inp,
                                                           cfg.n_nodes)
        mask = inp.mask
        layout = B.build_layout(S, block=tr.codec.block)
        prev_buf = None
        if cs:
            # the compressed comm copy, decoded to the packed buffer the
            # encode measures its distance against
            with record_function("swarm.prev"):
                prev_buf = tr.codec.decode_state(
                    state.prev, (layout.n_nodes, layout.n_padded))
        new_residual = state.residual

        def mix(tree):
            nonlocal new_residual
            out = tr.mix_pair(tree, perm_t, matched, quantize=cfg.quantize,
                              prev=None if cs else state.prev,
                              prev_buf=prev_buf, rng=rng, u=u, mask=mask,
                              residual=state.residual)
            if ef:
                out, new_residual = out
            return out

        with record_function("swarm.gossip"):
            if cfg.nonblocking:
                # Algorithm 2: X_i <- (S_i + X_j')/2 + (X_i - S_i), the
                # partner's contribution its superstep-start model. The
                # averaged base is in the leaf dtype before the fp32 delta
                # is added, as the reference's tree-level combine does
                base = mix(S)
                params = stale_combine(base, params, S, matched)
                del base
            else:
                # Algorithm 1: average the post-local-step models
                params = mix(params)
        del prev_buf
        opt = average_momentum(opt, perm_t, node_perm, matched)
        new_prev = None
        if cs:
            # compressed refresh: re-encode the post-interaction model
            # against zeros once, then take the matched nodes' wire rows;
            # unmatched nodes keep their old bytes (no re-quantization)
            with record_function("swarm.prev"):
                enc = tr.codec.encode_state(B.pack(layout, params),
                                            folded(rng, u_state), u=u_state)
                m_rows = B.row_mask(matched, layout.rows_per_node)
                new_prev = tuple(select_rows(m_rows, e, o)
                                 for e, o in zip(enc, state.prev))
                del enc
        elif state.prev is not None:
            # refresh the comm copy on interaction. Blocking: to the
            # post-interaction model (the next encode input is h local
            # steps away from it, so the distance proxy |x - prev| stays
            # live). Non-blocking: to S, the value exchanged — the next
            # encode input IS the post-interaction model, so refreshing to
            # it would collapse the proxy for matched nodes and wrap every
            # decode
            src = S if cfg.nonblocking else params
            with record_function("swarm.prev"):
                new_prev = select(matched, src, state.prev)
        return finish(state, params, opt, new_prev, None, new_residual,
                      losses, matched_all, mask, lr)

    def pipelined_superstep(state: SwarmState, batch, inp, rng, *, u=None):
        """The steady state of the overlapped pipeline: the in-flight
        payload's permute is dispatched first (a side stream on the card),
        the local steps run under it, the decode + average lands against
        the stale packed S, and the next payload is encoded from the
        post-interaction model on the way out."""
        infl = state.inflight
        if infl is None:
            raise ValueError("the overlapped superstep needs a primed "
                             "pipeline (pipeline_prologue)")
        lr = inp.lr
        codec = tr.codec
        layout = B.build_layout(state.params, block=codec.block)
        perm_t, node_perm, matched_all, matched = matching(tr, inp,
                                                           cfg.n_nodes)
        mask = inp.mask

        # 1. the in-flight payload's permute, before any local compute
        payload = infl["wire"] if cfg.quantize else (infl["sbuf"],)
        with record_function("gossip.permute"):
            recv, ready = tr.permute_inflight(payload, perm_t)

        # 2. local steps, overlapping the permute
        params, opt, losses = local_steps(state.params, state.opt, batch,
                                          rank_inputs(inp, mesh, cfg.n_nodes))

        # 3. land: decode + average against the STALE packed model S
        sbuf = infl["sbuf"]
        with record_function("swarm.gossip"):
            land(ready)
            if cfg.quantize:
                m_rows = B.row_mask(matched, layout.rows_per_node)
                if mesh is None:
                    # the wrap counter reads the sender's row, which a
                    # rank of a node mesh does not hold
                    B.count_wraps(codec, recv, sbuf, node_perm, matched)
                with record_function("gossip.decode"):
                    base_buf = codec.decode_avg(recv, sbuf, m_rows)
            else:
                base_buf = (sbuf + recv[0]) * 0.5
            del recv
            # X_i <- (S_i + X_j')/2 + (X_i - S_i) in fp32 buffer space
            # (d + base is base + d bitwise: addition commutes)
            with record_function("gossip.pack"):
                post_buf = B.pack(layout, params)
            m_col = matched[:, None]
            new_buf = torch.where(
                m_col, (post_buf - sbuf).add_(base_buf), post_buf)
            del post_buf, base_buf
            with record_function("gossip.unpack"):
                params = B.unpack(layout, new_buf)
        opt = average_momentum(opt, perm_t, node_perm, matched)

        # 4. refresh the packed comm copy to the value SENT (S, in sbuf)
        # and encode the next payload
        if cfg.quantize:
            with record_function("swarm.prev"):
                prev_buf = torch.where(m_col, sbuf, infl["prev"])
            with record_function("gossip.encode"):
                wire = codec.encode(new_buf, prev_buf, folded(rng, u), u=u)
            new_infl = {"sbuf": new_buf, "prev": prev_buf, "wire": wire}
        else:
            new_infl = {"sbuf": new_buf}
        return finish(state, params, opt, None, new_infl, None, losses,
                      matched_all, mask, lr)

    return EngineStep(pipelined_superstep if cfg.overlap else superstep,
                      lr_fn, h_max=cfg.h_loop_bound, mesh=mesh,
                      peers_fn=None if mesh is None else tr.mesh_route)


_WIRE_PREV = ("join bootstrap re-bases the per-leaf comm copy; the "
              "wire-tuple prev of compress_state is rejected at config "
              "time (registry)")


def make_join_step(cfg: SwarmConfig, *, mesh=None):
    """Join bootstrap of elastic membership: returns `join_step(state,
    perm, join_mask) -> state`.

    The scheduler emits an exclusive join bin (``sched/bridge.py``) whose
    `perm` swaps (joiner, donor) and whose `join_mask` marks the joiner.
    The bootstrap packs the node-stacked parameters once, gathers the rows
    once (``buf[perm]``, so the joiner's row holds the donor's payload),
    selects the received rows at joiners only and unpacks; every other
    node round-trips bitwise (pack/unpack is exact). The joiner's comm
    copy `prev` is re-based to its new model and its error-feedback
    residual (when one exists) is zeroed; its momentum stays as
    initialized (the paper averages models only). It takes no batch and
    no generator, and launches neither codec kernel: a join bin is not a
    gossip superstep. Refused in the overlap pipeline (an in-flight
    payload packed before the join would predate the joiner).

    On a node `mesh` (cfg.n_nodes its size) the state is the rank's node,
    and `perm` and `join_mask` the global host vectors: the donor's packed
    parameters go to the joiner as ONE message (``bucket.post_gather``
    restricted to the joiners), and only the joiner lands them."""
    assert not cfg.overlap, \
        "join bootstrap needs the non-pipelined driver (overlap=False): " \
        "an in-flight payload packed before the join would go stale"
    if mesh is not None:
        B.check_mesh_nodes(cfg.n_nodes, mesh)
    block = cfg.make_codec().block

    def join_step(state: SwarmState, perm, join_mask) -> SwarmState:
        assert not isinstance(state.prev, tuple), _WIRE_PREV
        with record_function("swarm.join"):
            layout = B.build_layout(state.params, block=block)
            buf = B.pack(layout, state.params)
            device = buf.device
            if mesh is None:
                perm_t = torch.as_tensor(np.asarray(perm), dtype=torch.int64,
                                         device=device)
                jm = as_mask(join_mask, device)
                recv = buf[perm_t]             # the one payload gather
            else:
                jm_h = np.asarray(join_mask.cpu() if isinstance(
                    join_mask, torch.Tensor) else join_mask, bool)
                recv, = B.post_gather((buf,), mesh, np.asarray(perm),
                                      land=jm_h).wait()
                jm = own_rows(torch.as_tensor(jm_h, device=device), mesh)
            new_buf = torch.where(jm[:, None], recv, buf)
            del buf, recv
            params = B.unpack(layout, new_buf)
            del new_buf
            prev = state.prev
            if prev is not None:
                prev = select(jm, params, prev)
            residual = state.residual
            if residual is not None:
                residual = torch.where(jm[:, None], 0.0, residual)
        return SwarmState(params, state.opt, prev, state.step + 1,
                          state.inflight, residual)

    return join_step


def retire_nodes(state: SwarmState, left_mask, *, mesh=None) -> SwarmState:
    """Permanent-leave retirement. A left node's lane stays allocated but
    the scheduler never matches it again (its mask rows are False from
    then on), so its parameters, momentum and comm copy freeze in place;
    what is retired here is its error-feedback residual, zeroed so that
    the post-leave state does not depend on when it was saved; a state
    without a residual comes back as it was. On a node `mesh` the state
    is the rank's node and the rank reads its entry of the global
    `left_mask`."""
    if state.residual is None:
        return state
    lm = own_rows(as_mask(left_mask, state.residual.device), mesh)
    residual = torch.where(lm[:, None], 0.0, state.residual)
    return SwarmState(state.params, state.opt, state.prev, state.step,
                      state.inflight, residual)


def make_mean_model_eval(loss_fn: Callable, mesh=None):
    """The swarm's true average model μ against the per-node models (the
    paper's §5 check). μ comes from ``checkpoint.mean_model_tree``, the
    one mean-model path. -> evaluate(params_stacked, batch_single) ->
    {loss_mean_model, loss_node_mean, loss_node_worst} (0-d tensors).

    On a node `mesh` (the rank's [1, ...] params, every rank the same
    batch) μ is the whole swarm's (``mean_model_tree(mesh=)``) and the
    node losses are every rank's, all-gathered
    (``exchange.global_scalars``), so every rank reports the global
    three."""
    from repro_torch.checkpoint import mean_model_tree
    node_losses = torch.func.vmap(loss_fn, in_dims=(0, None))

    @torch.no_grad()
    def evaluate(params_stacked, batch_single):
        mu = mean_model_tree(params_stacked, mesh=mesh)
        loss_mu = loss_fn(mu, batch_single)
        del mu
        losses = node_losses(params_stacked, batch_single)
        if mesh is not None:
            losses = global_scalars(mesh, losses)
        return {"loss_mean_model": loss_mu,
                "loss_node_mean": torch.mean(losses),
                "loss_node_worst": torch.max(losses)}
    return evaluate


def sample_h_counts(cfg: SwarmConfig, rng: np.random.Generator) -> np.ndarray:
    """Host-side per-node local-step counts for this superstep: fixed H
    (draws nothing from `rng`), or Geom(1/H) clipped to [1, h_max]. The
    trace mode's counts come from the scheduler bridge instead."""
    if cfg.h_mode == "fixed":
        return np.full((cfg.n_nodes,), cfg.H, np.int32)
    if cfg.h_mode == "geometric":
        h = rng.geometric(1.0 / cfg.H, size=cfg.n_nodes)
        return np.clip(h, 1, cfg.h_max).astype(np.int32)
    raise ValueError(
        f"h_mode={cfg.h_mode!r}: per-node counts come from the scheduler "
        "bridge (sched/bridge.py engine_inputs), not from sampling")
