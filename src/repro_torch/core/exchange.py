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

Only the gather transport is ported: every node lives in one process on one
device. The JAX package's ppermute transports and per-leaf ``*_legacy``
oracles wait for the NCCL transport item of ROADMAP.md.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.core import bucket as B
from repro_torch.quant.codecs import LatticeCodec, WireCodec, make_codec
from repro_torch.quant.schemes import ModularQuantConfig
from repro_torch.tree import tree_flatten, tree_map

BASE_IMPLS = ("gather",)
NOT_PORTED_IMPL = ("is not ported: only the gather transport runs in the "
                   "port; the ppermute transports and the *_legacy per-leaf "
                   "oracles wait for the multi-GPU (NCCL) transport item of "
                   "ROADMAP.md")


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
    the per-step driver builds a fresh one each superstep."""

    def __init__(self, lr, perm, h, mask, h_host):
        self.lr, self.perm, self.h, self.mask = lr, perm, h, mask
        self.h_host = h_host

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
        return cls(lr_t, perm_t, h_t, as_mask(mask, device), h_host)

    @classmethod
    def static(cls, n_nodes: int, device, masked: bool):
        """Zero-filled buffers a CUDA graph is captured against."""
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
    fresh StepInputs first. `graph_key(state, h_host)` names the host
    values `run`'s control flow depends on (the local-step signature for
    the steps that take h, anything algorithm-specific from `key_fn`):
    one captured graph serves every superstep with the same key."""

    def __init__(self, run, lr_fn, *, h_max: Optional[int] = None,
                 key_fn=None):
        self.run = run
        self.lr_fn = lr_fn
        self.h_max = h_max          # None: the step ignores h
        self.key_fn = key_fn

    def graph_key(self, state, h_host) -> tuple:
        key = () if self.h_max is None else \
            local_signature(h_host, self.h_max)
        if self.key_fn is not None:
            key += (self.key_fn(state),)
        return key

    def __call__(self, state, batch, perm, h_counts, rng, mask=None, **kw):
        device = tree_flatten(state.params)[0][0].device
        inp = StepInputs.from_host(self.lr_fn(state.step), perm, h_counts,
                                   mask, device)
        return self.run(state, batch, inp, rng, **kw)


def make_local_steps(loss_fn, opt_update, h_max: int):
    """Returns local_steps(params, opt, batch, inp) -> (params, opt,
    per-node mean loss over the h_i active steps).

    params/opt are node-stacked; batch leaves are [n_nodes, h_max, ...];
    `inp` is the superstep's :class:`StepInputs`: its host counts h_host
    decide which sweeps run, the device counts h give each sweep's active
    mask and lr the rate, so the loop does no host to device copy. Step q computes every node's loss and gradient in one
    ``torch.func.vmap`` over the node axis (the reference vmaps the same
    way), then ONE optimizer sweep updates every node; nodes past their
    h_i (``q >= h_i``, the reference's masked loop) keep their parameters
    and momentum."""
    node_grads = torch.func.vmap(torch.func.grad_and_value(loss_fn))

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
    (``GossipTransport.permute_inflight``'s `ready`; None on the CPU)."""
    if ready is not None:
        torch.cuda.current_stream().wait_event(ready)


def masked_mean_loss(losses, mask):
    """Loss over participants; the plain mean for mask=None."""
    if mask is None:
        return torch.mean(losses)
    m = mask.to(torch.float32)
    return torch.sum(torch.where(mask, losses, 0.0)) / \
        torch.clamp_min(torch.sum(m), 1.0)


class GossipTransport:
    """Every exchange over the flat buffer, gather transport (all nodes in
    one process on one device). `impl` names the transport as the JAX
    package's ``gossip_impl`` does; only ``"gather"`` is ported and any
    other raises. The codec owns the quantized wire format; `quant` seeds
    the lattice family when no codec is given."""

    def __init__(self, n_nodes: int, *, impl: str = "gather",
                 quant: Optional[ModularQuantConfig] = None,
                 codec: Optional[WireCodec] = None):
        if impl not in BASE_IMPLS:
            raise ValueError(f"gossip impl {impl!r} {NOT_PORTED_IMPL}")
        self.impl = impl
        self.base_impl = impl
        self.n_nodes = n_nodes
        self.codec = codec if codec is not None \
            else LatticeCodec(quant or ModularQuantConfig())
        self._side_streams = {}     # CUDA device -> permute_inflight stream

    def check_overlap(self, quantize: bool):
        """The pipelined superstep encodes before it learns the next
        matching, so a codec whose residual updates against the matched
        mask at encode time cannot ride it."""
        if quantize and self.codec.carries_residual:
            raise ValueError(
                f"codec {self.codec.name}: the error-feedback residual "
                "updates at encode time against the matched mask, which the "
                "pipelined superstep only learns one interaction later")

    def resolve_perm(self, perm) -> Tuple[torch.Tensor, None]:
        """The node -> partner permutation of the engine input `perm`, and
        the pool index (None: the gather transport takes the perm itself)."""
        return perm, None

    def permute_inflight(self, payload: Sequence[torch.Tensor], perm):
        """The wire half of the overlapped pipeline: ONE ``permute_rows``
        per already-encoded payload tensor -> (received tuple, ready). On
        the card the gathers run on a side stream, so they overlap the
        local steps the caller launches next on the current stream; the
        caller makes the current stream wait on `ready` (:func:`land`)
        before it reads the received tensors. On the CPU, ready is None."""
        node_perm, _ = self.resolve_perm(perm)
        if node_perm.device.type != "cuda":
            return tuple(B.permute_rows(x, node_perm, self.n_nodes)
                         for x in payload), None
        dev = node_perm.device
        current = torch.cuda.current_stream(dev)
        side = self._side_streams.get(dev)
        if side is None:
            side = self._side_streams[dev] = torch.cuda.Stream(device=dev)
        # the wire (and the perm) were produced on the current stream
        side.wait_stream(current)
        with torch.cuda.stream(side):
            recv = tuple(B.permute_rows(x, node_perm, self.n_nodes)
                         for x in payload)
            ready = torch.cuda.Event()
            ready.record(side)
        # the allocator may hand the inputs' memory on only after the side
        # stream's reads, and the outputs' only after the current stream's
        for x in payload:
            x.record_stream(side)
        node_perm.record_stream(side)
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

        With an error-feedback codec (``codec.carries_residual``) a
        quantized call takes and returns the buffer-shaped residual: ->
        (mixed tree, new residual); every other call returns the tree."""
        ef = quantize and self.codec.carries_residual
        layout = B.build_layout(tree, block=self.codec.block)
        with record_function("gossip.pack"):
            buf = B.pack(layout, tree)
            pbuf = None
            if quantize:
                pbuf = prev_buf if prev_buf is not None else \
                    B.pack(layout, prev)
        new_residual = None
        if quantize:
            out, new_residual = B.gossip_flat_coded(
                self.codec, buf, pbuf, perm, matched, rng,
                residual=residual, u=u)
        else:
            out = B.gossip_flat_exact(buf, perm,
                                      matched if mask is not None else None)
        del buf, pbuf
        with record_function("gossip.unpack"):
            mixed = B.unpack(layout, out)
        return (mixed, new_residual) if ef else mixed

    def global_mean(self, tree, mask=None):
        """(Masked) mean over the node axis, broadcast back to every node —
        LocalSGD's resync and AllReduce's gradient mean. With `mask` the
        mean runs over the participants only and is still broadcast
        everywhere."""
        layout = B.build_layout(tree, block=self.codec.block)
        with record_function("gossip.pack"):
            buf = B.pack(layout, tree)
        with record_function("gossip.mean"):
            out = B.gossip_flat_mean(buf, mask)
        del buf
        with record_function("gossip.unpack"):
            return B.unpack(layout, out)

    def matrix_mix(self, tree, W):
        """Dense mixing X <- W X (D-PSGD): one [n, n] x [n, n_padded] fp32
        product over the packed buffer."""
        layout = B.build_layout(tree, block=self.codec.block)
        with record_function("gossip.pack"):
            buf = B.pack(layout, tree)
        with record_function("gossip.matrix"):
            out = B.gossip_flat_matrix(W, buf)
        del buf
        with record_function("gossip.unpack"):
            return B.unpack(layout, out)

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


def transport_from_config(scfg, impl: str = "gather") -> GossipTransport:
    """The driver's one transport for every algorithm: `impl` (anything
    but ``"gather"`` raises) on the codec of `scfg.codec`, the lattice
    family seeded by `scfg.quant`."""
    quant = getattr(scfg, "quant", None)
    return GossipTransport(scfg.n_nodes, impl=impl, quant=quant,
                           codec=make_codec(getattr(scfg, "codec", None),
                                            quant))
