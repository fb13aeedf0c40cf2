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
from repro_torch.quant.codecs import LatticeCodec, WireCodec
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


def lr_on(lr_fn, step: int, params) -> torch.Tensor:
    """The step's learning rate as a 0-d fp32 tensor on the parameters'
    device (the optimizer sweep reads it through a device pointer)."""
    return torch.tensor(lr_fn(step), dtype=torch.float32,
                        device=tree_flatten(params)[0][0].device)


def make_local_steps(loss_fn, opt_update, h_max: int):
    """Returns local_steps(params, opt, batch, h_counts, lr) -> (params,
    opt, per-node mean loss over the h_i active steps).

    params/opt are node-stacked; batch leaves are [n_nodes, h_max, ...];
    h_counts is a host-side int array. Step q computes every node's loss
    and gradient in one ``torch.func.vmap`` over the node axis (the
    reference vmaps the same way), then ONE optimizer sweep updates every
    node; nodes past their h_i (``q >= h_i``, the reference's masked loop)
    keep their parameters and momentum."""
    node_grads = torch.func.vmap(torch.func.grad_and_value(loss_fn))

    def local_steps(params, opt, batch, h_counts, lr):
        h = [int(x) for x in h_counts]
        n = len(h)
        device = tree_flatten(params)[0][0].device
        hc = torch.tensor(h, dtype=torch.float32, device=device)
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
            if all(q < hi for hi in h):
                params, opt = p2, o2
            else:
                params, opt = select(active, p2, params), select(active, o2,
                                                                 opt)
            # a partial step's unselected update must not live on through
            # the next step's optimizer sweep (a full model + momentum)
            del p2, o2
        return params, opt, lsum / torch.clamp_min(hc, 1.0)
    return local_steps


def as_mask(mask, device) -> Optional[torch.Tensor]:
    """A participation mask (bool [n_nodes], host array or tensor) as a
    bool tensor on `device`; None stays None."""
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
                 prev=None, rng=None, u=None, mask=None):
        """Average each node's `tree` entry with the entry of node perm[i]
        (a matching's involution, fixed points unmatched, or SGP's directed
        shift); `matched` is the landing mask, already gated by the
        participation `mask`. As in the reference, the exact gather applies
        `matched` only when a `mask` is given (an involution's fixed points
        average with themselves unchanged). Quantized, each node encodes
        against its comm copy `prev` (the sender-local distance proxy) with
        uniforms `u` (drawn from `rng` unless given), and the receiver
        decodes against its own model; unmatched rows keep their model."""
        layout = B.build_layout(tree, block=self.codec.block)
        with record_function("gossip.pack"):
            buf = B.pack(layout, tree)
            pbuf = B.pack(layout, prev) if quantize else None
        if quantize:
            out = B.gossip_flat_coded(self.codec, buf, pbuf, perm, matched,
                                      rng, u=u)
        else:
            out = B.gossip_flat_exact(buf, perm,
                                      matched if mask is not None else None)
        del buf, pbuf
        with record_function("gossip.unpack"):
            return B.unpack(layout, out)

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


def transport_from_config(scfg, impl: str = "gather") -> GossipTransport:
    """The driver's one transport for every algorithm: `impl` on the
    lattice codec of `scfg.quant` (any impl but ``"gather"`` raises)."""
    return GossipTransport(scfg.n_nodes, impl=impl, quant=scfg.quant)
