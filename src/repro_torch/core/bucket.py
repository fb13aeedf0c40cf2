"""Bucketed flat-buffer gossip transport (counterpart of
``repro/core/bucket.py``).

The node-stacked parameter tree packs into ONE padded ``[n_nodes,
n_padded]`` fp32 buffer, so a gossip exchange is one gather over one tensor
and the quantized path is one ``quantize_mod`` sweep plus one fused
``decode_avg`` sweep (``kernels/ops.py``). The wire layout is the JAX
package's, bit for bit:

* leaves are flattened per node and concatenated in JAX's flatten order
  (dict keys sorted at every level, ``tree.py``);
* each leaf segment is zero-padded to a multiple of ``block`` (one quant
  scale block never straddles two tensors);
* the per-node width is padded to ``block * tile_rows``, so
  ``rows_per_node = n_padded // block`` rows map onto the kernel layout with
  no re-padding.

Three transports move the payload between nodes, as in the reference:
``gather`` (a permutation gather by the engine's matching), ``ppermute``
(one static matching, fixed when the transport is built) and
``ppermute_pool`` (a matching drawn each superstep from K precompiled ones,
by an index). With every node in one process on one device — one shard —
the ppermute transports are a local permute by the static pairs or by the
pool entry, as the reference's one-shard branch is; a mesh of more than
one shard (one rank a GPU) waits for the multi-GPU item of ROADMAP.md and
raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.quant.codecs import LatticeCodec, WireCodec
from repro_torch.quant.schemes import ModularQuantConfig, payload_bytes
from repro_torch.tree import tree_flatten, tree_unflatten

DEFAULT_BLOCK = 256      # coords per quant scale block
DEFAULT_TILE_ROWS = 8    # rows_per_node is a multiple of this


def as_codec(quant_or_codec) -> Optional[WireCodec]:
    """A WireCodec passes through, a ModularQuantConfig wraps into the
    lattice codec, None stays None (exact fp32)."""
    if quant_or_codec is None or isinstance(quant_or_codec, WireCodec):
        return quant_or_codec
    assert isinstance(quant_or_codec, ModularQuantConfig), quant_or_codec
    return LatticeCodec(quant_or_codec)


@dataclass(frozen=True)
class BucketLayout:
    """Precomputed flatten plan for one (node-stacked) tree structure."""
    treedef: Any
    n_nodes: int
    shapes: Tuple[Tuple[int, ...], ...]   # per-leaf shape, node dim stripped
    dtypes: Tuple[Any, ...]
    offsets: Tuple[int, ...]              # leaf start col in the buffer
    sizes: Tuple[int, ...]                # true coords per leaf per node
    seg_sizes: Tuple[int, ...]            # block-aligned segment widths
    n_coords: int                         # sum(sizes)
    n_padded: int                         # buffer width incl. all padding
    block: int
    tile_rows: int

    @property
    def rows_per_node(self) -> int:
        return self.n_padded // self.block

    def payload_num_bytes(self, quant=None) -> int:
        """Exact wire bytes PER NODE for one gossip send of this buffer:
        fp32 when `quant` is None, else the codec's declared layout."""
        if quant is None:
            return 4 * self.n_padded
        codec = as_codec(quant)
        assert codec.block == self.block, (codec.block, self.block)
        n = codec.payload_num_bytes(self.n_padded)
        if isinstance(quant, ModularQuantConfig) and not codec.packed:
            assert n == payload_bytes(quant, self.n_padded), (n, quant)
        return n


_LAYOUT_CACHE: dict = {}


def _make_layout(treedef, n_nodes, shapes, dtypes, block, tile_rows):
    key = (treedef, n_nodes, shapes, dtypes, block, tile_rows)
    hit = _LAYOUT_CACHE.get(key)
    if hit is not None:
        return hit
    offsets, sizes, seg_sizes = [], [], []
    off = 0
    for shp in shapes:
        size = 1
        for d in shp:
            size *= int(d)
        seg = -(-size // block) * block
        offsets.append(off)
        sizes.append(size)
        seg_sizes.append(seg)
        off += seg
    total_align = block * tile_rows
    n_padded = -(-off // total_align) * total_align
    layout = BucketLayout(treedef, n_nodes, shapes, dtypes, tuple(offsets),
                          tuple(sizes), tuple(seg_sizes), sum(sizes),
                          n_padded, block, tile_rows)
    _LAYOUT_CACHE[key] = layout
    return layout


def build_layout(tree, *, block: int = DEFAULT_BLOCK,
                 tile_rows: int = DEFAULT_TILE_ROWS) -> BucketLayout:
    """Flatten plan for a node-stacked tree (leading dim = nodes)."""
    leaves, treedef = tree_flatten(tree)
    assert leaves, "cannot build a bucket layout for an empty tree"
    return _make_layout(treedef, leaves[0].shape[0],
                        tuple(tuple(x.shape[1:]) for x in leaves),
                        tuple(x.dtype for x in leaves), block, tile_rows)


def build_flat_layout(tree, *, block: int = DEFAULT_BLOCK,
                      tile_rows: int = DEFAULT_TILE_ROWS) -> BucketLayout:
    """Flatten plan for an un-stacked tree (leaves keep their full shape);
    n_nodes == 1, use `pack_flat` / `unpack_flat`."""
    leaves, treedef = tree_flatten(tree)
    assert leaves, "cannot build a flat layout for an empty tree"
    return _make_layout(treedef, 1, tuple(tuple(x.shape) for x in leaves),
                        tuple(x.dtype for x in leaves), block, tile_rows)


def pack_flat(layout: BucketLayout, tree) -> torch.Tensor:
    """Un-stacked tree -> [n_padded] fp32 vector."""
    leaves, _ = tree_flatten(tree)
    buf = torch.zeros((layout.n_padded,), dtype=torch.float32,
                      device=leaves[0].device)
    for x, off, size in zip(leaves, layout.offsets, layout.sizes):
        buf[off:off + size] = x.reshape(size)
    return buf


def unpack_flat(layout: BucketLayout, buf: torch.Tensor):
    """[n_padded] fp32 vector -> un-stacked tree (original dtypes; every
    leaf is a fresh tensor, never a view of `buf`)."""
    outs = [buf[off:off + size].to(dtype=dt, copy=True).reshape(shp)
            for off, size, shp, dt in zip(layout.offsets, layout.sizes,
                                          layout.shapes, layout.dtypes)]
    return tree_unflatten(layout.treedef, outs)


def pack(layout: BucketLayout, tree) -> torch.Tensor:
    """Node-stacked tree -> [n_nodes, n_padded] fp32 flat buffer."""
    leaves, _ = tree_flatten(tree)
    buf = torch.zeros((layout.n_nodes, layout.n_padded), dtype=torch.float32,
                      device=leaves[0].device)
    for x, off, size in zip(leaves, layout.offsets, layout.sizes):
        buf[:, off:off + size] = x.reshape(layout.n_nodes, size)
    return buf


def unpack(layout: BucketLayout, buf: torch.Tensor):
    """[n_nodes, n_padded] flat buffer -> node-stacked tree (original
    dtypes; fresh tensors)."""
    outs = [buf[:, off:off + size].to(dtype=dt, copy=True)
            .reshape((layout.n_nodes,) + shp)
            for off, size, shp, dt in zip(layout.offsets, layout.sizes,
                                          layout.shapes, layout.dtypes)]
    return tree_unflatten(layout.treedef, outs)


def permute_rows(x: torch.Tensor, perm: torch.Tensor, n_nodes: int):
    """Gather-permute node-grouped rows: node i receives node perm[i]'s
    group; x is [n_nodes, ...] or [n_nodes * r, ...] with node-contiguous
    row groups. `perm` is any index map — a matching's involution or
    SGP's cyclic shift alike. uint16 codes move through an int16 view
    (same bits; no uint16 gather is needed)."""
    if x.dtype == torch.uint16:
        return permute_rows(x.view(torch.int16), perm,
                            n_nodes).view(torch.uint16)
    if x.shape[0] == n_nodes:
        return x[perm]
    r = x.shape[0] // n_nodes
    return x.reshape((n_nodes, r) + tuple(x.shape[1:]))[perm].reshape(x.shape)


def gossip_flat_exact(buf, perm, matched=None):
    """(buf + buf[perm]) / 2 — one gather over one tensor. For a matching
    `perm` is an involution with fixed points at unmatched nodes, and
    (x + x) * 0.5 == x for every finite float, so no mask is needed unless
    `matched` gates a partial landing (SGP's directed shift gates through
    `matched` the same way)."""
    avg = (buf + buf[perm]) * 0.5
    if matched is None:
        return avg
    return torch.where(matched[:, None], avg, buf)


def row_mask(matched: torch.Tensor, rows_per_node: int) -> torch.Tensor:
    """Per-node mask [n] -> per-row mask [n * rows_per_node] (each node's
    rows are contiguous). An expand, not ``repeat_interleave``, which
    copies its count to the device and so cannot run inside a CUDA graph
    capture."""
    return matched[:, None].expand(matched.shape[0], rows_per_node) \
        .reshape(-1)


#: Rows decoded beyond the lattice's reach, counted while this is a dict
#: (``WRAPS = {}``; None, the default, counts nothing and costs nothing).
#: A lattice decode is right only while sender and receiver differ by
#: less than 2^(bits-1) of the sender's steps in every coordinate of the
#: row; "rows" counts the matched rows at or past that distance and
#: "checked" the matched rows looked at (0-d device tensors, read once at
#: the end). It only reports: nothing changes what lands.
WRAPS: Optional[dict] = None


def count_wraps(codec, wire_p, sender_buf, perm, matched) -> None:
    """Add one exchange to `WRAPS`: node i decoded node perm[i]'s encode
    of `sender_buf[perm[i]]` (the scales `wire_p[1]`, already permuted)
    against its own row of `sender_buf`, where `matched`. One node at a
    time, so the check holds one node's rows beside the buffer."""
    if WRAPS is None or not isinstance(codec, LatticeCodec):
        return
    n = sender_buf.shape[0]
    half = 1 << (codec.quant.bits - 1)
    scales = wire_p[1].reshape(n, -1)
    rows = torch.zeros((), dtype=torch.int64, device=sender_buf.device)
    for i in range(n):
        x = sender_buf.index_select(0, perm[i:i + 1]).reshape(-1,
                                                              codec.block)
        y = sender_buf[i].reshape(-1, codec.block)
        d = torch.amax(torch.abs(x - y), dim=1)
        rows = rows + torch.sum((d >= half * scales[i]) & matched[i])
        del x, d
    WRAPS["rows"] = WRAPS.get("rows", 0) + rows
    WRAPS["checked"] = WRAPS.get("checked", 0) + \
        torch.sum(matched.to(torch.int64)) * scales.shape[1]


def gossip_flat_coded(codec: WireCodec, buf, prev_buf, perm, matched, rng,
                      *, residual=None, u=None,
                      tile_rows: int = DEFAULT_TILE_ROWS):
    """Encode once (one quantize_mod sweep for the lattice), permute every
    wire tensor, decode + average + matched mask in one fused decode_avg
    sweep. Returns (mixed, new_residual); new_residual is None unless the
    codec carries an error-feedback residual, whose update is gated by
    `matched` (an unconsumed payload leaves it to re-enter the next
    encode)."""
    n_nodes, n_padded = buf.shape
    rpn = n_padded // codec.block
    new_residual = None
    with record_function("gossip.encode"):
        if codec.carries_residual:
            wire, res_after = codec.encode_ef(buf, prev_buf, rng, residual,
                                              u=u, tile_rows=tile_rows)
            keep = residual if residual is not None \
                else torch.zeros_like(buf)
            # in place: res_after is the encode's own fresh buffer
            new_residual = torch.where(matched[:, None], res_after, keep,
                                       out=res_after)
            del keep
        else:
            wire = codec.encode(buf, prev_buf, rng, u=u, tile_rows=tile_rows)
    with record_function("gossip.permute"):
        wire_p = tuple(permute_rows(w, perm, n_nodes) for w in wire)
        m_rows = row_mask(matched, rpn)
    del wire
    count_wraps(codec, wire_p, buf, perm, matched)
    with record_function("gossip.decode"):
        out = codec.decode_avg(wire_p, buf, m_rows, tile_rows=tile_rows)
    return out, new_residual


def gossip_flat_mean(buf, mask=None):
    """(Masked) mean over the node axis, broadcast back to every node —
    the flat form of LocalSGD's resync and AllReduce's gradient mean. With
    `mask` the mean runs over the participants only, sum(w * buf) /
    max(sum(w), 1), and is still broadcast everywhere. The result is a
    broadcast view of one row; `unpack` copies it out."""
    if mask is None:
        mu = torch.mean(buf, dim=0, keepdim=True)
    else:
        w = mask.to(torch.float32)
        mu = torch.sum(w[:, None] * buf, dim=0, keepdim=True) / \
            torch.clamp_min(torch.sum(w), 1.0)
    return mu.expand(buf.shape)


def gossip_flat_matrix(W, buf):
    """Dense mixing X <- W X over the packed buffer: ONE [n, n] x
    [n, n_padded] fp32 product for the whole model (D-PSGD's Metropolis
    mixing). The caller keeps TF32 off on the card
    (``torch.backends.cuda.matmul.allow_tf32 = False``)."""
    return torch.matmul(W.to(torch.float32), buf)


def encode_flat(qcfg: ModularQuantConfig, buf, prev_buf, rng, *, u=None,
                tile_rows: int = DEFAULT_TILE_ROWS):
    """Encode the whole flat buffer: ONE quantize_mod sweep -> (q, s), the
    lattice codec's wire (uniforms `u`, or drawn from `rng`)."""
    return as_codec(qcfg).encode(buf, prev_buf, rng, u=u,
                                 tile_rows=tile_rows)


def gossip_flat_quantized(qcfg, buf, prev_buf, perm, matched, rng, *,
                          u=None, tile_rows: int = DEFAULT_TILE_ROWS):
    """Quantized flat gossip over the lattice of `qcfg`: encode once,
    permute the (q, s) pair, decode + average + mask in one fused sweep."""
    out, _ = gossip_flat_coded(as_codec(qcfg), buf, prev_buf, perm, matched,
                               rng, u=u, tile_rows=tile_rows)
    return out


# ---------------------------------------------------------------------------
# The ppermute transports on one shard
# ---------------------------------------------------------------------------

MULTI_SHARD = ("a node mesh of more than one shard (one rank a GPU over "
               "torch.distributed) waits for the multi-GPU (NCCL) "
               "transport item of ROADMAP.md (Queue A 4)")


def check_one_shard(n_shards: int) -> None:
    """Every node lives in this process on one device; anything else
    raises — there is no fallback to the one-shard path."""
    if n_shards != 1:
        raise NotImplementedError(f"n_shards={n_shards}: {MULTI_SHARD}")


def _perm_from_pairs(n: int, pairs):
    perm = np.arange(n)
    for s, d in pairs:
        perm[d] = s
    return perm


def pairs_from_perm(perm_arr):
    """Involution perm -> static (src, dst) pairs; an all-identity matching
    gives ``[(0, 0)]``, a self-send, as the reference's does."""
    return [(int(perm_arr[d]), int(d)) for d in range(len(perm_arr))
            if perm_arr[d] != d] or [(0, 0)]


_CONSTANTS: dict = {}


def device_constant(arr, device) -> torch.Tensor:
    """Host integer array -> int64 tensor on `device`, made once and
    cached: a CUDA graph capture cannot copy from the host, so the static
    pairs and the stacked pool are on the card before the first capture
    (the chunk driver runs its first superstep eagerly)."""
    a = np.ascontiguousarray(np.asarray(arr, np.int64))
    device = torch.device(device)
    key = (a.shape, a.tobytes(), str(device))
    hit = _CONSTANTS.get(key)
    if hit is None:
        hit = _CONSTANTS[key] = torch.as_tensor(a, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return hit


def pool_perm(pool, pool_idx, device) -> torch.Tensor:
    """The matching ``pool[pool_idx]`` as an int64 [n] tensor, gathered on
    the device from the stacked pool: `pool_idx` may be a device tensor
    (any shape, its first element read), so no host sync is made. The
    index is clamped into the pool, as ``lax.switch`` clamps it."""
    stacked = device_constant(np.stack([np.asarray(p) for p in pool]),
                              device)
    idx = torch.as_tensor(pool_idx, device=device).reshape(-1)[:1]
    idx = torch.clamp(idx.to(torch.int64), 0, stacked.shape[0] - 1)
    return stacked.index_select(0, idx).reshape(-1)


def permute_payload_ppermute(payload: Sequence[torch.Tensor], pairs,
                             n_nodes: int, *, n_shards: int = 1):
    """ONE permute per in-flight payload tensor by the static pairs."""
    check_one_shard(n_shards)
    perm = device_constant(_perm_from_pairs(n_nodes, pairs),
                           payload[0].device)
    return tuple(permute_rows(x, perm, n_nodes) for x in payload)


def permute_payload_pool(payload: Sequence[torch.Tensor], pool, pool_idx,
                         n_nodes: int, *, n_shards: int = 1):
    """ONE permute per in-flight payload tensor by the pool entry
    `pool_idx` selects."""
    check_one_shard(n_shards)
    perm = pool_perm(pool, pool_idx, payload[0].device)
    return tuple(permute_rows(x, perm, n_nodes) for x in payload)


def _gossip_by_perm(buf, perm, codec, prev_buf, rng, u, mask, tile_rows):
    """The one-shard exchange of a static matching `perm`: its fixed
    points unmatched, `mask` gating the pairs that land."""
    n = buf.shape[0]
    matched = perm != torch.arange(n, device=buf.device)
    if mask is not None:
        matched = matched & mask
    if codec is None:
        return gossip_flat_exact(buf, perm, matched)
    out, _ = gossip_flat_coded(codec, buf, prev_buf, perm, matched, rng,
                               u=u, tile_rows=tile_rows)
    return out


def _no_residual(codec):
    if codec is not None and codec.carries_residual:
        raise ValueError(
            f"{codec.name}: error-feedback codecs run on the gather "
            "transport (see the codec axis of algorithms/registry.py "
            "CAPABILITIES)")


def gossip_flat_ppermute(buf, pairs, *, quant=None, prev_buf=None, rng=None,
                         u=None, mask=None, n_shards: int = 1,
                         tile_rows: int = DEFAULT_TILE_ROWS):
    """The static matching's exchange over the flat buffer: fp32, or the
    codec `quant` (a ModularQuantConfig or any codec without a residual)
    through its encode / permute / fused decode. `pairs` is the static
    involution [(src, dst), ...]; `mask` (bool [n_nodes]) gates which of
    its pairs land this superstep."""
    codec = as_codec(quant)
    _no_residual(codec)
    check_one_shard(n_shards)
    perm = device_constant(_perm_from_pairs(buf.shape[0], pairs), buf.device)
    return _gossip_by_perm(buf, perm, codec, prev_buf, rng, u, mask,
                           tile_rows)


def gossip_flat_ppermute_pool(buf, pool, pool_idx, *, quant=None,
                              prev_buf=None, rng=None, u=None, mask=None,
                              n_shards: int = 1,
                              tile_rows: int = DEFAULT_TILE_ROWS):
    """`gossip_flat_ppermute` by the pool entry `pool_idx` selects (a
    device tensor or an int); `mask` gates which of its pairs land."""
    codec = as_codec(quant)
    _no_residual(codec)
    check_one_shard(n_shards)
    perm = pool_perm(pool, pool_idx, buf.device)
    return _gossip_by_perm(buf, perm, codec, prev_buf, rng, u, mask,
                           tile_rows)
