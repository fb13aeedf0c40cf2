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
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

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
