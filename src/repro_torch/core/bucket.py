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
pool entry, as the reference's one-shard branch is. On a node mesh
(``launch/mesh.py``: one node a ``torch.distributed`` rank, NCCL on the
card, gloo on the CPU) each rank encodes its own rows, ONE
``batch_isend_irecv`` message per wire tensor crosses between partners,
and the fused decode-average lands against its own rows: the ppermute
transports post by the static pairs (the reference's ``shard_map``
bodies), the gather transport by the engine's host perm, which may be any
permutation (SGP's cyclic shift included). The node mean and the dense
mix all-gather the ranks' rows and run the one-shard reduction or product
on them, so every mesh exchange is bitwise the one-shard one.

With a model axis (a node split over K GPUs, ``launch/mesh.py``) each rank
packs, encodes and exchanges its own slice of its node: the exchanges run
over the node group, between the ranks of one model index, and a message's
peer is that node's rank at this model index (``NodeMesh.peer``). A leaf
every GPU of the node holds whole lies at the same offset on each of them
(the slices have equal shapes), and the encode's uniforms come from the
node's fold of the run's generator, so its rows stay bitwise equal across
the node's GPUs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
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


def gossip_flat_exact(buf, perm, matched=None, *, mesh=None):
    """(buf + buf[perm]) / 2 — one gather over one tensor. For a matching
    `perm` is an involution with fixed points at unmatched nodes, and
    (x + x) * 0.5 == x for every finite float, so no mask is needed unless
    `matched` gates a partial landing (SGP's directed shift gates through
    `matched` the same way).

    On a node `mesh` `buf` is the rank's row ([1, n_padded]), `perm` the
    global host perm and `matched` the rank's flag ([1]): the partner's
    row arrives as one message (:func:`post_gather`)."""
    if mesh is None:
        avg = (buf + buf[perm]) * 0.5
    else:
        _one_node_a_rank(buf, mesh)
        with record_function("gossip.permute"):
            xp, = post_gather((buf,), mesh, perm).wait()
        avg = (buf + xp) * 0.5
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
                      *, residual=None, u=None, mesh=None,
                      tile_rows: int = DEFAULT_TILE_ROWS):
    """Encode once (one quantize_mod sweep for the lattice), permute every
    wire tensor, decode + average + matched mask in one fused decode_avg
    sweep. Returns (mixed, new_residual); new_residual is None unless the
    codec carries an error-feedback residual, whose update is gated by
    `matched` (an unconsumed payload leaves it to re-enter the next
    encode).

    On a node `mesh` `buf`, `prev_buf`, `residual` and `u` are the rank's
    row ([1, n_padded]), `perm` the global host perm and `matched` the
    rank's flag ([1]); the uniforms, unless given, come from the rank's
    generator folded from `rng` (every rank folds, so the run's generator
    moves on alike). Each wire tensor crosses as one message
    (:func:`post_gather`); a fixed point of `perm` decodes its own wire,
    as ``buf[perm]`` gives it its own row, and lands nothing unless
    `matched` says so."""
    if mesh is not None:
        _one_node_a_rank(buf, mesh)
        if codec.needs_rng and u is None and rng is not None:
            rng = mesh.fold_generator(rng)
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
        if mesh is None:
            wire_p = tuple(permute_rows(w, perm, n_nodes) for w in wire)
        else:
            wire_p = post_gather(wire, mesh, perm).wait()
        m_rows = row_mask(matched, rpn)
    del wire
    if mesh is None:
        # the wrap counter reads the sender's row, which a rank of a node
        # mesh does not hold
        count_wraps(codec, wire_p, buf, perm, matched)
    with record_function("gossip.decode"):
        out = codec.decode_avg(wire_p, buf, m_rows, tile_rows=tile_rows)
    return out, new_residual


def _as_bytes(x: torch.Tensor) -> torch.Tensor:
    """`x`'s bytes as one contiguous uint8 vector (q9..q16 codes and bf16
    cross a collective bit for bit; NCCL has no 16-bit integer type)."""
    return x.contiguous().reshape(-1).view(torch.uint8)


def _from_bytes(b: torch.Tensor, like: torch.Tensor, n: int) -> torch.Tensor:
    """`n` ranks' slabs of `like`'s shape, as uint8 rows `b` ([n, bytes]),
    viewed back and stacked along dim 0 in rank order."""
    return b.view(like.dtype).reshape((n * like.shape[0],) +
                                      tuple(like.shape[1:]))


def all_gather_slab(x: torch.Tensor, mesh) -> torch.Tensor:
    """The rank's leading-axis slab `x` ([k, ...], the same k on every
    rank) -> every rank's, concatenated along dim 0 in rank order
    ([mesh.size * k, ...]): ONE all-gather of its bytes into one buffer.
    A node-contiguous slab (one node's rows of a wire tuple, say) lands
    in the one-shard layout."""
    if x.dim() == 0:
        raise ValueError("a 0-d tensor has no leading axis to gather along")
    xb = _as_bytes(x)
    out = torch.empty((mesh.size, xb.numel()), dtype=torch.uint8,
                      device=x.device)
    dist.all_gather(list(out.unbind(0)), xb, group=mesh.group)
    return _from_bytes(out, x, mesh.size)


def gather_slab(x: torch.Tensor, mesh, dst: int = 0):
    """:func:`all_gather_slab` to rank `dst` only (``dist.gather``): that
    rank gets every rank's slab concatenated in rank order, the others
    None, so they never hold the others' copies."""
    if x.dim() == 0:
        raise ValueError("a 0-d tensor has no leading axis to gather along")
    xb = _as_bytes(x)
    out = torch.empty((mesh.size, xb.numel()), dtype=torch.uint8,
                      device=x.device) if mesh.rank == dst else None
    dist.gather(xb, None if out is None else list(out.unbind(0)),
                dst=mesh.peer(dst), group=mesh.group)
    return None if out is None else _from_bytes(out, x, mesh.size)


def all_gather_model(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """The K slices of a leaf over the model group (`x` this rank's),
    concatenated along `dim` in model index order: ONE all-gather of its
    bytes."""
    xb = _as_bytes(x)
    k = mesh.model_size
    out = torch.empty((k, xb.numel()), dtype=torch.uint8, device=x.device)
    dist.all_gather(list(out.unbind(0)), xb, group=mesh.model_group)
    parts = out.view(x.dtype).reshape((k,) + tuple(x.shape)).unbind(0)
    return torch.cat(parts, dim=dim)


def all_gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """The rank's row `x` ([1, ...]) -> every rank's, stacked in rank
    order ([mesh.size, ...]): :func:`all_gather_slab` of one node."""
    _one_node_a_rank(x, mesh)
    return all_gather_slab(x, mesh)


def gossip_flat_mean(buf, mask=None, *, mesh=None):
    """(Masked) mean over the node axis, broadcast back to every node —
    the flat form of LocalSGD's resync and AllReduce's gradient mean. With
    `mask` the mean runs over the participants only, sum(w * buf) /
    max(sum(w), 1), and is still broadcast everywhere. The result is a
    broadcast view of one row; `unpack` copies it out.

    On a node `mesh` (`buf` the rank's row, `mask` the global vector) the
    rows are all-gathered and reduced as on one shard, so the mean is
    bitwise the one-shard one (a ring all-reduce sums in an order that
    changes with its chunking and would not be); -> the rank's row."""
    if mesh is not None:
        with record_function("gossip.gather"):
            rows = all_gather_rows(buf, mesh)
        return gossip_flat_mean(rows, mask)[mesh.rank:mesh.rank + 1]
    if mask is None:
        mu = torch.mean(buf, dim=0, keepdim=True)
    else:
        w = mask.to(torch.float32)
        mu = torch.sum(w[:, None] * buf, dim=0, keepdim=True) / \
            torch.clamp_min(torch.sum(w), 1.0)
    return mu.expand(buf.shape)


def gossip_flat_matrix(W, buf, *, mesh=None):
    """Dense mixing X <- W X over the packed buffer: ONE [n, n] x
    [n, n_padded] fp32 product for the whole model (D-PSGD's Metropolis
    mixing). The caller keeps TF32 off on the card
    (``torch.backends.cuda.matmul.allow_tf32 = False``).

    On a node `mesh` (`buf` the rank's row, `W` the replicated [n, n])
    the rows are all-gathered and the same product runs as on one shard;
    -> the rank's row of W X."""
    if mesh is not None:
        with record_function("gossip.gather"):
            rows = all_gather_rows(buf, mesh)
        return gossip_flat_matrix(W, rows)[mesh.rank:mesh.rank + 1]
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
# The ppermute transports: every node on one shard, or a node mesh of one
# node a rank (``launch/mesh.py``)
# ---------------------------------------------------------------------------

#: What a node mesh does not carry yet, each refusal naming the ROADMAP.md
#: item that carries it.
NOT_ON_A_MESH = {
    "nodes_per_shard": ("a node mesh holds one node a rank; more than one "
                        "node a shard waits for ROADMAP.md Queue A 6"),
}


def check_mesh_nodes(n_nodes: int, mesh) -> None:
    """One node a rank: `n_nodes` must be the mesh's size."""
    if n_nodes != mesh.size:
        raise ValueError(f"n_nodes={n_nodes} on a node mesh of {mesh.size} "
                         f"ranks: {NOT_ON_A_MESH['nodes_per_shard']}")


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


def pool_pairs(pool, pool_idx):
    """The static pairs of ``pool[pool_idx]``, chosen on the host: a node
    mesh posts its messages by them, so the index is a host value (an
    int, a numpy array or a CPU tensor, its first element read), clamped
    into the pool as ``lax.switch`` clamps it."""
    idx = int(np.asarray(pool_idx).reshape(-1)[0])
    return pairs_from_perm(pool[min(max(idx, 0), len(pool) - 1)])


def gather_peers(perm, mesh, land=None):
    """-> (dsts, src) of this rank under the gather by the host `perm`
    (global [mesh.size] int array), ``out[i] = in[perm[i]]``: it receives
    from ``perm[rank]`` and sends to every ``j != rank`` with ``perm[j] ==
    rank``. For a matching that is its one partner both ways; under a
    permutation that is not an involution (SGP's cyclic shift) the two
    differ. A fixed point receives nothing (src None). With `land` (host
    bool [mesh.size]) only the ranks it marks receive: the others' sends
    to them are not posted."""
    p = np.asarray(perm).reshape(-1)
    if p.shape != (mesh.size,) or p.min() < 0 or p.max() >= mesh.size:
        raise ValueError(f"perm {p.tolist()} on a node mesh of {mesh.size}: "
                         "the global host vector of node indices")
    lm = np.ones(mesh.size, bool) if land is None \
        else np.asarray(land, bool).reshape(-1)
    r = mesh.rank
    dsts = [int(j) for j in np.flatnonzero(p == r) if j != r and lm[j]]
    src = int(p[r]) if p[r] != r and lm[r] else None
    return dsts, src


def mesh_peers(pairs, mesh):
    """-> (dst, src): the rank this rank sends to and the one it receives
    from under the static `pairs` (None where it has none; a self-pair
    moves nothing), as ``ppermute`` reads them: each rank a source and a
    destination at most once."""
    for s, d in pairs:
        if not (0 <= s < mesh.size and 0 <= d < mesh.size):
            raise ValueError(f"pair {(s, d)} outside a node mesh of "
                             f"{mesh.size}")
    dst = [int(d) for s, d in pairs if s == mesh.rank and s != d]
    src = [int(s) for s, d in pairs if d == mesh.rank and s != d]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"pairs {pairs}: rank {mesh.rank} sends to {dst} "
                         f"and receives from {src}; a permutation sends and "
                         "receives once")
    return (dst[0] if dst else None), (src[0] if src else None)


class Posted:
    """The point-to-point work of one exchange in flight on a node mesh:
    `recv`, the tensors it receives into, holds the partner's payload once
    :meth:`wait` returns. It holds what it sends until then. ``wait``
    makes the current CUDA stream wait for the transfer (NCCL; the NCCL
    stream itself waited for the current stream when the work was posted)
    or blocks until it is done (gloo)."""

    def __init__(self, works, recv, sent):
        self.works, self.recv, self._sent = works, recv, sent

    def wait(self) -> Tuple[torch.Tensor, ...]:
        for w in self.works:
            w.wait()
        self.works, self._sent = [], ()
        return self.recv


def _post(payload, mesh, dsts, src, own: bool) -> Posted:
    """ONE message per tensor of `payload` to each of `dsts` and one from
    `src`, in one ``batch_isend_irecv``, in payload order on both sides.
    Every tensor crosses as a contiguous uint8 view of its bytes and is
    viewed back on receipt (NCCL has no 16-bit integer type), so uint16
    codes and bf16 cross bit for bit. With no `src` the rank receives its
    own tensor (`own`, a gather's fixed point) or zeros (``ppermute``'s);
    nothing to send or receive posts nothing."""
    ops, recv, sent = [], [], []
    for i, x in enumerate(payload):
        if dsts:
            xb = _as_bytes(x)
            sent.append(xb)
            ops.extend(dist.P2POp(dist.isend, xb, mesh.peer(d),
                                  group=mesh.group, tag=i) for d in dsts)
        if src is None:
            recv.append(x if own else torch.zeros_like(x))
            continue
        rb = torch.empty((x.numel() * x.element_size(),), dtype=torch.uint8,
                         device=x.device)
        ops.append(dist.P2POp(dist.irecv, rb, mesh.peer(src),
                              group=mesh.group, tag=i))
        recv.append(rb.view(x.dtype).reshape(x.shape))
    works = dist.batch_isend_irecv(ops) if ops else []
    return Posted(works, tuple(recv), tuple(sent))


def post_exchange(payload: Sequence[torch.Tensor], mesh, pairs) -> Posted:
    """Post this rank's share of one exchange of `payload` (a tuple of
    tensors, the rank's rows) by the static `pairs`: one message per
    tensor to its destination and one from its source (:func:`_post`).
    Where the pairs give the rank no source it receives zeros, as
    ``ppermute`` gives; an all-identity matching posts nothing."""
    dst, src = mesh_peers(pairs, mesh)
    return _post(payload, mesh, [] if dst is None else [dst], src, False)


def post_gather(payload: Sequence[torch.Tensor], mesh, perm,
                land=None) -> Posted:
    """Post this rank's share of the gather ``payload[perm]`` by the host
    `perm` (:func:`gather_peers`; `land` keeps the messages to the ranks
    it marks): one message per tensor from ``perm[rank]``, one to each
    rank that reads this one. A rank that receives nothing gets its own
    tensor back, ``buf[perm]``'s row at a fixed point."""
    dsts, src = gather_peers(perm, mesh, land)
    return _post(payload, mesh, dsts, src, True)


def _one_node_a_rank(x: torch.Tensor, mesh) -> None:
    if x.shape[0] != 1:
        raise ValueError(f"a rank of a node mesh holds one node, got a "
                         f"leading dim of {x.shape[0]}: "
                         f"{NOT_ON_A_MESH['nodes_per_shard']}")


def mesh_landing(mesh, pairs, mask, device) -> torch.Tensor:
    """This rank's landing flag, bool [1]: matched by the static pairs,
    gated by ``mask[rank]`` when a participation `mask` (bool
    [mesh.size], the global vector) is given — the reference's
    ``_local_mask(axis_index, mask)``."""
    if mask is not None and tuple(mask.shape) != (mesh.size,):
        raise ValueError(f"a mask of shape {tuple(mask.shape)} on a node "
                         f"mesh of {mesh.size}: it takes the global "
                         f"[{mesh.size}] vector")
    if _perm_from_pairs(mesh.size, pairs)[mesh.rank] == mesh.rank:
        return torch.zeros((1,), dtype=torch.bool, device=device)
    if mask is None:
        return torch.ones((1,), dtype=torch.bool, device=device)
    return mask[mesh.rank:mesh.rank + 1].to(device=device, dtype=torch.bool)


def _gossip_on_mesh(buf, pairs, codec, prev_buf, rng, u, mask, mesh,
                    tile_rows):
    """This rank's share of a static-pairs exchange on a node mesh (the
    reference's ``shard_map`` body): the encode of its own rows with its
    own uniforms, one message per wire tensor to and from its partner, the
    fused decode-average against its own rows, landing where
    :func:`mesh_landing` says. A rank with no partner returns `buf`."""
    _one_node_a_rank(buf, mesh)
    if codec is not None and codec.needs_rng and u is None \
            and rng is not None:
        # every rank folds, partner or not, so the run's generator moves
        # on alike everywhere
        rng = mesh.fold_generator(rng)
    peers = mesh_peers(pairs, mesh)
    m = mesh_landing(mesh, pairs, mask, buf.device)
    if peers == (None, None):
        return buf
    if codec is None:
        with record_function("gossip.permute"):
            xh, = post_exchange((buf,), mesh, pairs).wait()
        return torch.where(m[:, None], (buf + xh) * 0.5, buf)
    with record_function("gossip.encode"):
        wire = codec.encode(buf, prev_buf, rng, u=u, tile_rows=tile_rows)
    with record_function("gossip.permute"):
        wire_p = post_exchange(wire, mesh, pairs).wait()
    del wire
    m_rows = row_mask(m, buf.shape[1] // codec.block)
    with record_function("gossip.decode"):
        return codec.decode_avg(wire_p, buf, m_rows, tile_rows=tile_rows)


def permute_payload_ppermute(payload: Sequence[torch.Tensor], pairs,
                             n_nodes: int, *, mesh=None):
    """ONE permute per in-flight payload tensor by the static pairs: a
    local gather on one shard; on a node `mesh` ONE message per tensor to
    and from the rank's partner, -> the tensors it received."""
    if mesh is not None:
        check_mesh_nodes(n_nodes, mesh)
        return post_exchange(payload, mesh, pairs).wait()
    perm = device_constant(_perm_from_pairs(n_nodes, pairs),
                           payload[0].device)
    return tuple(permute_rows(x, perm, n_nodes) for x in payload)


def permute_payload_pool(payload: Sequence[torch.Tensor], pool, pool_idx,
                         n_nodes: int, *, mesh=None):
    """ONE permute per in-flight payload tensor by the pool entry
    `pool_idx` selects (on a node mesh a host index, :func:`pool_pairs`)."""
    if mesh is not None:
        return permute_payload_ppermute(payload, pool_pairs(pool, pool_idx),
                                        n_nodes, mesh=mesh)
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
                         u=None, mask=None, mesh=None,
                         tile_rows: int = DEFAULT_TILE_ROWS):
    """The static matching's exchange over the flat buffer: fp32, or the
    codec `quant` (a ModularQuantConfig or any codec without a residual)
    through its encode / permute / fused decode. `pairs` is the static
    involution [(src, dst), ...]; `mask` (bool [n_nodes]) gates which of
    its pairs land this superstep.

    On a node `mesh` `buf` (and `prev_buf`, `u`) hold the rank's one node
    ([1, n_padded]) and `mask` is the global [mesh.size] vector: one
    message per wire tensor crosses to and from the rank's partner, and
    the uniforms, unless given, come from the rank's own generator folded
    from `rng` (``NodeMesh.fold_generator``)."""
    codec = as_codec(quant)
    _no_residual(codec)
    if mesh is not None:
        return _gossip_on_mesh(buf, pairs, codec, prev_buf, rng, u, mask,
                               mesh, tile_rows)
    perm = device_constant(_perm_from_pairs(buf.shape[0], pairs), buf.device)
    return _gossip_by_perm(buf, perm, codec, prev_buf, rng, u, mask,
                           tile_rows)


def gossip_flat_ppermute_pool(buf, pool, pool_idx, *, quant=None,
                              prev_buf=None, rng=None, u=None, mask=None,
                              mesh=None,
                              tile_rows: int = DEFAULT_TILE_ROWS):
    """`gossip_flat_ppermute` by the pool entry `pool_idx` selects (a
    device tensor or an int on one shard, a host value on a node `mesh`);
    `mask` gates which of its pairs land."""
    codec = as_codec(quant)
    _no_residual(codec)
    if mesh is not None:
        return _gossip_on_mesh(buf, pool_pairs(pool, pool_idx), codec,
                               prev_buf, rng, u, mask, mesh, tile_rows)
    perm = pool_perm(pool, pool_idx, buf.device)
    return _gossip_by_perm(buf, perm, codec, prev_buf, rng, u, mask,
                           tile_rows)
