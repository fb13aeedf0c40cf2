"""Paged KV cache for the serving engine (``repro/serve/paged.py``).

The dense engine gives every lane a full `kv_capacity` KV allocation for
every full-attention layer, occupied or not. Here those layers share one
global page pool per layer — ``[n_pages, page, n_kv_heads, head_dim]`` —
and each lane holds an int32 page table (ONE table per lane: every
attention layer of a lane caches the same positions). Pages are allocated
on admission and freed on retirement by a host-side LIFO free list; an
admission that cannot get its pages DEFERS at the queue head — pool
pressure is a second backpressure signal next to the bounded queue.

What stays dense: SSM (mamba) lane states are already O(1) per lane, and
sliding-window layers keep their ring buffers (a ring IS a fixed-size
page). Only ``mixer == "attn"`` layers page.

Bitwise contract: decode reconstructs each lane's contiguous cache with
``attention.gather_pages`` — same rows, same order, same shape as the
dense bank — so the paged engine's token stream is bit for bit the dense
engine's. The write side is a masked one-hot scatter
(:func:`scatter_rows`): every hit pool row receives exactly one
``1.0 * new`` term plus zeros, which is exact, and page tables are
disjoint across lanes by the allocator's invariant, so no row is ever hit
twice.

Layout: the engine runs its slots as one batch, so row trees carry the
slot axis after the stacked block axis (``blocks`` rows [L, slots, T, kv,
hd], ``tail`` rows [slots, T, kv, hd]), where the reference's vmap puts
it first. On a node split over K GPUs (`tp`) a GPU's pools hold its own
kv heads (``models/transformer.py`` ``local_kv_heads``), and the byte
counts are a GPU's.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.models.transformer import local_kv_heads
from repro_torch.tree import tree_leaves


class PageAllocator:
    """Host-side page allocator: LIFO free list over ``n_pages`` pages.

    ``alloc`` is all-or-nothing (a partially allocated lane could not
    hold its sequence); ``free`` restores pages for reuse. The class
    tracks the allocated set and asserts against double-free and
    double-alloc — page aliasing across lanes would silently corrupt
    another lane's KV state, so it must be impossible, not just unlikely.
    """

    def __init__(self, n_pages: int):
        assert n_pages > 0, n_pages
        self.n_pages = n_pages
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self._used: set = set()

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return len(self._used)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n pages or None (never a partial grant)."""
        assert n > 0, n
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        assert not (set(pages) & self._used), \
            "allocator handed out a live page"
        self._used.update(pages)
        return pages

    def free(self, pages: List[int]):
        for p in pages:
            assert p in self._used, f"double free of page {p}"
            self._used.discard(p)
            self._free.append(p)


def attn_layer_entries(cfg) -> List[Tuple[str, str]]:
    """(group, layer_key) of every PAGED layer: full attention only."""
    out = []
    if cfg.n_full_blocks > 0:
        out += [("blocks", f"layer_{i}")
                for i, (mx, _) in enumerate(cfg.pattern) if mx == "attn"]
    if cfg.tail_pattern:
        out += [("tail", f"layer_{i}")
                for i, (mx, _) in enumerate(cfg.tail_pattern) if mx == "attn"]
    return out


def build_pools(cfg, n_pages: int, page: int, dtype, device,
                tp=None) -> Dict[str, Any]:
    """Global page pools, one {"k","v"} pair per full-attention layer;
    scanned block layers carry the leading [n_full_blocks] axis (each of
    the stacked block copies is a distinct layer with its own pool). On
    the model axis (`tp`) the GPU's kv heads."""
    shape = (n_pages, page, local_kv_heads(cfg, tp), cfg.resolved_head_dim)
    pools: Dict[str, Any] = {}
    for group, key in attn_layer_entries(cfg):
        s = (cfg.n_full_blocks,) + shape if group == "blocks" else shape
        pools.setdefault(group, {})[key] = {
            "k": torch.zeros(s, dtype=dtype, device=device),
            "v": torch.zeros(s, dtype=dtype, device=device)}
    return pools


def strip_attn_kv(cfg, cache):
    """Split a dense cache tree into (paged-lane tree, stripped rows).

    The lane tree keeps everything per-lane (len, mamba states, swa
    rings) with full-attention layers reduced to ``{}`` — their KV lives
    in the pools. The stripped {"k","v"} subtrees are returned for the
    blocking-admit install path (scattered into the pools)."""
    cache = dict(cache)
    rows: Dict[str, Any] = {}
    for group, key in attn_layer_entries(cfg):
        grp = dict(cache[group])
        layer = dict(grp[key])
        rows.setdefault(group, {})[key] = {
            "k": layer.pop("k"), "v": layer.pop("v")}
        grp[key] = layer
        cache[group] = grp
    return cache, rows


def split_new_rows(new_caches):
    """Pop the {"new_k","new_v"} row leaves a paged forward returns out of
    a cache tree; returns (tree_without_rows, rows_tree_or_None) with the
    rows renamed back to {"k","v"} (scatter_tree's vocabulary)."""
    new_caches = dict(new_caches)
    rows: Dict[str, Any] = {}
    for group in ("blocks", "tail"):
        if group not in new_caches:
            continue
        grp = dict(new_caches[group])
        for key, layer in list(grp.items()):
            if isinstance(layer, dict) and "new_k" in layer:
                layer = dict(layer)
                rows.setdefault(group, {})[key] = {
                    "k": layer.pop("new_k"), "v": layer.pop("new_v")}
                grp[key] = layer
        new_caches[group] = grp
    return new_caches, (rows or None)


def scatter_rows(pool, rows, pages, lens, n_valid, commit, page: int):
    """Masked one-hot scatter of per-lane KV rows into a page pool.

    pool:[(L,) G, page, kv, hd]; rows:[(L,) slots, T, kv, hd];
    pages:[slots, n_pp] page tables; lens/n_valid:[slots] ints;
    commit:[slots] bool. Lane b's token t lands at position ``lens[b] +
    t`` = row ``pos % page`` of page ``pages[b, pos // page]``, iff
    ``commit[b] and t < n_valid[b]``. Exact: page tables are disjoint
    across lanes and positions distinct within one, so each pool row gets
    at most one ``1.0 * x`` term."""
    G, P = pool.shape[-4], pool.shape[-3]
    assert P == page, (P, page)
    dev = pool.device
    T, n_pp = rows.shape[-3], pages.shape[1]
    t = torch.arange(T, device=dev)
    pos = lens.to(torch.int64)[:, None] + t[None, :]         # [slots,T]
    # out-of-table positions only occur at length-masked tokens (ok below
    # is False there); the reference's take_along_axis clips, torch's
    # gather raises, so clamp explicitly
    col = torch.clamp(pos // page, max=n_pp - 1)
    pid = torch.gather(pages.to(torch.int64), 1, col)        # [slots,T]
    ok = commit[:, None] & (t[None, :] < n_valid.to(torch.int64)[:, None])
    M = ok[:, :, None, None] & \
        (pid[:, :, None, None] ==
         torch.arange(G, device=dev)[None, None, :, None]) & \
        ((pos % page)[:, :, None, None] ==
         torch.arange(P, device=dev)[None, None, None, :])   # [slots,T,G,P]
    Mf = M.to(pool.dtype)
    hit = M.any(dim=1).any(dim=0)                            # [G,P]
    if pool.ndim == 5:
        scat = torch.einsum("btgr,lbtkh->lgrkh", Mf, rows.to(pool.dtype))
        hit = hit[None, :, :, None, None]
    else:
        scat = torch.einsum("btgr,btkh->grkh", Mf, rows.to(pool.dtype))
        hit = hit[:, :, None, None]
    return torch.where(hit, scat, pool)


def scatter_tree(pools, rows, pages, lens, n_valid, commit, page: int):
    """scatter_rows over every paged layer of a pools tree."""
    return {group: {key: {kv: scatter_rows(pool[kv], rows[group][key][kv],
                                           pages, lens, n_valid, commit,
                                           page)
                          for kv in ("k", "v")}
                    for key, pool in layers.items()}
            for group, layers in pools.items()}


def tree_num_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def dense_attn_bank_bytes(cfg, slots: int, capacity: int, dtype,
                          tp=None) -> int:
    """Device bytes the DENSE engine's full-attention KV bank costs — the
    paged pool's baseline; on the model axis (`tp`) one GPU's."""
    per_row = local_kv_heads(cfg, tp) * cfg.resolved_head_dim * \
        torch.empty((), dtype=dtype).element_size()
    n_layers = sum(cfg.n_full_blocks if g == "blocks" else 1
                   for g, _ in attn_layer_entries(cfg))
    return 2 * n_layers * slots * capacity * per_row        # k + v
