"""Decoder stack (``repro/models/transformer.py``): global and
sliding-window attention (QK-norm, local RoPE), Mamba2, dense MLP and
mixture-of-experts layers, and a modality prefix, for training and for
serving.

Parameters are a nested dict in the JAX package's layout: ``embed``
[V, D], ``final_norm``, and ``blocks`` whose leaves carry a leading
``[n_full_blocks]`` dim (the reference's scanned blocks), plus ``tail`` for
depths that are not a multiple of the pattern. :class:`TransformerLM` is the
same model as an ``nn.Module`` whose parameter names are the tree paths
(``blocks.layer_0.attn.wq``); the engine calls it functionally
(``torch.func.functional_call``) on one node's parameters.

Entry points:
  param_template(cfg) / init_params(gen, cfg, device)
  param_split(cfg, K) / shard_template(cfg, K)   a node over K GPUs
  forward(cfg, params, tokens, mode=...)     train / prefill / decode / chunk
  loss_fn(cfg, params, batch)                chunked CE + router aux loss
  node_losses(cfg, params, batch)            every node's loss_fn (remat)
  init_cache(cfg, batch, cache_size, device=...)   KV / ring / SSM cache tree
  logits_head(cfg, params, hidden)           fp32 logits [B, S, V]

On a node split over K GPUs (``tp``, ``launch/mesh.py`` ``ModelShard``;
the parameters this GPU's slices, :func:`param_split` by the rules of
``models/split.py``) training runs the
reference's tensor-parallel layout: each attention layer the GPU's own
heads with a row-parallel ``wo``, the MLP column- then row-parallel, a
MoE layer's experts split by expert or by d_ff behind a whole router
(``models/moe.py``), the embedding a masked lookup of the GPU's vocab
rows summed over the model group, and the cross-entropy vocab-parallel
(``models/layers.py``). Norms, ``q_norm`` / ``k_norm``, the router and
the frontend's ``proj`` stay whole on every GPU. Serving (prefill,
decode, chunk) runs the same layers on the GPU's slices: its caches hold
the kv heads its q heads read (``init_cache(..., tp=)``, ``models/split.py``
``kv_heads_of``), and ``logits_head`` all-gathers a vocab-split table's
logits over the model group, so that every GPU samples from the whole
row. The sequence-split decode is refused (``NOT_ON_THE_MODEL_AXIS``).

A cache's leaves carry the batch on their first axis after the stacked
block axis (``blocks`` leaves [n_blocks, B, ...], ``tail`` leaves [B, ...]),
and its ``len`` is a scalar or one length per lane [B]: the serving engine
runs its slots as one batch where the reference vmaps a batch-1 call. A
sliding-window layer caches a ring of min(window, capacity) rows: position
p lives in slot p % w, so its slot, its unroll order and its first valid
row are per-lane gathers of ``len``.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import multimodal as mm_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (
    ParamInfo, apply_mlp, apply_norm, apply_rope, chunked_softmax_xent,
    copy_to_model, gather_from_model, init_from_template, mlp_template,
    norm_template, per_lane, reduce_from_model, rms_norm_simple,
    stack_template,
)
from repro_torch.models.split import (
    MODEL_AXIS, NOT_ON_THE_MODEL_AXIS, check_model_parallel, kv_heads_of,
    logical_rules, take_slice,
)
from repro_torch.tree import tree_leaves, tree_map, tree_paths


def _pick_chunk(s: int, cap: int = 1024) -> int:
    c = 1
    while c < cap and s % (c * 2) == 0:
        c *= 2
    return min(c, s)


# ---------------------------------------------------------------------------
# Cache writes (masked one-hot: the reference's write discipline)
# ---------------------------------------------------------------------------


def _cache_write(cache_arr, new, idx):
    """cache_arr:[B,S,kv,hd], new:[B,1,kv,hd], idx: slot per lane (or
    scalar): an elementwise one-hot select, exact."""
    B, S = cache_arr.shape[0], cache_arr.shape[1]
    onehot = torch.arange(S, device=cache_arr.device)[None, :] == \
        per_lane(idx, B, cache_arr.device)[:, None]          # [B,S]
    return torch.where(onehot[:, :, None, None], new.to(cache_arr.dtype),
                       cache_arr)


def _cache_write_chunk(cache_arr, new, start):
    """Write a T-row chunk at rows [start, start+T) of each lane.
    cache:[B,S,kv,hd], new:[B,T,kv,hd], start per lane (or scalar). Masked
    one-hot: each hit row receives exactly one ``1.0 * new[t]`` term plus
    zeros — exact, so chunked prefill stays bitwise on the cache
    contents; rows past the capacity are dropped."""
    B, S, T = cache_arr.shape[0], cache_arr.shape[1], new.shape[1]
    dev = cache_arr.device
    tpos = per_lane(start, B, dev)[:, None] + torch.arange(T, device=dev)
    sel = torch.arange(S, device=dev)[None, None, :] == tpos[:, :, None]
    scat = torch.einsum("bts,btkh->bskh", sel.to(cache_arr.dtype),
                        new.to(cache_arr.dtype))
    return torch.where(sel.any(dim=1)[:, :, None, None], scat, cache_arr)


def _ring_write_chunk(ring, new, start, n_valid):
    """Sliding-window variant of :func:`_cache_write_chunk`: token t of a
    lane lands in ring slot ``(start + t) % w``, and ONLY the lane's first
    ``n_valid`` tokens write — a padded token's slot may wrap onto a
    still-in-window row, so ragged chunks mask here, not by a later
    overwrite. ring:[B,w,kv,hd], new:[B,T,kv,hd] with T <= w."""
    B, w, T = ring.shape[0], ring.shape[1], new.shape[1]
    assert T <= w, (T, w)              # distinct slots per chunk
    dev = ring.device
    t = torch.arange(T, device=dev)
    tpos = per_lane(start, B, dev)[:, None] + t                 # [B,T]
    sel = ((tpos % w)[:, :, None] == torch.arange(w, device=dev)) & \
        (t[None, :] < per_lane(n_valid, B, dev)[:, None])[:, :, None]
    scat = torch.einsum("bts,btkh->bskh", sel.to(ring.dtype),
                        new.to(ring.dtype))
    return torch.where(sel.any(dim=1)[:, :, None, None], scat, ring)


# ---------------------------------------------------------------------------
# Templates
# ---------------------------------------------------------------------------


def attn_template(cfg):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    t = {
        "wq": ParamInfo((d, cfg.n_heads * hd), ("embed", "heads_x_dim")),
        "wk": ParamInfo((d, cfg.n_kv_heads * hd), ("embed", "kv_x_dim")),
        "wv": ParamInfo((d, cfg.n_kv_heads * hd), ("embed", "kv_x_dim")),
        "wo": ParamInfo((cfg.n_heads * hd, d), ("heads_x_dim", "embed")),
    }
    if cfg.qk_norm:
        t["q_norm"] = ParamInfo((hd,), (None,), "ones")
        t["k_norm"] = ParamInfo((hd,), (None,), "ones")
    return t


def layer_template(cfg, mixer: str, ffn: str):
    t: Dict[str, Any] = {"norm1": norm_template(cfg)}
    if mixer in ("attn", "swa"):
        t["attn"] = attn_template(cfg)
    elif mixer == "mamba":
        t["mamba"] = ssm_lib.mamba_template(cfg)
    else:
        raise ValueError(mixer)
    if ffn != "none":
        t["norm2"] = norm_template(cfg)
    if ffn == "dense":
        t["mlp"] = mlp_template(cfg)
    elif ffn == "moe":
        t["moe"] = moe_lib.moe_template(cfg)
    return t


def block_template(cfg, pattern):
    return {f"layer_{i}": layer_template(cfg, mx, fn)
            for i, (mx, fn) in enumerate(pattern)}


def param_template(cfg):
    d = cfg.d_model
    t: Dict[str, Any] = {
        "embed": ParamInfo((cfg.vocab_size, d), ("vocab", "embed"),
                           "normal", 0.02),
        "final_norm": norm_template(cfg),
    }
    if cfg.n_full_blocks > 0:
        t["blocks"] = stack_template(block_template(cfg, cfg.pattern),
                                     cfg.n_full_blocks)
    if cfg.tail_pattern:
        t["tail"] = block_template(cfg, cfg.tail_pattern)
    if not cfg.tie_embeddings:
        t["lm_head"] = ParamInfo((cfg.vocab_size, d), ("vocab", "embed"),
                                 "normal", 0.02)
    if cfg.frontend is not None:
        t["frontend"] = mm_lib.frontend_template(cfg)
    return t


def param_split(cfg, model_parallel: int):
    """For each leaf of ``param_template(cfg)``, the dimension cut into
    `model_parallel` slices (an index into the un-stacked leaf's shape) or
    None where every GPU of the node holds it whole (``specs.py:97``
    ``param_pspec`` read as one dimension a leaf; the rules are
    ``models/split.py``'s)."""
    K = int(model_parallel)
    rules = logical_rules(cfg, {MODEL_AXIS: K})

    def split_of(info: ParamInfo):
        dims = [i for i, a in enumerate(info.axes)
                if rules[a] == MODEL_AXIS]
        assert len(dims) <= 1, info
        if not dims or K == 1:
            return None
        assert info.shape[dims[0]] % K == 0, (info, K)
        return dims[0]
    return tree_map(split_of, param_template(cfg))


def shard_template(cfg, model_parallel: int):
    """``param_template(cfg)`` with each split leaf's shape the slice one
    GPU of the node holds."""
    K = int(model_parallel)

    def local(info: ParamInfo, d):
        if d is None:
            return info
        shape = list(info.shape)
        shape[d] //= K
        return ParamInfo(tuple(shape), info.axes, info.init, info.scale)
    return tree_map(local, param_template(cfg), param_split(cfg, K))


def init_params(gen: torch.Generator, cfg, device, tp=None):
    """The model drawn from `gen`; with `tp` (a ``ModelShard``) this GPU's
    slices of it, bitwise the slices of the whole model's draws."""
    take = None
    if tp is not None:
        split = tree_leaves(param_split(cfg, tp.size))

        def take(i, x):
            return take_slice(x, split[i], tp.size, tp.index)
    return init_from_template(gen, param_template(cfg),
                              getattr(torch, cfg.dtype), device, take)


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------


def _layer_cache(cfg, mixer: str, batch: int, cache_size: int, dtype,
                 device, n_kv: int):
    if mixer in ("attn", "swa"):
        rows = cache_size if mixer == "attn" \
            else min(cfg.sliding_window, cache_size)
        shape = (batch, rows, n_kv, cfg.resolved_head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    if mixer == "mamba":
        return ssm_lib.init_mamba_state(cfg, batch, dtype, device)
    raise ValueError(mixer)


def local_kv_heads(cfg, tp=None) -> int:
    """The kv heads one GPU caches: all of them, or on the model axis
    (`tp`) those its q heads read (``models/split.py`` ``kv_heads_of``)."""
    if tp is None:
        return cfg.n_kv_heads
    lo, hi = kv_heads_of(cfg, tp.size, tp.index)
    return hi - lo


def init_cache(cfg, batch: int, cache_size: int, dtype=None, *, device,
               tp=None, layout: str = "headdim"):
    """The empty cache of `batch` sequences of `cache_size` rows; on the
    model axis (`tp`) this GPU's: its attention and ring caches hold the
    kv heads its q heads read, the reference's ``cache_pspec`` `layout`
    "headdim" (the only one the port carries: "seqshard", the
    sequence-split decode, is refused)."""
    if layout != "headdim":
        raise ValueError(f"layout={layout!r}: "
                         f"{NOT_ON_THE_MODEL_AXIS['serve']}")
    if tp is not None:
        check_model_parallel(cfg, tp.size)
    dtype = dtype or getattr(torch, cfg.dtype)
    n_kv = local_kv_heads(cfg, tp)
    cache: Dict[str, Any] = {"len": torch.zeros((), dtype=torch.int32,
                                                device=device)}
    if cfg.n_full_blocks > 0:
        one = {f"layer_{i}": _layer_cache(cfg, mx, batch, cache_size, dtype,
                                          device, n_kv)
               for i, (mx, _) in enumerate(cfg.pattern)}
        cache["blocks"] = tree_map(
            lambda x: x.expand((cfg.n_full_blocks,) + x.shape).clone(), one)
    if cfg.tail_pattern:
        cache["tail"] = {
            f"layer_{i}": _layer_cache(cfg, mx, batch, cache_size, dtype,
                                       device, n_kv)
            for i, (mx, _) in enumerate(cfg.tail_pattern)}
    return cache


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def _local_kv(cfg, p, tp):
    """(wk, wv) as this GPU computes with them: the leaves themselves,
    whole or its slices of whole kv heads; on the model axis with
    n_kv_heads < K (``models/split.py`` ``kv_deviation``: the leaves
    whole on every GPU) the columns of the kv heads its q heads read,
    taken through ``copy_to_model``, so that the GPUs' partial gradients
    of the whole leaf are summed over the model group."""
    hd = cfg.resolved_head_dim
    if tp is None or p["wk"].shape[-1] != cfg.n_kv_heads * hd:
        return p["wk"], p["wv"]
    lo, hi = kv_heads_of(cfg, tp.size, tp.index)
    return tuple(copy_to_model(p[k], tp)[..., lo * hd:hi * hd]
                 for k in ("wk", "wv"))


def _attn_layer(cfg, p, x, positions, *, mixer: str, mode: str = "train",
                cache=None, clen=None, pool=None, pages=None, n_valid=None,
                tp=None):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    theta = cfg.rope_theta
    if mixer == "swa" and cfg.rope_theta_local is not None:
        theta = cfg.rope_theta_local
    # on the model axis: this GPU's heads (all of them without one)
    x = copy_to_model(x, tp)
    nh = p["wq"].shape[-1] // hd
    wk, wv = _local_kv(cfg, p, tp)
    q = torch.matmul(x, p["wq"]).reshape(B, S, nh, hd)
    k = torch.matmul(x, wk).reshape(B, S, wk.shape[-1] // hd, hd)
    v = torch.matmul(x, wv).reshape(B, S, wv.shape[-1] // hd, hd)
    if cfg.qk_norm:
        # whole on every GPU, used on its own heads: summed gradients
        q = rms_norm_simple(q, copy_to_model(p["q_norm"], tp))
        k = rms_norm_simple(k, copy_to_model(p["k_norm"], tp))
    q = apply_rope(q, positions, theta=theta, rot_frac=cfg.partial_rotary)
    k = apply_rope(k, positions, theta=theta, rot_frac=cfg.partial_rotary)
    new_cache = None
    if mode in ("decode", "chunk"):
        # paged full attention: reconstruct the CONTIGUOUS cache from the
        # lanes' page tables (an exact gather — attention below is bitwise
        # the dense path), attend on the copy, and hand the new k/v rows
        # back for the engine to scatter into the pools
        paged = pool is not None and mixer == "attn"
        if paged:
            kc = attn_lib.gather_pages(pool["k"], pages)
            vc = attn_lib.gather_pages(pool["v"], pages)
        else:
            kc, vc = cache["k"], cache["v"]
        w = kc.shape[1]
        if mode == "decode":
            slot = clen % w if mixer == "swa" else clen
            kc, vc = _cache_write(kc, k, slot), _cache_write(vc, v, slot)
            out = attn_lib.attention_decode(q, kc, vc, clen + 1)
        elif mixer == "swa":
            assert S <= w, f"prefill chunk {S} exceeds sliding window ring {w}"
            # unroll each lane's ring to position order and append the
            # chunk: gathered row j holds absolute position len - w + j
            lens = per_lane(clen, B, x.device)
            idx = (lens[:, None] - w + torch.arange(w, device=x.device)) % w
            lane = torch.arange(B, device=x.device)[:, None]
            kg = torch.cat([kc[lane, idx], k.to(kc.dtype)], dim=1)
            vg = torch.cat([vc[lane, idx], v.to(vc.dtype)], dim=1)
            out = attn_lib.attention_chunk_decode(
                q, kg, vg, w, window=cfg.sliding_window,
                min_kpos=torch.clamp(w - lens, min=0))
            kc = _ring_write_chunk(kc, k, clen, n_valid)
            vc = _ring_write_chunk(vc, v, clen, n_valid)
        else:   # chunk: S tokens at positions clen..clen+S-1, then attend
            kc = _cache_write_chunk(kc, k, clen)
            vc = _cache_write_chunk(vc, v, clen)
            out = attn_lib.attention_chunk_decode(q, kc, vc, clen)
        new_cache = {"new_k": k, "new_v": v} if paged \
            else {"k": kc, "v": vc}
    elif mixer == "swa":
        out = attn_lib.attention_banded(q, k, v, window=cfg.sliding_window,
                                        chunk_q=_pick_chunk(S))
        if mode == "prefill":
            # the last min(window, S) rows, rolled so that position p sits
            # in ring slot p % window
            w = min(cfg.sliding_window, S)
            klast, vlast = k[:, S - w:], v[:, S - w:]
            if cfg.sliding_window <= S:
                shift = S % cfg.sliding_window
                klast = torch.roll(klast, shift, dims=1)
                vlast = torch.roll(vlast, shift, dims=1)
            new_cache = {"k": klast, "v": vlast}
    else:
        out = attn_lib.attention_causal(q, k, v, chunk_q=_pick_chunk(S),
                                        chunk_kv=_pick_chunk(S))
        if mode == "prefill":
            new_cache = {"k": k, "v": v}
    return reduce_from_model(torch.matmul(out.reshape(B, S, nh * hd),
                                          p["wo"]), tp), new_cache


def _apply_layer(cfg, p, x, positions, *, mixer: str, ffn: str,
                 mode: str = "train", cache=None, clen=None, pool=None,
                 pages=None, n_valid=None, moe_per_lane: bool = False,
                 tp=None):
    """-> (x, the layer's new cache or None, router aux loss or None)."""
    h = apply_norm(cfg, p["norm1"], x)
    if mixer == "mamba":
        mix, new_cache = ssm_lib.apply_mamba(cfg, p["mamba"], h, state=cache,
                                             mode=mode, n_valid=n_valid)
    else:
        mix, new_cache = _attn_layer(cfg, p["attn"], h, positions,
                                     mixer=mixer, mode=mode, cache=cache,
                                     clen=clen, pool=pool, pages=pages,
                                     n_valid=n_valid, tp=tp)
    x = x + mix
    aux = None
    if ffn == "dense":
        x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["norm2"], x),
                          tp)
    elif ffn == "moe":
        mo, aux = moe_lib.apply_moe(cfg, p["moe"],
                                    apply_norm(cfg, p["norm2"], x),
                                    per_lane=moe_per_lane, tp=tp)
        x = x + mo
    return x, new_cache, aux


def _apply_block(cfg, pattern, bp, x, positions, bc=None, pb=None, **kw):
    """One pass over `pattern` with block params `bp`, block cache `bc` and
    block pools `pb` -> (x, the block's new cache or None, the block's aux
    loss summed from fp32 zero in layer order, or None without MoE)."""
    new_bc, aux_total = {}, None
    for i, (mixer, ffn) in enumerate(pattern):
        key = f"layer_{i}"
        x, nc, aux = _apply_layer(
            cfg, bp[key], x, positions, mixer=mixer, ffn=ffn,
            cache=None if bc is None else bc[key],
            pool=None if pb is None else pb.get(key), **kw)
        if nc is not None:
            new_bc[key] = nc
        if aux is not None:
            aux_total = aux if aux_total is None else aux_total + aux
    return x, (new_bc or None), aux_total


def _unbind_blocks(tree):
    """[n_blocks, ...] leaves -> a function of the block index giving that
    block's tree. One unbind per stacked leaf: its backward is one stack,
    where indexing each block would zero-fill and add a full-size gradient
    per block."""
    if tree is None:
        return lambda b: None
    parts = tree_map(lambda a: a.unbind(0), tree)
    return lambda b: tree_map(lambda t: t[b], parts)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _embed(cfg, params, tokens, prefix_embeds=None, tp=None):
    """Scaled token embeddings [B,S,D], after the projected prefix when
    `prefix_embeds` is given. A vocab-split table (on the model axis) is
    looked up where this GPU holds the token's row, zeros elsewhere, and
    the rows are summed over the model group (one term each: exact)."""
    dtype = getattr(torch, cfg.dtype)
    table = params["embed"]
    if tp is not None and table.shape[0] != cfg.vocab_size:
        loc = tokens.to(torch.int64) - tp.index * table.shape[0]
        own = (loc >= 0) & (loc < table.shape[0])
        x = table[torch.where(own, loc, 0)].to(dtype)
        x = reduce_from_model(torch.where(own[..., None], x, 0), tp)
    else:
        x = table[tokens.to(torch.int64)].to(dtype)
    # a device fill, not a host copy: a CUDA graph capture runs this
    x = x * torch.full((), cfg.d_model ** 0.5, dtype=dtype, device=x.device)
    if prefix_embeds is not None:
        pref = mm_lib.project_prefix(params["frontend"], prefix_embeds, dtype)
        x = torch.cat([pref, x], dim=1)
    return x


def forward(cfg, params, tokens, *, mode: str = "train", cache=None,
            n_valid=None, pools=None, prefix_embeds=None,
            moe_per_lane: bool = False, tp=None):
    """-> (hidden [B,S',D], new_cache, aux): aux is the router's
    load-balance loss summed over the MoE layers (fp32 0 without them).

    mode="train": full causal pass, no cache (new_cache None).
    mode="prefill": full pass, builds the cache (len = S').
    mode="decode": tokens [B,1]; requires cache.
    mode="chunk": tokens [B,T] — a fixed-shape prefill chunk extending the
    cache at positions [len, len+T); only the first ``n_valid`` tokens
    (scalar or per lane) are real, the tail is length masking for ragged
    prompts. ``len`` advances by n_valid.

    ``prefix_embeds`` [B, P, d_embed] (train / prefill, frontend archs):
    projected and prepended to the token embeddings, so S' = P + S.

    ``pools`` (paged KV): {"blocks"/"tail": {layer_i: {"k","v": [...,
    n_pages, page, KVH, hd]}}} global page pools for full-attention
    layers; the per-lane page tables ride in ``cache["pages"]`` [B, n_pp].
    With pools, those layers return {"new_k","new_v"} rows in new_cache
    instead of a written cache — the caller owns the pool scatter
    (serve/paged.py).

    ``moe_per_lane``: each of the B lanes routes and dispatches its MoE
    tokens on its own, with the capacity of its S tokens (the serving
    engine's steps, as the reference's engine vmaps a batch-1 forward
    over its slots); otherwise the call's B*S tokens share the capacity.

    ``tp``: this GPU's share of a node split over the model axis
    (``params`` its slices; in a serving mode ``cache`` and ``pools`` its
    own, ``init_cache(..., tp=)``). An arch the axis does not carry
    raises, naming its ROADMAP.md item."""
    if tp is not None and mode != "train":
        check_model_parallel(cfg, tp.size)
    x = _embed(cfg, params, tokens, prefix_embeds
               if mode in ("train", "prefill") else None, tp)
    B, S = x.shape[0], x.shape[1]
    clen = pages = None
    if mode in ("decode", "chunk"):
        clen = cache["len"]
        pages = cache.get("pages")
        positions = per_lane(clen, B, x.device)[:, None] + \
            torch.arange(S, device=x.device)
    else:
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    kw = dict(mode=mode, clen=clen, pages=pages, n_valid=n_valid,
              moe_per_lane=moe_per_lane, tp=tp)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = {}
    if cfg.n_full_blocks:
        bp = _unbind_blocks(params["blocks"])
        bc = _unbind_blocks(None if cache is None else cache.get("blocks"))
        pb = _unbind_blocks(None if pools is None else pools.get("blocks"))
        outs = []
        for b in range(cfg.n_full_blocks):
            x, nc, aux = _apply_block(cfg, cfg.pattern, bp(b), x, positions,
                                      bc(b), pb(b), **kw)
            outs.append(nc)
            if aux is not None:
                aux_total = aux_total + aux
        if mode != "train":
            new_cache["blocks"] = tree_map(lambda *xs: torch.stack(xs),
                                           *outs)
    if cfg.tail_pattern:
        x, nc, aux = _apply_block(
            cfg, cfg.tail_pattern, params["tail"], x, positions,
            None if cache is None else cache.get("tail"),
            None if pools is None else pools.get("tail"), **kw)
        if aux is not None:
            aux_total = aux_total + aux
        if mode != "train":
            new_cache["tail"] = nc
    x = apply_norm(cfg, params["final_norm"], x)
    if mode == "train":
        return x, None, aux_total
    if mode == "prefill":
        new_cache["len"] = torch.full((), S, dtype=torch.int32,
                                      device=x.device)
    else:
        adv = n_valid if mode == "chunk" else S
        new_cache["len"] = (clen + adv).to(torch.int32)
    if pages is not None:
        new_cache["pages"] = pages
    return x, new_cache, aux_total


def logits_head(cfg, params, hidden, tp=None):
    """hidden [B,S,D] -> fp32 logits [B,S,V]. A vocab-split table (on the
    model axis `tp`) gives this GPU's [B,S,V/K] rows, all-gathered along V
    over the model group in model index order, so that every GPU holds
    the whole row (a whole table needs no gather)."""
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = torch.einsum("bsd,vd->bsv", hidden, table).to(torch.float32)
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    if tp is not None and table.shape[0] != cfg.vocab_size:
        logits = gather_from_model(logits.movedim(-1, 0), tp).movedim(0, -1)
    return logits


def train_loss(cfg, params, hidden, aux, targets, tp=None):
    """hidden [B,S',D] after the final norm, the router's aux loss and
    targets [B,S] -> mean chunked CE over the text positions +
    router_aux_coef * aux. A vocab-split table (on the model axis `tp`)
    takes the vocab-parallel CE; a whole one the CE of one GPU, the same
    on every GPU of the node."""
    S = targets.shape[1]
    hidden = hidden[:, -S:]   # drop the frontend prefix positions
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    split = tp if table.shape[0] != cfg.vocab_size else None
    ce = chunked_softmax_xent(hidden, table, targets,
                              softcap=cfg.logit_softcap, tp=split)
    if cfg.moe is None:
        return ce
    return ce + cfg.moe.router_aux_coef * aux


def loss_fn(cfg, params, batch, tp=None):
    """batch: tokens [B,S], targets [B,S], optional prefix_embeds -> mean
    chunked CE over the text positions + router_aux_coef * aux (on the
    model axis `tp`: this GPU's slices, every GPU of the node the loss)."""
    hidden, _, aux = forward(cfg, params, batch["tokens"],
                             prefix_embeds=batch.get("prefix_embeds"), tp=tp)
    return train_loss(cfg, params, hidden, aux, batch["targets"], tp)


def node_losses(cfg, params, batch, tp=None):
    """Every node's :func:`loss_fn` for node-stacked `params` and `batch`
    (leaves [n_nodes, ...]) -> [n_nodes], as ``vmap(loss_fn)`` gives it,
    with the scanned blocks taken out of the node vmap: the embedding,
    then each block vmapped across the nodes, then the tail, final norm
    and CE vmapped per node. Every operation sees the operands it sees
    under ``vmap(loss_fn)``, so with ``cfg.remat`` off the losses and
    their gradients are bitwise ``vmap(loss_fn)``'s.

    With ``cfg.remat`` on (the reference's ``jax.checkpoint(scan_body)``
    in training), each block runs under a non-reentrant
    ``torch.utils.checkpoint``: the backward pass recomputes it from its
    input, and its internals are not kept. The embedding, tail and CE
    are not recomputed, as in the reference. The checkpoint wraps the
    vmapped block: one inside the vmap is refused (a tensor escapes the
    transform). The model draws no random numbers in training, so no RNG
    state is saved (``get_rng_state`` cannot run under a CUDA-graph
    capture); the recompute is the same operations on the same inputs,
    so remat on is bitwise remat off.

    On the model axis (`tp`) every GPU of a node runs this on its slices;
    the recompute replays the block's collectives in the backward pass,
    in the same order on every GPU of the node."""
    vmap = torch.func.vmap
    x = vmap(lambda p, b: _embed(cfg, p, b["tokens"],
                                 b.get("prefix_embeds"), tp))(params, batch)
    B, S = x.shape[1], x.shape[2]
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.n_full_blocks:
        def block(bp, xb):
            xb, _, a = _apply_block(cfg, cfg.pattern, bp, xb, positions,
                                    tp=tp)
            return (xb,) if a is None else (xb, a)
        run = vmap(block)
        # one unbind per stacked leaf, as `_unbind_blocks` under the vmap
        parts = tree_map(lambda a: a.unbind(1), params["blocks"])
        for b in range(cfg.n_full_blocks):
            bp = tree_map(lambda t: t[b], parts)
            out = checkpoint(run, bp, x, use_reentrant=False,
                             preserve_rng_state=False) if cfg.remat \
                else run(bp, x)
            x = out[0]
            if len(out) > 1:
                aux = aux + out[1]

    def head(p, xh, a, b):
        if cfg.tail_pattern:
            xh, _, at = _apply_block(cfg, cfg.tail_pattern, p["tail"], xh,
                                     positions, tp=tp)
            if at is not None:
                a = a + at
        xh = apply_norm(cfg, p["final_norm"], xh)
        return train_loss(cfg, p, xh, a, b["targets"], tp)
    return vmap(head, in_dims=(0, 0, 0 if aux.dim() else None, 0))(
        params, x, aux, batch)


# ---------------------------------------------------------------------------
# nn.Module form
# ---------------------------------------------------------------------------


def _register(module: nn.Module, template, device):
    for k, v in template.items():
        if isinstance(v, ParamInfo):
            module.register_parameter(
                k, nn.Parameter(torch.empty(v.shape, device=device)))
        else:
            sub = nn.Module()
            _register(sub, v, device)
            module.add_module(k, sub)


def _param_tree(module: nn.Module, template):
    return {k: getattr(module, k) if isinstance(v, ParamInfo)
            else _param_tree(getattr(module, k), v)
            for k, v in template.items()}


class TransformerLM(nn.Module):
    """The decoder as an nn.Module; parameter names are the tree
    paths. Built on the meta device: the engine supplies every tensor
    through ``torch.func.functional_call`` (see :meth:`functional_loss`).
    With `tp` (a ``ModelShard``) it is one GPU's share of a node split
    over the model axis: its parameters are that GPU's slices
    (:func:`shard_template`)."""

    def __init__(self, cfg, device="meta", tp=None):
        super().__init__()
        self.cfg = cfg
        self.tp = tp
        if tp is None:
            self._template = param_template(cfg)
        else:
            self._template = shard_template(cfg, tp.size)
        _register(self, self._template, device)

    def param_tree(self):
        return _param_tree(self, self._template)

    def forward(self, tokens, targets):
        return loss_fn(self.cfg, self.param_tree(),
                       {"tokens": tokens, "targets": targets}, self.tp)

    def functional_loss(self, params, batch):
        """Loss of the model at the parameter tree `params` (one node's)."""
        flat = dict(zip(tree_paths(params), tree_leaves(params)))
        return torch.func.functional_call(
            self, flat, (batch["tokens"], batch["targets"]))

    def functional_node_losses(self, params, batch):
        """Every node's :meth:`functional_loss` for node-stacked `params`
        and `batch` -> [n_nodes] (:func:`node_losses`: each block
        recomputed in the backward pass under ``cfg.remat``). The
        training paths take their gradients through it
        (``core/exchange.py`` ``node_grads_fn``)."""
        return node_losses(self.cfg, params, {"tokens": batch["tokens"],
                                              "targets": batch["targets"]},
                           self.tp)

