"""Decoder stack (``repro/models/transformer.py``): dense attention and
Mamba2 layers, for training and for serving.

Parameters are a nested dict in the JAX package's layout: ``embed``
[V, D], ``final_norm``, and ``blocks`` whose leaves carry a leading
``[n_full_blocks]`` dim (the reference's scanned blocks), plus ``tail`` for
depths that are not a multiple of the pattern. :class:`TransformerLM` is the
same model as an ``nn.Module`` whose parameter names are the tree paths
(``blocks.layer_0.attn.wq``); the engine calls it functionally
(``torch.func.functional_call``) on one node's parameters.

Entry points:
  param_template(cfg) / init_params(gen, cfg, device)
  forward(cfg, params, tokens, mode=...)     train / prefill / decode / chunk
  loss_fn(cfg, params, batch)                chunked-CE training loss
  init_cache(cfg, batch, cache_size)         KV / SSM cache tree
  logits_head(cfg, params, hidden)           fp32 logits

A cache's leaves carry the batch on their first axis after the stacked
block axis (``blocks`` leaves [n_blocks, B, ...], ``tail`` leaves [B, ...]),
and its ``len`` is a scalar or one length per lane [B]: the serving engine
runs its slots as one batch where the reference vmaps a batch-1 call.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from repro_torch.models import attention as attn_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (
    ParamInfo, apply_mlp, apply_norm, apply_rope, chunked_softmax_xent,
    init_from_template, mlp_template, norm_template, per_lane,
    stack_template,
)
from repro_torch.tree import tree_leaves, tree_map, tree_paths


def _pick_chunk(s: int, cap: int = 1024) -> int:
    c = 1
    while c < cap and s % (c * 2) == 0:
        c *= 2
    return min(c, s)


def _check_layer(mixer: str, ffn: str):
    if mixer not in ("attn", "mamba") or ffn not in ("dense", "none"):
        raise NotImplementedError(
            f"layer {(mixer, ffn)} is not ported (attn / mamba mixers, "
            "dense / none ffn)")


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
    return t


def layer_template(cfg, mixer: str, ffn: str):
    _check_layer(mixer, ffn)
    t: Dict[str, Any] = {"norm1": norm_template(cfg)}
    if mixer == "attn":
        t["attn"] = attn_template(cfg)
    else:
        t["mamba"] = ssm_lib.mamba_template(cfg)
    if ffn == "dense":
        t["norm2"] = norm_template(cfg)
        t["mlp"] = mlp_template(cfg)
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
    return t


def init_params(gen: torch.Generator, cfg, device):
    return init_from_template(gen, param_template(cfg),
                              getattr(torch, cfg.dtype), device)


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------


def _layer_cache(cfg, mixer: str, batch: int, cache_size: int, dtype,
                 device):
    if mixer == "attn":
        shape = (batch, cache_size, cfg.n_kv_heads, cfg.resolved_head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    return ssm_lib.init_mamba_state(cfg, batch, dtype, device)


def init_cache(cfg, batch: int, cache_size: int, dtype=None, device="cpu"):
    dtype = dtype or getattr(torch, cfg.dtype)
    cache: Dict[str, Any] = {"len": torch.zeros((), dtype=torch.int32,
                                                device=device)}
    if cfg.n_full_blocks > 0:
        one = {f"layer_{i}": _layer_cache(cfg, mx, batch, cache_size, dtype,
                                          device)
               for i, (mx, _) in enumerate(cfg.pattern)}
        cache["blocks"] = tree_map(
            lambda x: x.expand((cfg.n_full_blocks,) + x.shape).clone(), one)
    if cfg.tail_pattern:
        cache["tail"] = {
            f"layer_{i}": _layer_cache(cfg, mx, batch, cache_size, dtype,
                                       device)
            for i, (mx, _) in enumerate(cfg.tail_pattern)}
    return cache


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def _attn_layer(cfg, p, x, positions, *, mode: str = "train", cache=None,
                clen=None, pool=None, pages=None):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = torch.matmul(x, p["wq"]).reshape(B, S, cfg.n_heads, hd)
    k = torch.matmul(x, p["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
    v = torch.matmul(x, p["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
    q = apply_rope(q, positions, theta=cfg.rope_theta,
                   rot_frac=cfg.partial_rotary)
    k = apply_rope(k, positions, theta=cfg.rope_theta,
                   rot_frac=cfg.partial_rotary)
    new_cache = None
    if mode in ("decode", "chunk"):
        # paged: reconstruct the CONTIGUOUS cache from the lanes' page
        # tables (an exact gather — attention below is bitwise the dense
        # path), attend on the copy, and hand the new k/v rows back for
        # the engine to scatter into the pools
        if pool is not None:
            kc = attn_lib.gather_pages(pool["k"], pages)
            vc = attn_lib.gather_pages(pool["v"], pages)
        else:
            kc, vc = cache["k"], cache["v"]
        if mode == "decode":
            kc, vc = _cache_write(kc, k, clen), _cache_write(vc, v, clen)
            out = attn_lib.attention_decode(q, kc, vc, clen + 1)
        else:   # chunk: S tokens at positions clen..clen+S-1, then attend
            kc = _cache_write_chunk(kc, k, clen)
            vc = _cache_write_chunk(vc, v, clen)
            out = attn_lib.attention_chunk_decode(q, kc, vc, clen)
        new_cache = {"new_k": k, "new_v": v} if pool is not None \
            else {"k": kc, "v": vc}
    else:
        out = attn_lib.attention_causal(q, k, v, chunk_q=_pick_chunk(S),
                                        chunk_kv=_pick_chunk(S))
        if mode == "prefill":
            new_cache = {"k": k, "v": v}
    return torch.matmul(out.reshape(B, S, cfg.n_heads * hd), p["wo"]), \
        new_cache


def _apply_layer(cfg, p, x, positions, *, mixer: str, ffn: str,
                 mode: str = "train", cache=None, clen=None, pool=None,
                 pages=None, n_valid=None):
    h = apply_norm(cfg, p["norm1"], x)
    if mixer == "mamba":
        mix, new_cache = ssm_lib.apply_mamba(cfg, p["mamba"], h, state=cache,
                                             mode=mode, n_valid=n_valid)
    else:
        mix, new_cache = _attn_layer(cfg, p["attn"], h, positions, mode=mode,
                                     cache=cache, clen=clen, pool=pool,
                                     pages=pages)
    x = x + mix
    if ffn == "dense":
        x = x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["norm2"], x))
    return x, new_cache


def _apply_block(cfg, pattern, bp, x, positions, bc=None, pb=None, **kw):
    """One pass over `pattern` with block params `bp`, block cache `bc` and
    block pools `pb` -> (x, the block's new cache or None)."""
    new_bc = {}
    for i, (mixer, ffn) in enumerate(pattern):
        _check_layer(mixer, ffn)
        key = f"layer_{i}"
        x, nc = _apply_layer(
            cfg, bp[key], x, positions, mixer=mixer, ffn=ffn,
            cache=None if bc is None else bc[key],
            pool=None if pb is None else pb.get(key), **kw)
        if nc is not None:
            new_bc[key] = nc
    return x, (new_bc or None)


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


def forward(cfg, params, tokens, *, mode: str = "train", cache=None,
            n_valid=None, pools=None):
    """-> (hidden [B,S,D], new_cache). The reference's third output, the
    MoE router's aux loss, has no counterpart: the port has no MoE layer.

    mode="train": full causal pass, no cache (new_cache None).
    mode="prefill": full pass, builds the cache (len = S).
    mode="decode": tokens [B,1]; requires cache.
    mode="chunk": tokens [B,T] — a fixed-shape prefill chunk extending the
    cache at positions [len, len+T); only the first ``n_valid`` tokens
    (scalar or per lane) are real, the tail is length masking for ragged
    prompts. ``len`` advances by n_valid.

    ``pools`` (paged KV): {"blocks"/"tail": {layer_i: {"k","v": [...,
    n_pages, page, KVH, hd]}}} global page pools for full-attention
    layers; the per-lane page tables ride in ``cache["pages"]`` [B, n_pp].
    With pools, those layers return {"new_k","new_v"} rows in new_cache
    instead of a written cache — the caller owns the pool scatter
    (serve/paged.py)."""
    dtype = getattr(torch, cfg.dtype)
    x = params["embed"][tokens.to(torch.int64)].to(dtype)
    # a device fill, not a host copy: a CUDA graph capture runs this
    x = x * torch.full((), cfg.d_model ** 0.5, dtype=dtype, device=x.device)
    B, S = x.shape[0], x.shape[1]
    clen = pages = None
    if mode in ("decode", "chunk"):
        clen = cache["len"]
        pages = cache.get("pages")
        positions = per_lane(clen, B, x.device)[:, None] + \
            torch.arange(S, device=x.device)
    else:
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    kw = dict(mode=mode, clen=clen, pages=pages, n_valid=n_valid)
    new_cache = {}
    if cfg.n_full_blocks:
        bp = _unbind_blocks(params["blocks"])
        bc = _unbind_blocks(None if cache is None else cache.get("blocks"))
        pb = _unbind_blocks(None if pools is None else pools.get("blocks"))
        outs = []
        for b in range(cfg.n_full_blocks):
            x, nc = _apply_block(cfg, cfg.pattern, bp(b), x, positions,
                                 bc(b), pb(b), **kw)
            outs.append(nc)
        if mode != "train":
            new_cache["blocks"] = tree_map(lambda *xs: torch.stack(xs),
                                           *outs)
    if cfg.tail_pattern:
        x, nc = _apply_block(
            cfg, cfg.tail_pattern, params["tail"], x, positions,
            None if cache is None else cache.get("tail"),
            None if pools is None else pools.get("tail"), **kw)
        if mode != "train":
            new_cache["tail"] = nc
    x = apply_norm(cfg, params["final_norm"], x)
    if mode == "train":
        return x, None
    if mode == "prefill":
        new_cache["len"] = torch.full((), S, dtype=torch.int32,
                                      device=x.device)
    else:
        adv = n_valid if mode == "chunk" else S
        new_cache["len"] = (clen + adv).to(torch.int32)
    if pages is not None:
        new_cache["pages"] = pages
    return x, new_cache


def logits_head(cfg, params, hidden):
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    logits = torch.einsum("bsd,vd->bsv", hidden, table).to(torch.float32)
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def loss_fn(cfg, params, batch):
    """batch: tokens [B,S], targets [B,S] -> mean chunked-CE loss."""
    hidden, _ = forward(cfg, params, batch["tokens"])
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return chunked_softmax_xent(hidden, table, batch["targets"],
                                softcap=cfg.logit_softcap)


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
    through ``torch.func.functional_call`` (see :meth:`functional_loss`)."""

    def __init__(self, cfg, device="meta"):
        super().__init__()
        self.cfg = cfg
        self._template = param_template(cfg)
        _register(self, self._template, device)

    def param_tree(self):
        return _param_tree(self, self._template)

    def forward(self, tokens, targets):
        return loss_fn(self.cfg, self.param_tree(),
                       {"tokens": tokens, "targets": targets})

    def functional_loss(self, params, batch):
        """Loss of the model at the parameter tree `params` (one node's)."""
        flat = dict(zip(tree_paths(params), tree_leaves(params)))
        return torch.func.functional_call(
            self, flat, (batch["tokens"], batch["targets"]))

