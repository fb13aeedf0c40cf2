"""Dense decoder stack (training slice of ``repro/models/transformer.py``).

Parameters are a nested dict in the JAX package's layout: ``embed``
[V, D], ``final_norm``, and ``blocks`` whose leaves carry a leading
``[n_full_blocks]`` dim (the reference's scanned blocks), plus ``tail`` for
depths that are not a multiple of the pattern. :class:`TransformerLM` is the
same model as an ``nn.Module`` whose parameter names are the tree paths
(``blocks.layer_0.attn.wq``); the engine calls it functionally
(``torch.func.functional_call``) on one node's parameters.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (
    ParamInfo, apply_mlp, apply_norm, apply_rope, chunked_softmax_xent,
    init_from_template, mlp_template, norm_template, stack_template,
)
from repro_torch.tree import tree_leaves, tree_map, tree_paths


def _pick_chunk(s: int, cap: int = 1024) -> int:
    c = 1
    while c < cap and s % (c * 2) == 0:
        c *= 2
    return min(c, s)


def _check_dense(mixer: str, ffn: str):
    if mixer != "attn" or ffn != "dense":
        raise NotImplementedError(
            f"layer {(mixer, ffn)} is not ported (dense attention only)")


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
    _check_dense(mixer, ffn)
    return {"norm1": norm_template(cfg), "attn": attn_template(cfg),
            "norm2": norm_template(cfg), "mlp": mlp_template(cfg)}


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
# Layers
# ---------------------------------------------------------------------------


def _attn_layer(cfg, p, x, positions):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = torch.matmul(x, p["wq"]).reshape(B, S, cfg.n_heads, hd)
    k = torch.matmul(x, p["wk"]).reshape(B, S, cfg.n_kv_heads, hd)
    v = torch.matmul(x, p["wv"]).reshape(B, S, cfg.n_kv_heads, hd)
    q = apply_rope(q, positions, theta=cfg.rope_theta,
                   rot_frac=cfg.partial_rotary)
    k = apply_rope(k, positions, theta=cfg.rope_theta,
                   rot_frac=cfg.partial_rotary)
    out = attn_lib.attention_causal(q, k, v, chunk_q=_pick_chunk(S),
                                    chunk_kv=_pick_chunk(S))
    return torch.matmul(out.reshape(B, S, cfg.n_heads * hd), p["wo"])


def _apply_layer(cfg, p, x, positions):
    x = x + _attn_layer(cfg, p["attn"], apply_norm(cfg, p["norm1"], x),
                        positions)
    return x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, p["norm2"], x))


def _apply_block(cfg, pattern, bp, x, positions):
    for i, (mixer, ffn) in enumerate(pattern):
        _check_dense(mixer, ffn)
        x = _apply_layer(cfg, bp[f"layer_{i}"], x, positions)
    return x


def forward(cfg, params, tokens, *, mode: str = "train"):
    """Full causal pass -> final hidden states [B, S, D]."""
    if mode != "train":
        raise NotImplementedError(f"forward mode {mode!r} is not ported "
                                  "(training only)")
    dtype = getattr(torch, cfg.dtype)
    x = params["embed"][tokens.to(torch.int64)].to(dtype)
    # a device fill, not a host copy: a CUDA graph capture runs this
    x = x * torch.full((), cfg.d_model ** 0.5, dtype=dtype, device=x.device)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    if cfg.n_full_blocks:
        # one unbind per stacked leaf: its backward is one stack, where
        # indexing each block would zero-fill and add a full-size gradient
        # per block
        blocks = tree_map(lambda a: a.unbind(0), params["blocks"])
        for b in range(cfg.n_full_blocks):
            bp = tree_map(lambda t: t[b], blocks)
            x = _apply_block(cfg, cfg.pattern, bp, x, positions)
    if cfg.tail_pattern:
        x = _apply_block(cfg, cfg.tail_pattern, params["tail"], x, positions)
    return apply_norm(cfg, params["final_norm"], x)


def loss_fn(cfg, params, batch):
    """batch: tokens [B,S], targets [B,S] -> mean chunked-CE loss."""
    hidden = forward(cfg, params, batch["tokens"])
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
    """The dense decoder as an nn.Module; parameter names are the tree
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

