"""Analytic FLOP / HBM-byte model of a training superstep and of a serving
step (counterpart of ``repro/roofline/analytic.py``; the scheduler's cost
model, ``sched/cost.py``, reads the training half).

Conventions (bf16 params/activations unless configured otherwise):
  train superstep (per node, x H local steps):
    flops  = (6 + 2*remat) * N_active * tokens + attention term + CE head term
    bytes  = params (fwd read + bwd read + remat re-read) + grad write/read
             + momentum read/write + param write + activation checkpoints rw
             + attention KV traffic
  serve:
    prefill flops = 2 * N_active * tokens + causal attention term
    decode flops  = 2 * N_active * B + attention over the cache
    decode bytes  = active params + the whole KV cache (or SSM state)

The formulas are the reference's, term for term, so the same config gives
the same counts: sliding-window layers attend over the window, Mamba2
layers add the SSD scan's term, and a mixture of experts counts its
active parameters.
"""
from __future__ import annotations

from repro_torch.configs.base import InputShape, ModelConfig


def _dtype_bytes(name: str) -> int:
    return {"bfloat16": 2, "float32": 4, "float16": 2}[name]


def _attn_layer_counts(cfg: ModelConfig):
    """(n_global, n_swa, n_mamba) layers."""
    g = sum(1 for mx, _ in cfg.layers if mx == "attn")
    s = sum(1 for mx, _ in cfg.layers if mx == "swa")
    m = sum(1 for mx, _ in cfg.layers if mx == "mamba")
    return g, s, m


def attention_flops_per_token(cfg: ModelConfig, ctx_len: int) -> float:
    """QK^T + PV fwd flops per token (full ctx for global, window for swa)."""
    g, s, m = _attn_layer_counts(cfg)
    hd = cfg.resolved_head_dim
    width = cfg.n_heads * hd
    f = g * 4.0 * ctx_len * width
    f += s * 4.0 * min(cfg.sliding_window, ctx_len) * width
    # SSD: intra-chunk scores and outputs over the chunk, state update
    # and query over d_state
    if m and cfg.ssm is not None:
        d_in = cfg.ssm.expand * cfg.d_model
        nh = d_in // cfg.ssm.head_dim
        f += m * (4.0 * cfg.ssm.chunk * nh * cfg.ssm.head_dim +
                  6.0 * d_in * cfg.ssm.d_state)
    return f


def train_flops(cfg: ModelConfig, shape: InputShape, H: int = 2,
                remat: bool = True) -> float:
    """Global flops for one swarm superstep (all nodes, H local steps)."""
    tokens = shape.global_batch * shape.seq_len  # split across nodes x H
    n_body = cfg.n_active_params() - cfg.vocab_size * cfg.d_model * (
        1 if cfg.tie_embeddings else 2)
    body_mult = 8.0 if remat else 6.0          # fwd+bwd(2x)+remat re-fwd
    f = body_mult * n_body * tokens
    # LM head / CE (never rematted): fwd + bwd(2x)
    f += 6.0 * cfg.vocab_size * cfg.d_model * tokens
    # attention (quadratic part, not in 6N): fwd + 2x bwd (+ remat refwd)
    att_mult = 4.0 if remat else 3.0
    f += att_mult * attention_flops_per_token(cfg, shape.seq_len) * tokens
    return f


def train_bytes_full(cfg: ModelConfig, shape: InputShape, n_nodes: int,
                     H: int = 2, remat: bool = True) -> float:
    """Global HBM bytes for one superstep (all n_nodes x H local steps).

    Per local step & node: read active params fwd + bwd (+ remat re-read),
    write+read grads, rw momentum, write params."""
    pb = _dtype_bytes(cfg.dtype)
    ob = _dtype_bytes(cfg.opt_state_dtype)
    P_active = cfg.n_active_params() * pb
    P = cfg.n_params() * pb
    M = cfg.n_params() * ob
    per_step = (3 if remat else 2) * P_active + 2 * P_active + 2 * M + P
    param_traffic = n_nodes * H * per_step
    # activations: checkpoint x per layer (write + read) + recompute temps
    tokens = shape.global_batch * shape.seq_len
    act = tokens * cfg.d_model * pb * cfg.n_layers * (4 if remat else 6)
    # attention KV traffic (reads of K/V per query chunk)
    g, s, _ = _attn_layer_counts(cfg)
    hd = cfg.resolved_head_dim
    kv_per_tok = 2 * cfg.n_kv_heads * hd * pb
    att = tokens * (g * 2 + s * 2) * kv_per_tok  # write + re-read once
    # gossip averaging: read both models + write (3P per node)
    gossip = n_nodes * 3 * P
    return param_traffic + act + att + gossip


def serve_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """Flops of one prefill over `shape`, or of one decode step over a
    cache of shape.seq_len positions for shape.global_batch sequences."""
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        f = 2.0 * cfg.n_active_params() * tokens
        f += attention_flops_per_token(cfg, shape.seq_len) * tokens / 2  # causal
        return f
    # decode: one token per sequence over a seq_len cache
    B = shape.global_batch
    f = 2.0 * cfg.n_active_params() * B
    g, s, m = _attn_layer_counts(cfg)
    hd = cfg.resolved_head_dim
    q_width = cfg.n_heads * hd
    f += B * (g * 4.0 * shape.seq_len * q_width +
              s * 4.0 * min(cfg.sliding_window, shape.seq_len) * q_width)
    if m and cfg.ssm is not None:
        d_in = cfg.ssm.expand * cfg.d_model
        f += B * m * 6.0 * d_in * cfg.ssm.d_state
    return f


def kv_cache_bytes(cfg: ModelConfig, shape: InputShape) -> float:
    """Bytes of the serving cache: K and V of every attention layer (a
    sliding-window layer holds its window), plus each Mamba2 layer's SSM
    state and conv tail."""
    g, s, m = _attn_layer_counts(cfg)
    hd = cfg.resolved_head_dim
    per_tok = 2 * cfg.n_kv_heads * hd * _dtype_bytes(cfg.dtype)
    total = shape.global_batch * (
        g * shape.seq_len * per_tok +
        s * min(cfg.sliding_window, shape.seq_len) * per_tok)
    if m and cfg.ssm is not None:
        d_in = cfg.ssm.expand * cfg.d_model
        nh = d_in // cfg.ssm.head_dim
        total += shape.global_batch * m * (
            nh * cfg.ssm.head_dim * cfg.ssm.d_state + 3 * d_in
        ) * _dtype_bytes(cfg.dtype)
    return total


def serve_bytes(cfg: ModelConfig, shape: InputShape) -> float:
    """HBM bytes of one prefill or decode step: the active parameters read
    once, the activations of a prefill, and the cache."""
    pb = _dtype_bytes(cfg.dtype)
    P_active = cfg.n_active_params() * pb
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        act = tokens * cfg.d_model * pb * cfg.n_layers * 4
        return P_active + act + kv_cache_bytes(cfg, shape)
    # decode reads the active params once and the whole cache; a batch
    # whose B * top_k reaches the expert count reads every expert table
    if cfg.moe is not None and \
            shape.global_batch * cfg.moe.top_k >= cfg.moe.n_experts:
        P_active = cfg.n_params() * pb
    return P_active + kv_cache_bytes(cfg, shape)
