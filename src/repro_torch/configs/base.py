"""Model configuration (``repro/configs/base.py``).

A config describes the decoder stack as a repeated *layer pattern* of
``(mixer, ffn)`` pairs, where

  mixer ∈ {"attn": global causal attention,
           "swa":  sliding-window causal attention,
           "mamba": Mamba2 SSD block}
  ffn   ∈ {"dense": (gated) MLP, "moe": top-k mixture of experts, "none"}

The stack is ``n_full_blocks`` stacked copies of the pattern (leaf arrays
carry a leading ``[n_blocks]`` dim, as the JAX package's scanned blocks
do) plus a tail for depths that are not a multiple of the pattern
(gemma3-4b: 34 = 5 x (5 swa + 1 attn) + 4 tail layers).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

Layer = Tuple[str, str]  # (mixer, ffn)

MIXERS = ("attn", "swa", "mamba")
FFNS = ("dense", "moe", "none")


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                       # per-expert hidden size
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # the reference's mesh axis for the expert dim; no effect in the port
    expert_shard_axis: Optional[str] = "model"


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4
    chunk: int = 256
    n_groups: int = 1


@dataclass(frozen=True)
class FrontendConfig:
    """A modality frontend stub: precomputed patch / frame embeddings of
    the right shape, projected into the decoder's width."""
    kind: str                       # "vision" | "audio"
    n_prefix: int                   # patches / frames prepended to the text
    d_embed: int                    # embedding dim the encoder delivers


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                  # dense | moe | ssm | hybrid | vlm | audio
    source: str                     # paper / model-card citation
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                       # dense-FFN hidden size (0 for none)
    vocab_size: int
    pattern: Tuple[Layer, ...]      # repeating unit
    head_dim: Optional[int] = None  # default d_model // n_heads
    rope_theta: float = 10_000.0
    rope_theta_local: Optional[float] = None  # swa layers' θ (gemma3: 10k)
    partial_rotary: float = 1.0     # fraction of head_dim rotated
    sliding_window: int = 1024
    qk_norm: bool = False
    norm: str = "rmsnorm"           # rmsnorm | layernorm | nonparam_ln (olmo)
    act: str = "silu"               # silu | gelu (tanh approximation)
    gated_mlp: bool = True
    tie_embeddings: bool = True
    logit_softcap: float = 0.0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    frontend: Optional[FrontendConfig] = None
    dtype: str = "bfloat16"
    remat: bool = True              # recompute each full block in backward
    subquadratic: bool = False
    big_model: bool = False
    opt_state_dtype: str = "float32"
    max_seq_len: int = 131_072

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None \
            else self.d_model // self.n_heads

    @property
    def layers(self) -> Tuple[Layer, ...]:
        reps = self.n_layers // len(self.pattern)
        tail = self.n_layers % len(self.pattern)
        return self.pattern * reps + self.pattern[:tail]

    @property
    def n_full_blocks(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def tail_pattern(self) -> Tuple[Layer, ...]:
        return self.pattern[: self.n_layers % len(self.pattern)]

    def n_params(self) -> int:
        """Total parameter count (exact, mirrors models.transformer)."""
        d, hd = self.d_model, self.resolved_head_dim
        norm_p = {"rmsnorm": d, "layernorm": 2 * d, "nonparam_ln": 0}[self.norm]
        mult = 3 if self.gated_mlp else 2
        total = self.vocab_size * d
        if not self.tie_embeddings:
            total += self.vocab_size * d
        if self.frontend is not None:
            total += self.frontend.d_embed * d
        total += norm_p
        for mixer, ffn in self.layers:
            total += norm_p
            if mixer in ("attn", "swa"):
                total += d * (self.n_heads * hd) + \
                    2 * d * (self.n_kv_heads * hd)
                total += (self.n_heads * hd) * d
                if self.qk_norm:
                    total += 2 * hd
            else:
                s = self.ssm
                d_in = s.expand * d
                n_h = d_in // s.head_dim
                conv_dim = d_in + 2 * s.n_groups * s.d_state
                total += d * (2 * d_in + 2 * s.n_groups * s.d_state + n_h)
                total += conv_dim * s.conv_kernel + 3 * n_h + d_in
                total += d_in * d
            if ffn != "none":
                total += norm_p
            if ffn == "dense":
                total += mult * d * self.d_ff
            elif ffn == "moe":
                m = self.moe
                total += m.n_experts * mult * d * m.d_ff + d * m.n_experts
        return total

    def n_active_params(self) -> int:
        """Parameters touched per token (MoE: top_k of n_experts)."""
        total = self.n_params()
        if self.moe is None:
            return total
        m = self.moe
        per_expert = (3 if self.gated_mlp else 2) * self.d_model * m.d_ff
        n_moe = sum(1 for _, f in self.layers if f == "moe")
        return total - n_moe * (m.n_experts - m.top_k) * per_expert


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    from repro_torch import configs as _c
    _c.load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> list[str]:
    from repro_torch import configs as _c
    _c.load_all()
    return sorted(_REGISTRY)


def reduced(cfg: ModelConfig, *, n_layers: int = 2, d_model: int = 256,
            n_experts: int = 4, vocab: int = 512,
            seq_cap: int = 4096) -> ModelConfig:
    """Smoke-test variant of the same family (the JAX package's
    `reduced`): the first `n_layers` of the pattern, d_model<=512, <=4
    heads; MoE keeps <=4 experts top-2 at capacity factor 4.0 (dropless at
    this scale); an SSM keeps d_state<=32 with head_dim 32 and chunk 64; a
    frontend keeps <=16 prefix rows of width d_model."""
    d_model = min(d_model, 512)
    heads = max(1, min(cfg.n_heads, 4))
    kv = max(1, min(cfg.n_kv_heads, heads))
    pattern = cfg.pattern[:max(1, min(len(cfg.pattern), n_layers))]
    changes = dict(
        n_layers=n_layers, d_model=d_model, n_heads=heads, n_kv_heads=kv,
        head_dim=d_model // heads if cfg.head_dim is not None else None,
        d_ff=min(cfg.d_ff, 4 * d_model) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, vocab), pattern=pattern,
        dtype="float32", opt_state_dtype="float32", remat=False,
        big_model=False, max_seq_len=seq_cap,
        sliding_window=min(cfg.sliding_window, 64))
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, n_experts=min(cfg.moe.n_experts, n_experts),
            top_k=min(cfg.moe.top_k, 2), d_ff=min(cfg.moe.d_ff, d_model),
            capacity_factor=4.0, expert_shard_axis=None)
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=min(cfg.ssm.d_state, 32), head_dim=32, chunk=64)
    if cfg.frontend is not None:
        changes["frontend"] = dataclasses.replace(
            cfg.frontend, n_prefix=min(cfg.frontend.n_prefix, 16),
            d_embed=d_model)
    return dataclasses.replace(cfg, **changes)
