"""Model configuration: the dense and Mamba2 slice of
``repro/configs/base.py``.

A config describes the decoder stack as a repeated *layer pattern* of
``(mixer, ffn)`` pairs; the port runs ``("attn", "dense")`` and
``("mamba", "none")`` layers. The stack is ``n_full_blocks`` stacked copies
of the pattern (leaf arrays carry a leading ``[n_blocks]`` dim, as the JAX
package's scanned blocks do).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

Layer = Tuple[str, str]  # (mixer, ffn)


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4
    chunk: int = 256
    n_groups: int = 1


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                  # dense | ssm
    source: str                     # paper / model-card citation
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    pattern: Tuple[Layer, ...]      # repeating unit
    head_dim: Optional[int] = None  # default d_model // n_heads
    rope_theta: float = 10_000.0
    partial_rotary: float = 1.0     # fraction of head_dim rotated
    sliding_window: int = 1024
    norm: str = "rmsnorm"           # rmsnorm | layernorm | nonparam_ln (olmo)
    act: str = "silu"               # silu | gelu (tanh approximation)
    gated_mlp: bool = True
    tie_embeddings: bool = True
    logit_softcap: float = 0.0
    ssm: Optional[SSMConfig] = None
    dtype: str = "bfloat16"
    remat: bool = True              # no effect in the port (eager autograd)
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
        total = self.vocab_size * d
        if not self.tie_embeddings:
            total += self.vocab_size * d
        total += norm_p
        for mixer, ffn in self.layers:
            if (mixer, ffn) not in (("attn", "dense"), ("mamba", "none")):
                raise NotImplementedError(f"layer {(mixer, ffn)} not ported")
            total += norm_p
            if mixer == "attn":
                total += norm_p
                total += d * (self.n_heads * hd) + \
                    2 * d * (self.n_kv_heads * hd)
                total += (self.n_heads * hd) * d
                total += (3 if self.gated_mlp else 2) * d * self.d_ff
            else:
                s = self.ssm
                d_in = s.expand * d
                n_h = d_in // s.head_dim
                conv_dim = d_in + 2 * s.n_groups * s.d_state
                total += d * (2 * d_in + 2 * s.n_groups * s.d_state + n_h)
                total += conv_dim * s.conv_kernel + 3 * n_h + d_in
                total += d_in * d
        return total

    def n_active_params(self) -> int:
        """Parameters touched per token; every ported layer is dense, so
        all of them."""
        return self.n_params()


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


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
        raise KeyError(f"unknown arch {name!r}; ported: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> list[str]:
    from repro_torch import configs as _c
    _c.load_all()
    return sorted(_REGISTRY)


def reduced(cfg: ModelConfig, *, n_layers: int = 2, d_model: int = 256,
            vocab: int = 512, seq_cap: int = 4096) -> ModelConfig:
    """Smoke-test variant of the same family (the JAX package's `reduced`
    for dense and SSM configs): <=2 layers by default, d_model<=512, <=4
    heads; an SSM keeps d_state<=32 with head_dim 32 and chunk 64."""
    d_model = min(d_model, 512)
    heads = max(1, min(cfg.n_heads, 4))
    kv = max(1, min(cfg.n_kv_heads, heads))
    pattern = cfg.pattern[:max(1, min(len(cfg.pattern), n_layers))]
    ssm = None if cfg.ssm is None else dataclasses.replace(
        cfg.ssm, d_state=min(cfg.ssm.d_state, 32), head_dim=32, chunk=64)
    return dataclasses.replace(
        cfg, n_layers=n_layers, d_model=d_model, n_heads=heads,
        n_kv_heads=kv,
        head_dim=d_model // heads if cfg.head_dim is not None else None,
        d_ff=min(cfg.d_ff, 4 * d_model) if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, vocab), pattern=pattern,
        dtype="float32", opt_state_dtype="float32", remat=False,
        big_model=False, max_seq_len=seq_cap,
        sliding_window=min(cfg.sliding_window, 64), ssm=ssm)
