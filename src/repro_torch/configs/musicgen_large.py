"""musicgen-large [audio] — decoder-only transformer over the 2048-entry
codec vocabulary, LayerNorm and a non-gated MLP, behind a stub audio
frontend delivering 64 frame embeddings. Source: [arXiv:2306.05284]; copy
of ``repro/configs/musicgen_large.py``."""
from repro_torch.configs.base import FrontendConfig, ModelConfig, register


@register("musicgen-large")
def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large",
        arch_type="audio",
        source="arXiv:2306.05284 (MusicGen)",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab_size=2048,
        pattern=(("attn", "dense"),),
        rope_theta=10_000.0,
        norm="layernorm",
        act="gelu",
        gated_mlp=False,           # classic transformer MLP
        tie_embeddings=False,
        frontend=FrontendConfig(kind="audio", n_prefix=64, d_embed=2048),
        subquadratic=False,
        max_seq_len=32_768,
    )
