"""transformer-wmt [dense] — the paper's own large NMT transformer, as a
decoder-only equivalent of Transformer-big (d_model 1024, 16 heads, d_ff
4096); copy of ``repro/configs/transformer_wmt.py``."""
from repro_torch.configs.base import ModelConfig, register


@register("transformer-wmt")
def config() -> ModelConfig:
    return ModelConfig(
        name="transformer-wmt",
        arch_type="dense",
        source="paper §5 / arXiv:1706.03762 (Transformer-big)",
        n_layers=12,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=4096,
        vocab_size=32_768,
        pattern=(("attn", "dense"),),
        rope_theta=10_000.0,
        norm="layernorm",
        act="gelu",
        gated_mlp=False,
        tie_embeddings=True,
        subquadratic=False,
        max_seq_len=4096,
    )
