"""olmo-1b [dense] — non-parametric LayerNorm. Source: [arXiv:2402.00838];
copy of ``repro/configs/olmo_1b.py``."""
from repro_torch.configs.base import ModelConfig, register


@register("olmo-1b")
def config() -> ModelConfig:
    return ModelConfig(
        name="olmo-1b",
        arch_type="dense",
        source="arXiv:2402.00838 (OLMo)",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=8192,
        vocab_size=50_304,
        pattern=(("attn", "dense"),),
        rope_theta=10_000.0,
        norm="nonparam_ln",       # OLMo: LayerNorm without affine params
        act="silu",
        gated_mlp=True,
        tie_embeddings=True,
        subquadratic=False,
        max_seq_len=32_768,
    )
