"""paligemma-3b [vlm] — a gemma-2b-style decoder (MQA, head_dim 256) behind
a stub vision frontend delivering 256 patch embeddings. Source:
[arXiv:2407.07726]; copy of ``repro/configs/paligemma_3b.py``."""
from repro_torch.configs.base import FrontendConfig, ModelConfig, register


@register("paligemma-3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b",
        arch_type="vlm",
        source="arXiv:2407.07726 (PaliGemma)",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        head_dim=256,
        d_ff=16_384,
        vocab_size=257_216,
        pattern=(("attn", "dense"),),
        rope_theta=10_000.0,
        norm="rmsnorm",
        act="gelu",
        gated_mlp=True,
        tie_embeddings=True,
        frontend=FrontendConfig(kind="vision", n_prefix=256, d_embed=2048),
        subquadratic=False,
        max_seq_len=32_768,
    )
