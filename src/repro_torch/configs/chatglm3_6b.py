"""chatglm3-6b [dense] — partial RoPE (half of each head dim rotated),
strong GQA (2 KV heads). Source: [arXiv:2406.12793]; copy of
``repro/configs/chatglm3_6b.py``."""
from repro_torch.configs.base import ModelConfig, register


@register("chatglm3-6b")
def config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b",
        arch_type="dense",
        source="arXiv:2406.12793 (ChatGLM)",
        n_layers=28,
        d_model=4096,
        n_heads=32,
        n_kv_heads=2,
        d_ff=13_696,
        vocab_size=65_024,
        pattern=(("attn", "dense"),),
        rope_theta=10_000.0,
        partial_rotary=0.5,
        norm="rmsnorm",
        act="silu",
        gated_mlp=True,
        tie_embeddings=False,
        subquadratic=False,
        max_seq_len=32_768,
    )
