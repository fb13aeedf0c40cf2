"""qwen3-moe-30b-a3b [moe] — 128 experts top-8, per-expert d_ff 768, QK-norm.
Source: [hf:Qwen/Qwen3-30B-A3B] (48 layers, d_model 2048, 32 q / 4 kv heads,
head_dim 128, vocab 151936); copy of
``repro/configs/qwen3_moe_30b_a3b.py``."""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


@register("qwen3-moe-30b-a3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        arch_type="moe",
        source="hf:Qwen/Qwen3-30B-A3B",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        head_dim=128,
        d_ff=0,                   # every FFN is MoE
        vocab_size=151_936,
        pattern=(("attn", "moe"),),
        rope_theta=1_000_000.0,
        qk_norm=True,
        norm="rmsnorm",
        act="silu",
        gated_mlp=True,
        tie_embeddings=False,
        moe=MoEConfig(n_experts=128, top_k=8, d_ff=768,
                      expert_shard_axis="model"),
        subquadratic=False,
        opt_state_dtype="bfloat16",
        max_seq_len=32_768,
    )
