"""granite-moe-3b-a800m [moe] — 40 experts top-8, per-expert d_ff 512.
Source: [hf:ibm-granite/granite-3.0-1b-a400m-base] family (3b-a800m); copy
of ``repro/configs/granite_moe_3b_a800m.py``."""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


@register("granite-moe-3b-a800m")
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m",
        arch_type="moe",
        source="hf:ibm-granite/granite-3.0-1b-a400m-base (3b-a800m)",
        n_layers=32,
        d_model=1536,
        n_heads=24,
        n_kv_heads=8,
        d_ff=0,                    # every FFN is MoE
        vocab_size=49_155,
        pattern=(("attn", "moe"),),
        rope_theta=10_000.0,
        norm="rmsnorm",
        act="silu",
        gated_mlp=True,
        tie_embeddings=True,
        moe=MoEConfig(n_experts=40, top_k=8, d_ff=512,
                      expert_shard_axis=None),
        subquadratic=False,
        max_seq_len=32_768,
    )
