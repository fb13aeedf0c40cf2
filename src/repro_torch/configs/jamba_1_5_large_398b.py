"""jamba-1.5-large-398b [hybrid] — Mamba + attention 1:7, MoE 16e top-2 on
every other layer. Source: [arXiv:2403.19887] (Jamba): 72 layers = 9 blocks
of 8 (attention at index 3, MoE at odd indices); 398B total params; copy of
``repro/configs/jamba_1_5_large_398b.py``."""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig, register

# Jamba block: 8 layers, attn at index 3 (1:7), MoE at odd indices (every 2nd)
PATTERN = tuple(
    ("attn" if i == 3 else "mamba", "moe" if i % 2 == 1 else "dense")
    for i in range(8)
)


@register("jamba-1.5-large-398b")
def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b",
        arch_type="hybrid",
        source="arXiv:2403.19887 (Jamba-1.5-large)",
        n_layers=72,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        head_dim=128,
        d_ff=24_576,
        vocab_size=65_536,
        pattern=PATTERN,
        rope_theta=10_000.0,
        norm="rmsnorm",
        act="silu",
        gated_mlp=True,
        tie_embeddings=False,
        moe=MoEConfig(n_experts=16, top_k=2, d_ff=24_576,
                      expert_shard_axis="data"),
        ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_kernel=4,
                      chunk=256, n_groups=1),
        subquadratic=True,        # 7/8 of layers are Mamba; attn layers seq-shard KV
        big_model=True,
        opt_state_dtype="bfloat16",
        max_seq_len=524_288,
    )
