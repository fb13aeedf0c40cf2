"""mamba2-780m [ssm] — attention-free, SSD (state-space duality); copy of
``repro/configs/mamba2_780m.py``.

Source: [arXiv:2405.21060] (Mamba-2). 48 Mamba2 blocks, d_model 1536,
ssm_state 128, head_dim 64, expand 2 (d_inner 3072 -> 48 SSD heads).
The Mamba2 block has no separate FFN (ffn="none").
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register


@register("mamba2-780m")
def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m",
        arch_type="ssm",
        source="arXiv:2405.21060 (Mamba-2)",
        n_layers=48,
        d_model=1536,
        n_heads=1,                # unused (attention-free)
        n_kv_heads=1,
        head_dim=64,
        d_ff=0,
        vocab_size=50_280,
        pattern=(("mamba", "none"),),
        norm="rmsnorm",
        act="silu",
        tie_embeddings=True,
        ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_kernel=4,
                      chunk=256, n_groups=1),
        subquadratic=True,
        max_seq_len=1_048_576,
    )
