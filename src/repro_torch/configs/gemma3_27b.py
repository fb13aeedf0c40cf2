"""gemma3-27b [dense] — 5:1 local:global, QK-norm. Source:
[hf:google/gemma-3-1b-pt] family (27b card: 62 layers, d_model 5376, 32 q /
16 kv heads, head_dim 128, d_ff 21504, vocab 262144); copy of
``repro/configs/gemma3_27b.py``."""
from repro_torch.configs.base import ModelConfig, register

PATTERN = (("swa", "dense"),) * 5 + (("attn", "dense"),)


@register("gemma3-27b")
def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b",
        arch_type="dense",
        source="hf:google/gemma-3-1b-pt (27b variant)",
        n_layers=62,
        d_model=5376,
        n_heads=32,
        n_kv_heads=16,
        head_dim=128,
        d_ff=21_504,
        vocab_size=262_144,
        pattern=PATTERN,
        rope_theta=1_000_000.0,
        rope_theta_local=10_000.0,
        sliding_window=1024,
        qk_norm=True,
        norm="rmsnorm",
        act="gelu",
        gated_mlp=True,
        tie_embeddings=True,
        subquadratic=True,
        opt_state_dtype="bfloat16",   # 27B replica: fp32 momentum would not fit
        max_seq_len=131_072,
    )
