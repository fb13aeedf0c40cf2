"""gemma3-4b [dense] — 5:1 local:global sliding-window attention, QK-norm,
θ 1M global / 10k local. Source: [hf:google/gemma-3-1b-pt] family (4b card:
34 layers, d_model 2560, 8 q / 4 kv heads, head_dim 256, d_ff 10240, vocab
262144, window 1024); copy of ``repro/configs/gemma3_4b.py``."""
from repro_torch.configs.base import ModelConfig, register

# one pattern unit = 5 sliding-window layers then 1 global layer
PATTERN = (("swa", "dense"),) * 5 + (("attn", "dense"),)


@register("gemma3-4b")
def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b",
        arch_type="dense",
        source="hf:google/gemma-3-1b-pt (4b variant)",
        n_layers=34,
        d_model=2560,
        n_heads=8,
        n_kv_heads=4,
        head_dim=256,
        d_ff=10240,
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
        subquadratic=True,       # sliding-window variant -> long_500k eligible
        max_seq_len=131_072,
    )
