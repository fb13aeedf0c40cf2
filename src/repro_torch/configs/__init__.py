"""Arch config registry: one module per architecture."""
import importlib

_ARCH_MODULES = [
    "gemma3_4b", "olmo_1b", "granite_moe_3b_a800m", "musicgen_large",
    "gemma3_27b", "paligemma_3b", "jamba_1_5_large_398b", "chatglm3_6b",
    "mamba2_780m", "qwen3_moe_30b_a3b", "transformer_wmt",
]

_loaded = False


def load_all():
    global _loaded
    if _loaded:
        return
    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    _loaded = True


from repro_torch.configs.base import (  # noqa: E402,F401
    INPUT_SHAPES, FrontendConfig, InputShape, ModelConfig, MoEConfig,
    SSMConfig, get_config, list_archs, reduced, register,
)
