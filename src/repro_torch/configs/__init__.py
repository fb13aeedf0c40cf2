"""Arch config registry (the archs ported so far)."""
import importlib

_ARCH_MODULES = ["mamba2_780m", "olmo_1b", "transformer_wmt"]

_loaded = False


def load_all():
    global _loaded
    if _loaded:
        return
    for m in _ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
    _loaded = True


from repro_torch.configs.base import (  # noqa: E402,F401
    InputShape, ModelConfig, SSMConfig, get_config, list_archs, reduced,
    register,
)
