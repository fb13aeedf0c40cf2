"""Distance-bounded modular (lattice) quantization: the configuration and
the closed-form wire size. Counterpart of ``repro/quant/schemes.py``; the
encode and decode themselves are the kernels behind ``quant/codecs.py``.
The scale follows the sender's distance proxy, or is the fixed absolute
resolution ε (``resolution``, the paper's ε) when one is given."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ModularQuantConfig:
    bits: int = 8
    block: int = 256            # coordinates per scale block
    safety: float = 8.0         # κ: scale headroom over the distance proxy
    resolution: Optional[float] = None  # fixed absolute resolution (ε)
    min_scale: float = 1e-8


def payload_bytes(cfg: ModularQuantConfig, n_coords: int) -> int:
    nblocks = -(-n_coords // cfg.block)
    per_coord = 1 if cfg.bits <= 8 else 2
    return n_coords * per_coord + nblocks * 4
