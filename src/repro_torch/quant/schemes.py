"""Distance-bounded modular (lattice) quantization (counterpart of
``repro/quant/schemes.py``): the configuration, the closed-form wire size,
and the per-leaf encode / decode the ``*_legacy`` oracles speak.

Encoding of x with per-block scale s:  q = floor(x/s + u) mod 2^bits.
Decode at receiver holding y:          x̂ = (round(y/s) + wrap(q - round(y/s) mod 2^bits)) * s.

The scale follows the sender's distance proxy, s = max(κ·max_b|x - ref| /
2^(bits-1), min_scale), or is the fixed absolute resolution ε
(``resolution``, the paper's ε). The flat transport runs the same
arithmetic through the ``quantize_mod`` / ``decode_avg`` kernels behind
``quant/codecs.py``; these per-leaf forms are plain PyTorch, each step the
reference's, so on the CPU they reproduce it bitwise given its uniforms
(``u``, which are drawn from a ``torch.Generator`` when not given).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import codes_to_float, float_to_codes


@dataclass(frozen=True)
class ModularQuantConfig:
    bits: int = 8
    block: int = 256            # coordinates per scale block
    safety: float = 8.0         # κ: scale headroom over the distance proxy
    resolution: Optional[float] = None  # fixed absolute resolution (ε)
    min_scale: float = 1e-8


def _blocked(x, block, lead: int = 0):
    """`x` with its first `lead` dims kept and the rest flattened and
    zero-padded to [..., nblocks, block] -> (blocks, pad)."""
    keep = tuple(x.shape[:lead])
    flat = x.reshape(keep + (-1,))
    pad = (-flat.shape[-1]) % block
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(keep + (-1, block)), pad


def encode_modular(cfg: ModularQuantConfig, x, ref, rng=None, *, u=None,
                   lead: int = 0):
    """-> (q uint8/uint16 [..., nblocks, block], scales fp32 [...,
    nblocks]); x and ref of one shape. `u` ~ U[0, 1) of the blocked shape,
    drawn from the generator `rng` unless given. With lead=1 `x` is
    node-stacked and each node is blocked on its own, as the reference's
    vmap over nodes encodes it."""
    levels = 1 << cfg.bits
    half = levels // 2
    xb, _ = _blocked(x.to(torch.float32), cfg.block, lead)
    if cfg.resolution is not None:
        s = torch.full(xb.shape[:-1], cfg.resolution, dtype=torch.float32,
                       device=xb.device)
    else:
        rb, _ = _blocked(ref.to(torch.float32), cfg.block, lead)
        dist = torch.amax(torch.abs(xb - rb), dim=-1)
        s = torch.clamp_min(dist * cfg.safety / half, cfg.min_scale)
    if u is None:
        u = torch.rand(xb.shape, generator=rng, dtype=torch.float32,
                       device=xb.device)
    q = torch.floor(xb / s[..., None] + u)           # stochastic rounding
    return float_to_codes(torch.remainder(q, levels), cfg.bits), s


def decode_modular(cfg: ModularQuantConfig, q, s, y, *, lead: int = 0):
    """Decode against the receiver's model y (the encoded x's shape; with
    lead=1 node-stacked, as `encode_modular`'s)."""
    levels = 1 << cfg.bits
    half = levels // 2
    yb, pad = _blocked(y.to(torch.float32), cfg.block, lead)
    qy = torch.round(yb / s[..., None])
    diff = torch.remainder(codes_to_float(q) - qy, levels)
    wrapped = torch.where(diff >= half, diff - levels, diff)   # signed wrap
    xb_hat = (qy + wrapped) * s[..., None]
    flat = xb_hat.reshape(tuple(y.shape[:lead]) + (-1,))
    if pad:
        flat = flat[..., :-pad]
    return flat.reshape(y.shape).to(y.dtype)


def payload_bytes(cfg: ModularQuantConfig, n_coords: int) -> int:
    nblocks = -(-n_coords // cfg.block)
    per_coord = 1 if cfg.bits <= 8 else 2
    return n_coords * per_coord + nblocks * 4


def quantized_pair_average(cfg: ModularQuantConfig, x, x_partner_q,
                           x_partner_s):
    """(x + decode(partner)) / 2 — the quantized gossip averaging step."""
    xh = decode_modular(cfg, x_partner_q, x_partner_s, x)
    return ((x.to(torch.float32) + xh.to(torch.float32)) * 0.5).to(x.dtype)
