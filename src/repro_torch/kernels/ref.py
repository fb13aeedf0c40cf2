"""Plain PyTorch versions of the three hand-written kernels.

These are the oracles the CUDA kernels in ``csrc/`` are held against (on the
card, bitwise), and the code path a CPU tensor takes through
``kernels/ops.py``. They repeat the JAX package's ``kernels/ref.py``
operation for operation, so run eagerly on the CPU they reproduce it
bitwise: every elementwise step is a separate torch op (no multiply-add is
contracted), the floor-mod is ``torch.remainder`` (floor semantics, not
``fmod``'s truncation) computed in fp32 and cast last, and ``torch.round``
is half-to-even like ``jnp.round``.

uint16 codes go through int16/int32 views instead of uint16 arithmetic:
PyTorch implements only part of its ops for ``torch.uint16`` (``remainder``
raises on it), and a view keeps the bits.
"""
from __future__ import annotations

import torch


def pack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """[R, B] uint8 codes in [0, 16) -> [R, B/2] uint8, two codes per byte.

    Half-split layout: the LOW nibble of byte c holds column c, the HIGH
    nibble holds column c + B/2."""
    half = q.shape[-1] // 2
    lo = q[..., :half].to(torch.uint8)
    hi = q[..., half:].to(torch.uint8)
    return lo | (hi << 4)


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_nibbles`: [R, B/2] uint8 -> [R, B] uint8."""
    lo = packed & 0x0F
    hi = (packed >> 4) & 0x0F
    return torch.cat([lo, hi], dim=-1)


def codes_to_float(q: torch.Tensor) -> torch.Tensor:
    """uint8 / uint16 wire codes -> fp32 (uint16 read through an int16
    view, so no uint16 kernel is needed)."""
    if q.dtype == torch.uint16:
        return (q.view(torch.int16).to(torch.int32) & 0xFFFF).to(torch.float32)
    return q.to(torch.float32)


def float_to_codes(qf: torch.Tensor, bits: int) -> torch.Tensor:
    """Integer-valued fp32 in [0, 2^bits) -> uint8 (bits <= 8) or uint16."""
    if bits <= 8:
        return qf.to(torch.uint8)
    return qf.to(torch.int32).to(torch.int16).view(torch.uint16)


def quantize_mod(x, ref, u, *, safety: float = 8.0, min_scale: float = 1e-8,
                 bits: int = 8, pack4: bool = False):
    """Per-row lattice encode of [R, B] blocks -> (q, s [R, 1] fp32)."""
    levels = 1 << bits
    half = levels // 2
    xf = x.to(torch.float32)
    rf = ref.to(torch.float32)
    dist = torch.amax(torch.abs(xf - rf), dim=1, keepdim=True)
    s = torch.clamp_min(dist * (safety / half), min_scale)
    q = float_to_codes(torch.remainder(torch.floor(xf / s + u), levels), bits)
    if pack4:
        assert bits <= 4, f"nibble packing needs bits <= 4, got {bits}"
        q = pack_nibbles(q)
    return q, s


def decode_avg(q, s, y, *, bits: int = 8, average: bool = True,
               matched=None, pack4: bool = False):
    """Decode q against the receiver's y; (y + x̂)/2, or x̂ if not average.
    Rows whose `matched` entry is 0 return y unchanged."""
    if pack4:
        q = unpack_nibbles(q)
    levels = 1 << bits
    half = levels // 2
    yf = y.to(torch.float32)
    qy = torch.round(yf / s)
    diff = torch.remainder(codes_to_float(q) - qy, levels)
    wrapped = torch.where(diff >= half, diff - levels, diff)
    x_hat = (qy + wrapped) * s
    out = (yf + x_hat) * 0.5 if average else x_hat
    if matched is not None:
        out = torch.where(matched.reshape(-1, 1) != 0, out, yf)
    return out.to(y.dtype)


def sgd_update(p, g, m, *, lr, mu: float = 0.9, wd: float = 0.0,
               nesterov: bool = False):
    """Momentum / weight-decay SGD step -> (p', m'). `lr` is a float or a
    0-d fp32 tensor."""
    pf, gf, mf = (a.to(torch.float32) for a in (p, g, m))
    if wd:
        gf = gf + wd * pf
    m_new = mu * mf + gf
    step = gf + mu * m_new if nesterov else m_new
    return (pf - lr * step).to(p.dtype), m_new.to(m.dtype)
