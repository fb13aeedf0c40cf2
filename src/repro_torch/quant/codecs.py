"""Wire codecs over the bucketed ``[rows, block]`` flat-buffer layout.

Counterpart of ``repro/quant/codecs.py``. A :class:`WireCodec` declares its
:class:`WireLayout` (from which the exact per-node payload bytes follow) and
implements the sender half ``encode`` and the fused receiver half
``decode_avg``. The family is the reference's:

``q2..q8``  — the modular lattice on a uint8 wire (two codes per byte at q4
              and below), through the ``quantize_mod`` and ``decode_avg``
              kernels; with a fixed resolution ε the encode is a plain
              floor-mod (no distance proxy, as in the reference);
``q9..q16`` — the same lattice on a uint16 wire;
``bf16``    — a straight bfloat16 cast, 2 bytes a coordinate;
``topk:F``  — per-row top-k of the movement since the comm copy plus the
              error-feedback residual, shipped as (fp32 value, uint8 index)
              pairs; the untransmitted remainder is the new residual.

bf16 and top-k are plain ``jnp`` in the reference (a cast, ``lax.top_k``,
a scatter), so they are plain PyTorch here (``torch.topk``, ``scatter_``).
``torch.topk`` and ``lax.top_k`` may pick different coordinates among
equal magnitudes; the dense transmitted part is the same either way.

``encode_state`` / ``decode_state`` compress a resident buffer against an
all-zeros reference (the compressed comm copy of ``compress_state``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops as K
from repro_torch.kernels import ref as R
from repro_torch.quant.schemes import ModularQuantConfig

#: codec families the capability matrix speaks in (algorithms/registry.py)
CODEC_FAMILIES = ("q8", "q4", "q16", "bf16", "topk")


@dataclass(frozen=True)
class WireGroup:
    """One tensor of the wire payload: [n_rows, cols] of `dtype`."""
    name: str
    dtype: str          # numpy dtype name ("uint8", "float32", ...)
    cols: int

    @property
    def bytes_per_row(self) -> int:
        # numpy has no bfloat16; its width is 2 bytes
        size = 2 if self.dtype == "bfloat16" else np.dtype(self.dtype).itemsize
        return self.cols * size


@dataclass(frozen=True)
class WireLayout:
    """The codec's declared wire format over the [rows, block] layout."""
    block: int
    groups: Tuple[WireGroup, ...]

    @property
    def bytes_per_row(self) -> int:
        return sum(g.bytes_per_row for g in self.groups)

    def payload_num_bytes(self, n_padded: int) -> int:
        """Exact wire bytes PER NODE for a [*, n_padded] buffer."""
        assert n_padded % self.block == 0, (n_padded, self.block)
        return (n_padded // self.block) * self.bytes_per_row


class WireCodec:
    """Base: subclasses set the class attributes and implement
    `wire_layout` / `encode` / `decode_avg` / `decode`."""

    name: str = "?"
    family: str = "?"            # capability-matrix family (CODEC_FAMILIES)
    block: int = 256
    needs_prev: bool = False     # encode reads the sender's comm copy
    needs_rng: bool = False      # stochastic rounding
    carries_residual: bool = False  # error-feedback slot in SwarmState

    def wire_layout(self) -> WireLayout:
        raise NotImplementedError

    def payload_num_bytes(self, n_padded: int) -> int:
        return self.wire_layout().payload_num_bytes(n_padded)

    def encode(self, buf, prev_buf, rng: Optional[torch.Generator], *,
               u: Optional[torch.Tensor] = None, tile_rows: int = 8):
        """[*, n_padded] buffer -> wire tuple (one tensor per WireGroup,
        leading dim = total blocked rows, node-contiguous)."""
        raise NotImplementedError

    def encode_ef(self, buf, prev_buf, rng, residual, *, u=None,
                  tile_rows: int = 8):
        """Error-feedback encode -> (wire, residual after the send), the
        residual buffer-shaped [*, n_padded] fp32. The caller gates the
        residual update by the matched mask."""
        assert not self.carries_residual, \
            f"{self.name}: carries_residual codecs must override encode_ef"
        return self.encode(buf, prev_buf, rng, u=u,
                           tile_rows=tile_rows), residual

    def decode_avg(self, wire, ybuf, matched_rows=None, *,
                   tile_rows: int = 8):
        """Permuted wire + receiver's buffer -> (y + decode(wire; y)) / 2,
        rows with matched_rows == 0 keep y bitwise."""
        raise NotImplementedError

    def decode(self, wire, ybuf, *, tile_rows: int = 8):
        """Plain reconstruction x̂ = decode(wire; y), no averaging."""
        raise NotImplementedError

    def encode_state(self, buf, rng, *, u=None, tile_rows: int = 8):
        """Compress a resident [*, n_padded] fp32 buffer against an
        all-zeros reference (the comm copy under ``compress_state``): the
        decode then needs no stored context."""
        return self.encode(buf, torch.zeros_like(buf), rng, u=u,
                           tile_rows=tile_rows)

    def decode_state(self, wire, shape, *, tile_rows: int = 8):
        """Inverse of `encode_state`: wire tuple -> [*, n_padded] fp32
        buffer of `shape`, on the wire's device."""
        zeros = torch.zeros(shape, dtype=torch.float32,
                            device=wire[0].device)
        return self.decode(wire, zeros, tile_rows=tile_rows)


class LatticeCodec(WireCodec):
    """Davies-et-al. modular lattice on a uint8/uint16 wire, through the
    fused quantize_mod / decode_avg kernels (or a plain floor-mod encode at
    a fixed resolution ε)."""

    needs_rng = True

    def __init__(self, quant: ModularQuantConfig):
        if quant.bits > 16:
            raise ValueError(f"lattice codec: bits={quant.bits} exceeds the "
                             "uint16 wire; supported codecs: q2..q16, bf16, "
                             "topk:<frac>")
        self.quant = quant
        self.block = quant.block
        self.packed = quant.bits <= 4
        self.name = f"q{quant.bits}"
        self.family = ("q4" if quant.bits <= 4 else
                       "q8" if quant.bits <= 8 else "q16")
        # a fixed-resolution encode needs no distance proxy
        self.needs_prev = quant.resolution is None

    def wire_layout(self) -> WireLayout:
        if self.packed:
            q = WireGroup("q", "uint8", self.block // 2)
        elif self.quant.bits <= 8:
            q = WireGroup("q", "uint8", self.block)
        else:
            q = WireGroup("q", "uint16", self.block)
        return WireLayout(self.block, (q, WireGroup("s", "float32", 1)))

    def encode(self, buf, prev_buf, rng, *, u=None, tile_rows: int = 8):
        """`u` ~ U[0, 1) of buf's shape is drawn from `rng` unless given
        (tests inject the JAX package's draw)."""
        qcfg = self.quant
        if u is None:
            u = torch.rand(buf.shape, generator=rng, dtype=torch.float32,
                           device=buf.device)
        if qcfg.resolution is not None:
            # fixed absolute resolution: a constant scale, stochastic
            # rounding and the floor-mod, packed after for the sub-byte wire
            xb = buf.reshape(-1, qcfg.block)
            s = torch.full((xb.shape[0], 1), qcfg.resolution,
                           dtype=torch.float32, device=buf.device)
            qf = torch.remainder(torch.floor(xb / s + u.reshape(xb.shape)),
                                 1 << qcfg.bits)
            q = R.float_to_codes(qf, qcfg.bits)
            return (R.pack_nibbles(q) if self.packed else q), s
        q, s, pad = K.quantize_mod(buf, prev_buf, u, block=qcfg.block,
                                   safety=qcfg.safety,
                                   min_scale=qcfg.min_scale, bits=qcfg.bits,
                                   tile_rows=tile_rows, pack4=self.packed)
        assert pad == 0, "flat buffer must be pre-aligned to the kernel layout"
        return q, s

    def decode_avg(self, wire, ybuf, matched_rows=None, *,
                   tile_rows: int = 8):
        q, s = wire
        return K.decode_avg(q, s, ybuf, matched=matched_rows,
                            block=self.quant.block, bits=self.quant.bits,
                            tile_rows=tile_rows, pack4=self.packed)

    def decode(self, wire, ybuf, *, tile_rows: int = 8):
        q, s = wire
        return K.decode_avg(q, s, ybuf, average=False,
                            block=self.quant.block, bits=self.quant.bits,
                            tile_rows=tile_rows, pack4=self.packed)


def _masked(out, yb, matched_rows):
    if matched_rows is None:
        return out
    return torch.where(matched_rows.reshape(-1, 1) != 0, out, yb)


class Bf16Codec(WireCodec):
    """A bfloat16 cast: no scales, no generator, no reference."""

    name = "bf16"
    family = "bf16"

    def __init__(self, block: int = 256):
        self.block = block

    def wire_layout(self) -> WireLayout:
        return WireLayout(self.block,
                          (WireGroup("v", "bfloat16", self.block),))

    def encode(self, buf, prev_buf, rng, *, u=None, tile_rows: int = 8):
        del prev_buf, rng, u
        return (buf.reshape(-1, self.block).to(torch.bfloat16),)

    def decode_avg(self, wire, ybuf, matched_rows=None, *,
                   tile_rows: int = 8):
        yb = ybuf.reshape(-1, self.block).to(torch.float32)
        out = (yb + wire[0].to(torch.float32)) * 0.5
        return _masked(out, yb, matched_rows).reshape(ybuf.shape) \
            .to(ybuf.dtype)

    def decode(self, wire, ybuf, *, tile_rows: int = 8):
        # the cast is the reconstruction: y is only a shape/dtype template
        return wire[0].to(torch.float32).reshape(ybuf.shape).to(ybuf.dtype)


class TopKCodec(WireCodec):
    """Per-row top-k of d = (x - prev) + residual, shipped as (fp32 value,
    uint8 in-row index) pairs; the receiver reconstructs x̂ = y + c against
    its own model and averages to y + c/2; the untransmitted d - c is the
    new residual (error feedback)."""

    needs_prev = True
    carries_residual = True

    def __init__(self, frac: float, block: int = 256):
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"topk fraction must be in (0, 1], got {frac}")
        if block > 256:
            raise ValueError("topk's uint8 in-row index needs block <= 256")
        self.frac = float(frac)
        self.block = block
        self.k = max(1, int(round(frac * block)))
        self.name = f"topk:{frac:g}"
        self.family = "topk"

    def wire_layout(self) -> WireLayout:
        return WireLayout(self.block,
                          (WireGroup("vals", "float32", self.k),
                           WireGroup("idx", "uint8", self.k)))

    def _delta(self, buf, prev_buf, residual):
        """The intended message [R, block] fp32, a fresh tensor (the
        residual is added in place)."""
        d = (buf - prev_buf).reshape(-1, self.block).to(torch.float32)
        if residual is not None:
            d.add_(residual.reshape(-1, self.block))
        return d

    def _select(self, d):
        """[R, block] intended message -> (vals [R, k], idx int64 [R, k]);
        the magnitudes are freed before the gather."""
        _, idx = torch.topk(torch.abs(d), self.k, dim=1)
        return torch.gather(d, 1, idx), idx

    @staticmethod
    def _scatter(d, idx, vals):
        """The dense [R, block] transmitted part."""
        return torch.zeros_like(d).scatter_(1, idx, vals)

    def encode(self, buf, prev_buf, rng, *, u=None, tile_rows: int = 8):
        del rng, u
        vals, idx = self._select(self._delta(buf, prev_buf, None))
        return vals, idx.to(torch.uint8)

    def encode_ef(self, buf, prev_buf, rng, residual, *, u=None,
                  tile_rows: int = 8):
        """-> ((vals, idx), residual after the send). In place on the
        fresh delta: d - scatter is computed into d's own memory."""
        del rng, u
        d = self._delta(buf, prev_buf, residual)
        vals, idx = self._select(d)
        dense = self._scatter(d, idx, vals)
        res_after = d.sub_(dense).reshape(buf.shape)
        del dense
        return (vals, idx.to(torch.uint8)), res_after

    def _dense(self, wire, yb):
        vals, idx = wire
        return torch.zeros_like(yb).scatter_(1, idx.to(torch.int64),
                                             vals.to(torch.float32))

    def decode_avg(self, wire, ybuf, matched_rows=None, *,
                   tile_rows: int = 8):
        yb = ybuf.reshape(-1, self.block).to(torch.float32)
        out = yb + 0.5 * self._dense(wire, yb)     # (y + (y + c)) / 2
        return _masked(out, yb, matched_rows).reshape(ybuf.shape) \
            .to(ybuf.dtype)

    def decode(self, wire, ybuf, *, tile_rows: int = 8):
        yb = ybuf.reshape(-1, self.block).to(torch.float32)
        return (yb + self._dense(wire, yb)).reshape(ybuf.shape) \
            .to(ybuf.dtype)                        # x̂ = y + c


_GRAMMAR = "supported: q2..q16, bf16, topk:<frac>"


def make_codec(spec: Optional[str] = None,
               quant: Optional[ModularQuantConfig] = None) -> WireCodec:
    """``q<bits>`` | ``bf16`` | ``topk:<frac>`` -> WireCodec (the `--codec`
    grammar). `quant` seeds the lattice family's block, safety and
    resolution; a ``q<bits>`` spec overrides its width; None follows the
    quant config itself (q8 by default). A bogus spec raises ValueError."""
    q = quant or ModularQuantConfig()
    if spec is None or spec == "":
        return LatticeCodec(q)
    if spec == "bf16":
        return Bf16Codec(block=q.block)
    if spec.startswith("topk:"):
        try:
            frac = float(spec.split(":", 1)[1])
        except ValueError:
            raise ValueError(f"--codec {spec!r}: want topk:<frac>, "
                             "e.g. topk:0.25")
        return TopKCodec(frac, block=q.block)
    if spec.startswith("q"):
        try:
            bits = int(spec[1:])
        except ValueError:
            raise ValueError(f"--codec {spec!r}: unknown codec; {_GRAMMAR}")
        if not 2 <= bits <= 16:
            raise ValueError(f"--codec {spec!r}: the lattice wire carries "
                             "2..16 bits (uint8/uint16)")
        return LatticeCodec(dataclasses.replace(q, bits=bits))
    raise ValueError(f"--codec {spec!r}: unknown codec; {_GRAMMAR}")
