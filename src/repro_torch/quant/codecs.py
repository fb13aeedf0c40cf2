"""Wire codecs over the bucketed ``[rows, block]`` flat-buffer layout.

Counterpart of ``repro/quant/codecs.py``. A :class:`WireCodec` declares its
:class:`WireLayout` (from which the exact per-node payload bytes follow) and
implements the sender half ``encode`` and the fused receiver half
``decode_avg``. This slice ports the lattice family (q2..q16: uint8 wire,
two codes per byte at q4 and below, uint16 at q9..q16), which runs through
the ``quantize_mod`` and ``decode_avg`` kernels. The bf16 and top-k codecs
are not ported yet: :func:`make_codec` refuses them by name.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops as K
from repro_torch.quant.schemes import ModularQuantConfig


@dataclass(frozen=True)
class WireGroup:
    """One tensor of the wire payload: [n_rows, cols] of `dtype`."""
    name: str
    dtype: str          # numpy dtype name ("uint8", "float32", ...)
    cols: int

    @property
    def bytes_per_row(self) -> int:
        return self.cols * np.dtype(self.dtype).itemsize


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
    family: str = "?"
    block: int = 256
    needs_prev: bool = False     # encode reads the sender's comm copy
    needs_rng: bool = False      # stochastic rounding
    carries_residual: bool = False

    def wire_layout(self) -> WireLayout:
        raise NotImplementedError

    def payload_num_bytes(self, n_padded: int) -> int:
        return self.wire_layout().payload_num_bytes(n_padded)

    def encode(self, buf, prev_buf, rng: Optional[torch.Generator], *,
               u: Optional[torch.Tensor] = None, tile_rows: int = 8):
        """[*, n_padded] buffer -> wire tuple (one tensor per WireGroup,
        leading dim = total blocked rows, node-contiguous)."""
        raise NotImplementedError

    def decode_avg(self, wire, ybuf, matched_rows=None, *,
                   tile_rows: int = 8):
        """Permuted wire + receiver's buffer -> (y + decode(wire; y)) / 2,
        rows with matched_rows == 0 keep y bitwise."""
        raise NotImplementedError

    def decode(self, wire, ybuf, *, tile_rows: int = 8):
        """Plain reconstruction x̂ = decode(wire; y), no averaging."""
        raise NotImplementedError


class LatticeCodec(WireCodec):
    """Davies-et-al. modular lattice on a uint8/uint16 wire, through the
    fused quantize_mod / decode_avg kernels."""

    needs_rng = True

    def __init__(self, quant: ModularQuantConfig):
        if quant.bits > 16:
            raise ValueError(f"lattice codec: bits={quant.bits} exceeds the "
                             "uint16 wire; supported: q2..q16")
        self.quant = quant
        self.block = quant.block
        self.packed = quant.bits <= 4
        self.name = f"q{quant.bits}"
        self.family = ("q4" if quant.bits <= 4 else
                       "q8" if quant.bits <= 8 else "q16")
        self.needs_prev = True

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


_NOT_PORTED = ("is not ported yet: it waits for the bf16/top-k codec item "
               "of the port queue in ROADMAP.md")


def make_codec(spec: Optional[str] = None,
               quant: Optional[ModularQuantConfig] = None) -> WireCodec:
    """``q<bits>`` (or None: the quant config itself, q8 by default) ->
    LatticeCodec. ``bf16`` and ``topk:<frac>`` raise NotImplementedError."""
    q = quant or ModularQuantConfig()
    if spec is None or spec == "":
        return LatticeCodec(q)
    if spec == "bf16" or spec.startswith("topk:"):
        raise NotImplementedError(f"codec {spec!r} {_NOT_PORTED}")
    if spec.startswith("q"):
        try:
            bits = int(spec[1:])
        except ValueError:
            raise ValueError(f"codec {spec!r}: unknown; supported: q2..q16")
        if not 2 <= bits <= 16:
            raise ValueError(f"codec {spec!r}: the lattice wire carries "
                             "2..16 bits (uint8/uint16)")
        return LatticeCodec(dataclasses.replace(q, bits=bits))
    raise ValueError(f"codec {spec!r}: unknown; supported: q2..q16")
