"""Public wrappers over the three hand-written CUDA kernels.

Dispatch is by the tensor's device, and by nothing else:

* a CPU tensor runs the plain PyTorch version (``kernels/ref.py``);
* a CUDA tensor launches the kernel from ``csrc/`` (built at first use by
  ``kernels/build.py``), or raises — there is no fallback.

Arbitrary-shaped inputs are flattened and zero-padded to the ``[rows,
block]`` kernel layout (rows a multiple of `tile_rows`) and un-padded on the
way out, as the JAX package's ``kernels/ops.py`` does. Each wrapper adds one
to ``LAUNCHES[name]`` exactly where it launches its kernel, so a run can show
that its main path went through the kernels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref as ref_ops

LAUNCHES = {"sgd_update": 0, "quantize_mod": 0, "decode_avg": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def add_launches(counts: dict) -> None:
    """Add a CUDA graph's launches per replay: `_launch` counts a kernel
    in Python, which a captured graph runs once at capture (where nothing
    runs on the card) and never at replay, so ``core/scan.py`` records
    each graph's launches at capture, takes them back out and adds them
    here at every replay."""
    for k, v in counts.items():
        LAUNCHES[k] += v


def _to_blocks(x: torch.Tensor, block: int, tile_rows: int):
    flat = x.reshape(-1)
    n_rows = -(-flat.numel() // block)
    n_rows_pad = -(-n_rows // tile_rows) * tile_rows
    pad = n_rows_pad * block - flat.numel()
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(n_rows_pad, block), pad


def _on_cuda(*tensors) -> bool:
    """True for CUDA tensors, False for CPU ones; anything else raises."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"kernel inputs must all lie on the CPU or all on one "
                     f"CUDA device, got {sorted(kinds)}")


def _check(t: torch.Tensor, name: str, dtypes, shape=None):
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")


def _launch(name: str, *args) -> None:
    from repro_torch.kernels.build import kernel
    err = kernel(name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name!r} failed to launch: "
                           f"cudaError {err}")
    LAUNCHES[name] += 1


def quantize_mod(x, ref, u, *, block: int = 256, safety: float = 8.0,
                 min_scale: float = 1e-8, bits: int = 8, tile_rows: int = 8,
                 pack4: bool = False):
    """Lattice encode -> (q, s [rows, 1] fp32, pad). q is [rows, block]
    uint8 (bits <= 8) or uint16 (9..16 bits), or [rows, block/2] uint8
    nibble-packed with `pack4` (bits <= 4)."""
    xb, pad = _to_blocks(x, block, tile_rows)
    rb, _ = _to_blocks(ref, block, tile_rows)
    ub, _ = _to_blocks(u, block, tile_rows)
    if not _on_cuda(xb, rb, ub):
        q, s = ref_ops.quantize_mod(xb, rb, ub, safety=safety,
                                    min_scale=min_scale, bits=bits,
                                    pack4=pack4)
        return q, s, pad
    if block != 256:
        raise ValueError(f"the CUDA encode takes 256-wide rows, got {block}")
    if bits > 16 or (pack4 and bits > 4):
        raise ValueError(f"bits={bits} pack4={pack4} unsupported")
    for t, nm in ((xb, "x"), (rb, "ref"), (ub, "u")):
        _check(t, nm, (torch.float32,), xb.shape)
    n_rows = xb.shape[0]
    q_dtype = torch.uint8 if bits <= 8 else torch.uint16
    q = torch.empty((n_rows, block // 2 if pack4 else block), dtype=q_dtype,
                    device=xb.device)
    s = torch.empty((n_rows, 1), dtype=torch.float32, device=xb.device)
    half = (1 << bits) // 2
    _launch("quantize_mod", xb.data_ptr(), rb.data_ptr(), ub.data_ptr(),
            q.data_ptr(), s.data_ptr(), n_rows, safety / half, min_scale,
            bits, int(pack4))
    return q, s, pad


def decode_avg(q, s, y, *, block: int = 256, bits: int = 8,
               average: bool = True, matched=None, tile_rows: int = 8,
               pack4: bool = False):
    """Decode q,s against the receiver tensor y (original shape) and return
    (y + x̂)/2 (x̂ when not `average`) in y's shape and dtype. `matched`
    is an optional per-row [rows] mask: rows with 0 return y unchanged."""
    yb, pad = _to_blocks(y, block, tile_rows)
    if not _on_cuda(q, s, yb, matched):
        out = ref_ops.decode_avg(q, s, yb, bits=bits, average=average,
                                 matched=matched, pack4=pack4)
    else:
        if block != 256:
            raise ValueError(f"the CUDA decode takes 256-wide rows, got "
                             f"{block}")
        if bits > 16 or (pack4 and bits > 4):
            raise ValueError(f"bits={bits} pack4={pack4} unsupported")
        n_rows = yb.shape[0]
        _check(yb, "y", (torch.float32, torch.bfloat16))
        q_dtype = torch.uint8 if bits <= 8 else torch.uint16
        _check(q, "q", (q_dtype,),
               (n_rows, block // 2 if pack4 else block))
        _check(s, "s", (torch.float32,), (n_rows, 1))
        m_ptr = None
        if matched is not None:
            matched = (matched.reshape(-1) != 0).to(torch.uint8)
            if matched.numel() != n_rows:
                raise ValueError(f"matched: {matched.numel()} rows != "
                                 f"{n_rows}")
            m_ptr = matched.data_ptr()
        out = torch.empty_like(yb)
        _launch("decode_avg", q.data_ptr(), s.data_ptr(), yb.data_ptr(),
                m_ptr, out.data_ptr(), n_rows, bits, int(pack4),
                int(average), int(yb.dtype == torch.bfloat16))
    flat = out.reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(y.shape)


def sgd_fused_update(p, g, m, *, lr, mu: float = 0.9, wd: float = 0.0,
                     nesterov: bool = False, block: int = 512,
                     tile_rows: int = 8, inplace: bool = False):
    """Fused momentum/weight-decay SGD update -> (p', m'), one sweep.
    `lr` is a float or a 0-d fp32 tensor; on the card it must be a 0-d
    fp32 tensor on the same device, read by the kernel through a pointer.
    With `inplace`, p' is written into `p` and m' into `m` (fp32,
    contiguous, a whole number of [tile_rows, block] tiles, so no padded
    copy stands between them and the kernel), which are returned: the
    packed optimizer buffers are temporaries, and updating them in place
    spares two buffer-sized outputs at the optimizer's memory peak."""
    pb, pad = _to_blocks(p, block, tile_rows)
    gb, _ = _to_blocks(g, block, tile_rows)
    mb, _ = _to_blocks(m, block, tile_rows)
    if inplace:
        if pad:
            raise ValueError(f"inplace: {p.numel()} elements are not a "
                             f"whole number of {tile_rows}x{block} tiles")
        for t, nm in ((p, "p"), (m, "m")):
            if t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(f"inplace: {nm} must be contiguous fp32")
    if not _on_cuda(pb, gb, mb):
        pn, mn = ref_ops.sgd_update(pb, gb, mb, lr=lr, mu=mu, wd=wd,
                                    nesterov=nesterov)
        if inplace:
            pn, mn = pb.copy_(pn), mb.copy_(mn)
    else:
        if not (torch.is_tensor(lr) and lr.numel() == 1
                and lr.dtype == torch.float32 and lr.device == pb.device):
            raise TypeError("on the card, lr must be a one-element fp32 "
                            "tensor on the buffers' device")
        for t, nm in ((pb, "p"), (gb, "g"), (mb, "m")):
            _check(t, nm, (torch.float32,), pb.shape)
        if inplace:
            pn, mn = pb, mb
        else:
            pn, mn = torch.empty_like(pb), torch.empty_like(mb)
        _launch("sgd_update", pb.data_ptr(), gb.data_ptr(), mb.data_ptr(),
                pn.data_ptr(), mn.data_ptr(), lr.data_ptr(), pb.numel(),
                float(mu), float(wd), int(nesterov))

    def unflat(a, like):
        flat = a.reshape(-1)
        if pad:
            flat = flat[:-pad]
        return flat.reshape(like.shape)
    return unflat(pn, p), unflat(mn, m)
