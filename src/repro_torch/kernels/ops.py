"""Public wrappers over the three hand-written CUDA kernels.

Dispatch is by the tensor's device, and by nothing else:

* a CPU tensor runs the plain PyTorch version (``kernels/ref.py``);
* a CUDA tensor launches the kernel from ``csrc/`` (built at first use by
  ``kernels/build.py``), or raises — there is no fallback;
* a fake tensor (``torch._subclasses.fake_tensor.FakeTensorMode``, on
  any device: the dry run, ``launch/dryrun.py``) gets outputs of the
  kernel's shapes and dtypes, allocates nothing else and launches
  nothing.

Each kernel is a ``torch.library.custom_op`` (``repro_torch::...``) on the
``[rows, block]`` kernel layout, with its fake implementation registered
beside it; the op's body is the real dispatch above. A mode that watches
the dispatcher (the dry run's ``roofline/analysis.py`` ``TraceCounter``)
then sees one call and its outputs, whether the call ran the plain
version, launched the kernel or was fake.

Arbitrary-shaped inputs are flattened and zero-padded to the ``[rows,
block]`` kernel layout (rows a multiple of `tile_rows`) and un-padded on the
way out, as the JAX package's ``kernels/ops.py`` does. Each wrapper adds one
to ``LAUNCHES[name]`` exactly where it launches its kernel, so a run can show
that its main path went through the kernels.
"""
from __future__ import annotations

from typing import Optional, Tuple

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


def _check(t: torch.Tensor, name: str, dtypes, shape=None,
           aligned: bool = True):
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")


def _launch(name: str, *args) -> None:
    from repro_torch.kernels.build import kernel
    err = kernel(name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name!r} failed to launch: "
                           f"cudaError {err}")
    LAUNCHES[name] += 1


def _code_dtype(bits: int) -> torch.dtype:
    return torch.uint8 if bits <= 8 else torch.uint16


# -- quantize_mod ----------------------------------------------------------

def _encode_checks(xb, rb, ub, bits, pack4, aligned=True):
    """The CUDA encode's contract on its [rows, 256] fp32 inputs."""
    if xb.shape[1] != 256:
        raise ValueError(f"the CUDA encode takes 256-wide rows, got "
                         f"{xb.shape[1]}")
    if bits > 16 or (pack4 and bits > 4):
        raise ValueError(f"bits={bits} pack4={pack4} unsupported")
    for t, nm in ((xb, "x"), (rb, "ref"), (ub, "u")):
        _check(t, nm, (torch.float32,), xb.shape, aligned)


def _encode_outputs(xb, bits, pack4):
    n_rows, block = xb.shape
    q = xb.new_empty((n_rows, block // 2 if pack4 else block),
                     dtype=_code_dtype(bits))
    return q, xb.new_empty((n_rows, 1), dtype=torch.float32)


@torch.library.custom_op("repro_torch::quantize_mod", mutates_args=())
def _quantize_mod_op(xb: torch.Tensor, rb: torch.Tensor, ub: torch.Tensor,
                     safety: float, min_scale: float, bits: int,
                     pack4: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    if xb.device.type == "cpu":
        return ref_ops.quantize_mod(xb, rb, ub, safety=safety,
                                    min_scale=min_scale, bits=bits,
                                    pack4=pack4)
    _encode_checks(xb, rb, ub, bits, pack4)
    q, s = _encode_outputs(xb, bits, pack4)
    half = (1 << bits) // 2
    _launch("quantize_mod", xb.data_ptr(), rb.data_ptr(), ub.data_ptr(),
            q.data_ptr(), s.data_ptr(), xb.shape[0], safety / half,
            min_scale, bits, int(pack4))
    return q, s


@_quantize_mod_op.register_fake
def _(xb, rb, ub, safety, min_scale, bits, pack4):
    if xb.device.type == "cuda":
        _encode_checks(xb, rb, ub, bits, pack4, aligned=False)
    return _encode_outputs(xb, bits, pack4)


def quantize_mod(x, ref, u, *, block: int = 256, safety: float = 8.0,
                 min_scale: float = 1e-8, bits: int = 8, tile_rows: int = 8,
                 pack4: bool = False):
    """Lattice encode -> (q, s [rows, 1] fp32, pad). q is [rows, block]
    uint8 (bits <= 8) or uint16 (9..16 bits), or [rows, block/2] uint8
    nibble-packed with `pack4` (bits <= 4)."""
    xb, pad = _to_blocks(x, block, tile_rows)
    rb, _ = _to_blocks(ref, block, tile_rows)
    ub, _ = _to_blocks(u, block, tile_rows)
    _on_cuda(xb, rb, ub)
    q, s = _quantize_mod_op(xb, rb, ub, float(safety), float(min_scale),
                            int(bits), bool(pack4))
    return q, s, pad


# -- decode_avg ------------------------------------------------------------

def _decode_checks(q, s, yb, matched, bits, pack4, aligned=True):
    """The CUDA decode's contract on its [rows, 256] inputs."""
    n_rows, block = yb.shape
    if block != 256:
        raise ValueError(f"the CUDA decode takes 256-wide rows, got {block}")
    if bits > 16 or (pack4 and bits > 4):
        raise ValueError(f"bits={bits} pack4={pack4} unsupported")
    _check(yb, "y", (torch.float32, torch.bfloat16), aligned=aligned)
    _check(q, "q", (_code_dtype(bits),),
           (n_rows, block // 2 if pack4 else block), aligned)
    _check(s, "s", (torch.float32,), (n_rows, 1), aligned)
    if matched is not None and matched.numel() != n_rows:
        raise ValueError(f"matched: {matched.numel()} rows != {n_rows}")


@torch.library.custom_op("repro_torch::decode_avg", mutates_args=())
def _decode_avg_op(q: torch.Tensor, s: torch.Tensor, yb: torch.Tensor,
                   matched: Optional[torch.Tensor], bits: int,
                   average: bool, pack4: bool) -> torch.Tensor:
    if yb.device.type == "cpu":
        return ref_ops.decode_avg(q, s, yb, bits=bits, average=average,
                                  matched=matched, pack4=pack4)
    _decode_checks(q, s, yb, matched, bits, pack4)
    out = torch.empty_like(yb)
    _launch("decode_avg", q.data_ptr(), s.data_ptr(), yb.data_ptr(),
            None if matched is None else matched.data_ptr(), out.data_ptr(),
            yb.shape[0], bits, int(pack4), int(average),
            int(yb.dtype == torch.bfloat16))
    return out


@_decode_avg_op.register_fake
def _(q, s, yb, matched, bits, average, pack4):
    if yb.device.type == "cuda":
        _decode_checks(q, s, yb, matched, bits, pack4, aligned=False)
    return torch.empty_like(yb)


def decode_avg(q, s, y, *, block: int = 256, bits: int = 8,
               average: bool = True, matched=None, tile_rows: int = 8,
               pack4: bool = False):
    """Decode q,s against the receiver tensor y (original shape) and return
    (y + x̂)/2 (x̂ when not `average`) in y's shape and dtype. `matched`
    is an optional per-row [rows] mask: rows with 0 return y unchanged."""
    yb, pad = _to_blocks(y, block, tile_rows)
    if _on_cuda(q, s, yb, matched) and matched is not None:
        # the kernel reads the mask as one byte a row
        matched = (matched.reshape(-1) != 0).to(torch.uint8)
    out = _decode_avg_op(q, s, yb, matched, int(bits), bool(average),
                         bool(pack4))
    flat = out.reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(y.shape)


# -- sgd_update ------------------------------------------------------------

def _sgd_checks(pb, gb, mb, lr_t, aligned=True):
    """The CUDA update's contract: fp32 buffers of one shape, lr a
    one-element fp32 tensor on their device."""
    if not (lr_t is not None and lr_t.numel() == 1
            and lr_t.dtype == torch.float32 and lr_t.device == pb.device):
        raise TypeError("on the card, lr must be a one-element fp32 "
                        "tensor on the buffers' device")
    for t, nm in ((pb, "p"), (gb, "g"), (mb, "m")):
        _check(t, nm, (torch.float32,), pb.shape, aligned)


def _sgd_launch(pb, gb, mb, pn, mn, lr_t, mu, wd, nesterov) -> None:
    _launch("sgd_update", pb.data_ptr(), gb.data_ptr(), mb.data_ptr(),
            pn.data_ptr(), mn.data_ptr(), lr_t.data_ptr(), pb.numel(),
            float(mu), float(wd), int(nesterov))


@torch.library.custom_op("repro_torch::sgd_update", mutates_args=())
def _sgd_update_op(pb: torch.Tensor, gb: torch.Tensor, mb: torch.Tensor,
                   lr_t: Optional[torch.Tensor], lr: float, mu: float,
                   wd: float, nesterov: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    if pb.device.type == "cpu":
        return ref_ops.sgd_update(pb, gb, mb, lr=lr if lr_t is None else lr_t,
                                  mu=mu, wd=wd, nesterov=nesterov)
    _sgd_checks(pb, gb, mb, lr_t)
    pn, mn = torch.empty_like(pb), torch.empty_like(mb)
    _sgd_launch(pb, gb, mb, pn, mn, lr_t, mu, wd, nesterov)
    return pn, mn


@_sgd_update_op.register_fake
def _(pb, gb, mb, lr_t, lr, mu, wd, nesterov):
    if pb.device.type == "cuda":
        _sgd_checks(pb, gb, mb, lr_t, aligned=False)
    return torch.empty_like(pb), torch.empty_like(mb)


@torch.library.custom_op("repro_torch::sgd_update_", mutates_args=("pb", "mb"))
def _sgd_update_inplace_op(pb: torch.Tensor, gb: torch.Tensor,
                           mb: torch.Tensor, lr_t: Optional[torch.Tensor],
                           lr: float, mu: float, wd: float,
                           nesterov: bool) -> None:
    if pb.device.type == "cpu":
        pn, mn = ref_ops.sgd_update(pb, gb, mb,
                                    lr=lr if lr_t is None else lr_t, mu=mu,
                                    wd=wd, nesterov=nesterov)
        pb.copy_(pn)
        mb.copy_(mn)
        return
    _sgd_checks(pb, gb, mb, lr_t)
    _sgd_launch(pb, gb, mb, pb, mb, lr_t, mu, wd, nesterov)


@_sgd_update_inplace_op.register_fake
def _(pb, gb, mb, lr_t, lr, mu, wd, nesterov):
    if pb.device.type == "cuda":
        _sgd_checks(pb, gb, mb, lr_t, aligned=False)


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
    _on_cuda(pb, gb, mb)
    lr_t, lr_f = (lr, 0.0) if torch.is_tensor(lr) else (None, float(lr))
    args = (pb, gb, mb, lr_t, lr_f, float(mu), float(wd), bool(nesterov))
    if inplace:
        _sgd_update_inplace_op(*args)
        pn, mn = pb, mb
    else:
        pn, mn = _sgd_update_op(*args)

    def unflat(a, like):
        flat = a.reshape(-1)
        if pad:
            flat = flat[:-pad]
        return flat.reshape(like.shape)
    return unflat(pn, p), unflat(mn, m)
