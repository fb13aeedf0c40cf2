"""Shared building blocks (``repro/models/layers.py``): parameter
templates, norms, RoPE, MLPs and the chunked cross-entropy.

Every function keeps the JAX package's layouts and its order of operations
(fp32 statistics, bf16 matmuls in the parameter dtype), so the same weights
give the same numbers up to the summation order of the backends.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.tree import tree_flatten, tree_map, tree_unflatten


@dataclass(frozen=True)
class ParamInfo:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis names, len == len(shape)
    init: str = "normal"              # normal | zeros | ones
    scale: Optional[float] = None     # default: 1/sqrt(fan_in) for normal

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_info(x) -> bool:
    return isinstance(x, ParamInfo)


def init_from_template(gen: torch.Generator, template, dtype, device):
    """Materialize a tree of ParamInfo with draws from `gen` (a generator
    on `device`). The draws differ from jax.random's; tests carry JAX's
    weights over with ``models/convert.py`` instead."""
    leaves, treedef = tree_flatten(template)

    def make(info: ParamInfo):
        if info.init == "zeros":
            return torch.zeros(info.shape, dtype=dtype, device=device)
        if info.init == "ones":
            return torch.ones(info.shape, dtype=dtype, device=device)
        fan_in = info.shape[-2] if len(info.shape) >= 2 else info.shape[-1]
        scale = info.scale if info.scale is not None else fan_in ** -0.5
        w = torch.randn(info.shape, generator=gen, dtype=torch.float32,
                        device=device)
        return (w * scale).to(dtype)

    return tree_unflatten(treedef, [make(i) for i in leaves])


def stack_template(template, n: int, axis_name: str = "layers"):
    """Prepend a stacked-blocks dim of size n to every ParamInfo."""
    return tree_map(lambda i: ParamInfo((n,) + i.shape, (axis_name,) + i.axes,
                                        i.init, i.scale), template)


def per_lane(x, batch: int, device) -> torch.Tensor:
    """A scalar or per-lane [B] integer (a cache length, a chunk's valid
    count) -> int64 [B] on `device`. The serving engine runs its slots as
    one batch where the reference vmaps a batch-1 call over them, so each
    lane carries its own length."""
    t = torch.as_tensor(x, device=device).to(torch.int64).reshape(-1)
    return t.expand(batch) if t.numel() == 1 else t


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_template(cfg, d: Optional[int] = None):
    d = d if d is not None else cfg.d_model
    if cfg.norm == "nonparam_ln":
        return {}                      # OLMo: no affine params
    if cfg.norm == "layernorm":
        return {"scale": ParamInfo((d,), ("embed",), "ones"),
                "bias": ParamInfo((d,), ("embed",), "zeros")}
    return {"scale": ParamInfo((d,), ("embed",), "ones")}  # rmsnorm


def apply_norm(cfg, p, x, eps: float = 1e-6):
    xf = x.to(torch.float32)
    if cfg.norm == "rmsnorm":
        xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        xf = xf * p["scale"].to(torch.float32)
        return xf.to(x.dtype)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=-1, keepdim=True)
    xf = (xf - mean) * torch.rsqrt(var + eps)
    if cfg.norm == "layernorm":
        xf = xf * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    return xf.to(x.dtype)              # nonparam_ln: no affine


def rms_norm_simple(x, scale, eps: float = 1e-6):
    """RMS norm with an explicit scale (Mamba2's gated norm, QK-norm)."""
    xf = x.to(torch.float32)
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * scale.to(torch.float32)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, rot_frac: float, theta: float, device=None):
    rot_dim = int(head_dim * rot_frac)
    rot_dim -= rot_dim % 2
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                        device=device) / rot_dim
    # a device fill, not a host copy: a CUDA graph capture runs this
    inv = 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32,
                                     device=device), exps)
    return inv, rot_dim


def apply_rope(x, positions, *, theta: float, rot_frac: float = 1.0):
    """x: [..., S, H, hd]; positions: [..., S] integer."""
    hd = x.shape[-1]
    inv, rot_dim = rope_freqs(hd, rot_frac, theta, device=x.device)
    if rot_dim == 0:
        return x
    ang = positions[..., :, None].to(torch.float32) * inv    # [..., S, rot/2]
    cos = torch.cos(ang)[..., :, None, :]                    # [..., S, 1, rot/2]
    sin = torch.sin(ang)[..., :, None, :]
    xr, xp = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    return torch.cat([out.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_template(cfg, d_ff: Optional[int] = None):
    d, f = cfg.d_model, d_ff if d_ff is not None else cfg.d_ff
    t = {"w_up": ParamInfo((d, f), ("embed", "ffn")),
         "w_down": ParamInfo((f, d), ("ffn", "embed"))}
    if cfg.gated_mlp:
        t["w_gate"] = ParamInfo((d, f), ("embed", "ffn"))
    return t


def activation(cfg, x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh") if cfg.act == "gelu" else F.silu(x)


def apply_mlp(cfg, p, x):
    h = torch.matmul(x, p["w_up"])
    if cfg.gated_mlp:
        g = torch.matmul(x, p["w_gate"])
        h = activation(cfg, g) * h
    else:
        h = activation(cfg, h)
    return torch.matmul(h, p["w_down"])


# ---------------------------------------------------------------------------
# Chunked cross-entropy (never materializes the full [B, S, V] logits)
# ---------------------------------------------------------------------------


def chunked_softmax_xent(x, embed, targets, mask=None, chunk: int = 16_384,
                         softcap: float = 0.0):
    """Mean CE of logits = x @ embed.T, online logsumexp over vocab chunks
    in fp32. x: [B,S,D], embed: [V,D], targets: [B,S] integer."""
    V = embed.shape[0]
    chunk = min(chunk, V)
    n_chunks = -(-V // chunk)
    pad_v = n_chunks * chunk - V
    embed_p = F.pad(embed, (0, 0, 0, pad_v)) if pad_v else embed
    targets = targets.to(torch.int64)
    B, S = targets.shape
    m = torch.full((B, S), -torch.inf, dtype=torch.float32, device=x.device)
    s = torch.zeros((B, S), dtype=torch.float32, device=x.device)
    tl = torch.zeros((B, S), dtype=torch.float32, device=x.device)
    for c in range(n_chunks):
        off = c * chunk
        ec = embed_p[off:off + chunk]
        logits = torch.einsum("bsd,vd->bsv", x, ec).to(torch.float32)
        if softcap:
            logits = softcap * torch.tanh(logits / softcap)
        if pad_v:  # mask padded vocab rows in the last chunk
            vidx = off + torch.arange(chunk, device=x.device)
            logits = torch.where(vidx[None, None, :] < V, logits, -torch.inf)
        cm = torch.amax(logits, dim=-1)
        m_new = torch.maximum(m, cm)
        s = s * torch.exp(m - m_new) + torch.sum(
            torch.exp(logits - m_new[..., None]), dim=-1)
        loc = targets - off
        in_chunk = (loc >= 0) & (loc < chunk)
        tgt = torch.gather(logits, -1,
                           torch.clamp(loc, 0, chunk - 1)[..., None])[..., 0]
        tl = torch.where(in_chunk, tgt, tl)
        m = m_new
    nll = m + torch.log(s) - tl
    if mask is None:
        return torch.mean(nll)
    mask = mask.to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
