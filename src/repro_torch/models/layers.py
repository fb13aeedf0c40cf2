"""Shared building blocks (``repro/models/layers.py``): parameter
templates, norms, RoPE, MLPs and the chunked cross-entropy.

Every function keeps the JAX package's layouts and its order of operations
(fp32 statistics, bf16 matmuls in the parameter dtype), so the same weights
give the same numbers up to the summation order of the backends.

On a node split over K GPUs (the model axis, ``models/split.py``) a
layer takes `tp` (``launch/mesh.py`` ``ModelShard``: K, this GPU's
index, the model group) and its parameters' slices, and two conjugate
collectives join the slices, as in the reference's sharded program:
:func:`copy_to_model` (identity forward, all-reduce of the gradient
over the model group backward) where a replicated tensor enters a
split computation, :func:`reduce_from_model` (all-reduce forward,
identity backward) where a split computation's partial sums leave it.
Where each GPU computes whole rows of its own (a MoE layer's E/K
experts), :func:`gather_from_model` (all-gather forward, the GPU's own
rows of the gradient backward) joins them. Serving's host decisions
(a sampled token) are model index 0's, :func:`broadcast_from_model`.
``tp=None`` is the one-GPU layer, unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as dist
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


def init_from_template(gen: torch.Generator, template, dtype, device,
                       take=None):
    """Materialize a tree of ParamInfo with draws from `gen` (a generator
    on `device`). The draws differ from jax.random's; tests carry JAX's
    weights over with ``models/convert.py`` instead. `take(i, x)`, when
    given, keeps its part of leaf i (one GPU's slice on the model axis)
    as each leaf is drawn whole, so the draws are the whole tree's."""
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

    if take is None:
        return tree_unflatten(treedef, [make(i) for i in leaves])
    return tree_unflatten(treedef, [take(j, make(i))
                                    for j, i in enumerate(leaves)])


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
# The model axis's collectives
# ---------------------------------------------------------------------------


#: The model group's collectives, counted while this is a dict (None, the
#: default, counts nothing): the all-reduces as ``"calls"`` and
#: ``"bytes"`` (each the reduced tensor's), the all-gathers as
#: ``"gather_calls"`` and ``"gather_bytes"`` (each the gathered result's).
#: The dry run reads them apart from the node group's collectives.
COLLECTIVES: Optional[dict] = None


def _count(prefix: str, n_bytes: int) -> None:
    if COLLECTIVES is not None:
        COLLECTIVES[prefix + "calls"] = \
            COLLECTIVES.get(prefix + "calls", 0) + 1
        COLLECTIVES[prefix + "bytes"] = \
            COLLECTIVES.get(prefix + "bytes", 0) + n_bytes


def _all_reduce(x, group, op=dist.ReduceOp.SUM):
    """A fresh contiguous copy of `x`, reduced over `group` in place."""
    y = x.clone(memory_format=torch.contiguous_format)
    _count("", y.numel() * y.element_size())
    dist.all_reduce(y, op=op, group=group)
    return y


def _all_gather(x, group):
    """The K ranks' `x` of `group`, concatenated along dim 0 in rank
    order: ONE all-gather of their bytes (as ``core/bucket.py``
    ``all_gather_model``)."""
    x = x.contiguous()
    k = dist.get_world_size(group)
    out = torch.empty((k,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    _count("gather_", out.numel() * out.element_size())
    flat = x.reshape(-1).view(torch.uint8)
    dist.all_gather(list(out.reshape(k, -1).view(torch.uint8).unbind(0)),
                    flat, group=group)
    return out.reshape((k * x.shape[0],) + tuple(x.shape[1:]))


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over the model group
    backward. Its `vmap` rule applies it to the batched tensor as it lies
    (an elementwise sum, so the batch dim may sit anywhere, as long as it
    sits alike on every rank of the group)."""

    @staticmethod
    def forward(x, group):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.group), None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _CopyToModel.apply(x, group), in_dims[0]


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce over the model group forward; identity backward."""

    @staticmethod
    def forward(x, group):
        return _all_reduce(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        return grad, None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _ReduceFromModel.apply(x, group), in_dims[0]


class _GatherFromModel(torch.autograd.Function):
    """The model group's rows, all-gathered along dim 0, forward; this
    GPU's own rows of the gradient backward, with no sum: the consumer is
    whole on every GPU, so each holds the whole gradient already. Its
    `vmap` rule gathers with the batch dim moved to 1."""

    @staticmethod
    def forward(x, group, index):
        return _all_gather(x, group)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.n, ctx.index = inputs[0].shape[0], inputs[2]

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.index * ctx.n
        return grad[lo:lo + ctx.n], None, None

    @staticmethod
    def vmap(info, in_dims, x, group, index):
        if in_dims[0] is None:
            return _GatherFromModel.apply(x, group, index), None
        return _GatherFromModel.apply(x.movedim(in_dims[0], 1), group,
                                      index), 1


class _MaxOverModel(torch.autograd.Function):
    """The elementwise max over the model group; no gradient (a shift the
    caller's result does not depend on)."""

    @staticmethod
    def forward(x, group):
        return _all_reduce(x.detach(), group, dist.ReduceOp.MAX)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output)

    @staticmethod
    def backward(ctx, grad):
        return None, None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return _MaxOverModel.apply(x, group), in_dims[0]


def copy_to_model(x, tp):
    """`x` entering a computation split over the model axis: the identity,
    whose backward sums the slices' partial gradients over the model
    group (`tp` None: `x`)."""
    return x if tp is None else _CopyToModel.apply(x, tp.group)


def reduce_from_model(x, tp):
    """The slices' partial sums `x`, summed over the model group (`tp`
    None: `x`); its backward hands every slice the whole gradient."""
    return x if tp is None else _ReduceFromModel.apply(x, tp.group)


def gather_from_model(x, tp):
    """Every GPU's rows `x` (this GPU's at model index `tp.index`),
    concatenated along dim 0 in model index order (`tp` None: `x`); its
    backward hands each GPU its own rows of the whole gradient."""
    return x if tp is None else _GatherFromModel.apply(x, tp.group, tp.index)


def broadcast_from_model(x, tp):
    """Model index 0's `x` on every GPU of the node, in place (`tp` None:
    `x`); no gradient. Serving hands its sampled tokens through it, so
    that a node's GPUs feed the same tokens to their next step."""
    if tp is not None:
        x = x.contiguous()
        dist.broadcast(x, src=dist.get_global_rank(tp.group, 0),
                       group=tp.group)
    return x


def max_over_model(x, tp):
    """The elementwise max of `x` over the model group, no gradient."""
    return x if tp is None else _MaxOverModel.apply(x, tp.group)


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


def apply_mlp(cfg, p, x, tp=None):
    """The MLP; on the model axis (`tp`) `w_up` / `w_gate` are column
    slices and `w_down` the matching row slice, so the output's partial
    sums are all-reduced over the model group."""
    x = copy_to_model(x, tp)
    h = torch.matmul(x, p["w_up"])
    if cfg.gated_mlp:
        g = torch.matmul(x, p["w_gate"])
        h = activation(cfg, g) * h
    else:
        h = activation(cfg, h)
    return reduce_from_model(torch.matmul(h, p["w_down"]), tp)


# ---------------------------------------------------------------------------
# Chunked cross-entropy (never materializes the full [B, S, V] logits)
# ---------------------------------------------------------------------------


def chunked_softmax_xent(x, embed, targets, mask=None, chunk: int = 16_384,
                         softcap: float = 0.0, tp=None):
    """Mean CE of logits = x @ embed.T, online logsumexp over vocab chunks
    in fp32. x: [B,S,D], embed: [V,D], targets: [B,S] integer.

    On the model axis (`tp`) `embed` is this GPU's vocab slice (rows
    ``[index * V_local, (index + 1) * V_local)``): the slice's online max
    and sum and the target's logit (from the slice that holds it) are
    the partial statistics, and three [B,S] all-reduces over the model
    group join them (the reference's ``layers.py:184-200``)."""
    if tp is not None:
        return _vocab_parallel_xent(x, embed, targets, mask, chunk, softcap,
                                    tp)
    m, s, tl = _xent_stats(x, embed, targets, chunk, softcap, 0)
    return _mean_nll(m + torch.log(s) - tl, mask)


def _vocab_parallel_xent(x, embed, targets, mask, chunk, softcap, tp):
    x = copy_to_model(x, tp)
    m, s, tl = _xent_stats(x, embed, targets, chunk, softcap,
                           tp.index * embed.shape[0])
    M = max_over_model(m, tp)
    S = reduce_from_model(s * torch.exp(m - M), tp)
    TL = reduce_from_model(tl, tp)
    return _mean_nll(M + torch.log(S) - TL, mask)


def _xent_stats(x, embed, targets, chunk, softcap, v_offset: int):
    """The online (max, sum of exp below it, target logit) over the rows
    of `embed`, the vocabulary's rows ``v_offset`` onwards; a target
    outside them contributes a 0 logit, also where it falls in the last
    chunk's padding (a vocab slice that is not a multiple of `chunk`: the
    next slice's first rows)."""
    V = embed.shape[0]
    chunk = min(chunk, V)
    n_chunks = -(-V // chunk)
    pad_v = n_chunks * chunk - V
    embed_p = F.pad(embed, (0, 0, 0, pad_v)) if pad_v else embed
    targets = targets.to(torch.int64)
    if v_offset:
        targets = targets - v_offset
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
        in_chunk = (loc >= 0) & (loc < min(chunk, V - off))
        tgt = torch.gather(logits, -1,
                           torch.clamp(loc, 0, chunk - 1)[..., None])[..., 0]
        tl = torch.where(in_chunk, tgt, tl)
        m = m_new
    return m, s, tl


def _mean_nll(nll, mask):
    if mask is None:
        return torch.mean(nll)
    mask = mask.to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
