"""Mixture-of-Experts FFN (``repro/models/moe.py``): token-choice top-k
routing with capacity, GShard positions by cumsum, the Switch load-balance
auxiliary loss, and index-based dispatch into [E, C, D] expert buffers,
so compute is proportional to the active parameters.

Every step keeps the reference's numerics and is out of place, so it runs
under ``torch.func.vmap`` over the node axis and under ``grad``:

* the router's logits are computed in the model dtype and only then
  widened to fp32, as the reference's;
* ``jax.lax.top_k`` puts the lower index first on ties; ``torch.topk``
  promises no order, so the choices come from a stable descending sort;
* dispatch adds each kept token's row into its own (expert, slot) of a
  zero buffer; a token dropped by capacity has its slot clipped to C - 1
  and its row zeroed, so it adds an exact 0 to whatever lands there;
* the combine gathers the [T, k, D] expert outputs and sums the k choices
  in a fixed loop from fp32 zeros — never an atomic ``index_add_``, whose
  order on the card is not fixed — which is the reference's sequential
  scatter-add of the same terms.

The expert products ``ecd,edf->ecf`` are batched matmuls; the reference
computes them outside any Pallas kernel too.

On a node split over K GPUs (`tp`, ``models/split.py``) the layer's input
is whole on every GPU (training's batch axes are None outside
``big_model``, ``specs.py`` ``batch_axes_for``), so every GPU routes the
same tokens into the same [E, C, D] buffer; only the expert FFN
(:func:`expert_ffn`) is split, and the reference's partitioner's
collectives at the buffer's boundary are placed by hand:

* the buffer enters through ``copy_to_model``: the dispatch path's
  gradient is partial on each GPU (by d_ff slice or by expert) and is
  summed over the model group. The router's path from the input is
  computed whole on every GPU, so it is not wrapped: its gradient is the
  whole gradient already and a sum would count it K times;
* ``expert_ffn`` split (granite-moe-3b-a800m): ``w_up`` / ``w_gate`` are
  column slices and ``w_down`` the matching row slice of every expert,
  and ``reduce_from_model`` sums the partial [E, C, D] outputs, as
  ``layers.py`` ``apply_mlp`` does per expert;
* ``expert`` split (qwen3-moe-30b-a3b): each GPU runs its own E/K
  experts (experts ``[index * E/K, (index + 1) * E/K)``, the slices
  ``split.py`` ``take_slice`` cuts) on their rows of the buffer, and
  ``gather_from_model`` joins the outputs along E. Gather-back and
  combine then run whole on every GPU, the combine the one-GPU k-loop
  from fp32 zeros.

The input, the router and the buffer are then bitwise the same on the
node's GPUs, and so are the routing choices and every whole leaf's
gradient, with no all-reduce of the engine's own.

With ``per_lane`` (the serving engine's decode and chunk steps) each lane
of the [B, S, D] call routes and dispatches on its own, as the reference's
engine does by vmapping a batch-1 forward over its slots: a lane's
capacity is that of its own S tokens, its positions a cumsum over its own
tokens, and its rows land in its own [E, C, D] buffer, so one lane's
tokens never take a slot in another's; the experts still run as one
batched product over every lane's buffer.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.models.layers import (ParamInfo, activation,
                                       copy_to_model, gather_from_model,
                                       reduce_from_model)


def moe_template(cfg):
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_ff, m.n_experts
    t = {
        "router": ParamInfo((d, E), ("embed", "expert_unsharded"),
                            "normal", 0.02),
        "w_up": ParamInfo((E, d, f), ("expert", "embed", "expert_ffn")),
        "w_down": ParamInfo((E, f, d), ("expert", "expert_ffn", "embed")),
    }
    if cfg.gated_mlp:
        t["w_gate"] = ParamInfo((E, d, f), ("expert", "embed", "expert_ffn"))
    return t


def capacity(cfg, n_tokens: int) -> int:
    """Slots per expert for a call of `n_tokens` tokens (rounded up to a
    multiple of 8, at least 8, as the reference's)."""
    m = cfg.moe
    c = int(math.ceil(m.capacity_factor * n_tokens * m.top_k / m.n_experts))
    return max(8, -(-c // 8) * 8)


def route(cfg, router_w, x_flat):
    """x_flat:[T,D] -> gates [T,k] fp32, expert idx [T,k], aux loss."""
    m = cfg.moe
    logits = torch.matmul(x_flat, router_w).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :m.top_k], idx[:, :m.top_k]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    experts = torch.arange(m.n_experts, device=x_flat.device)
    top1 = (idx[:, :1] == experts).to(torch.float32)          # [T,E]
    f_e = torch.mean(top1, dim=0)
    P_e = torch.mean(probs, dim=0)
    aux = m.n_experts * torch.sum(f_e * P_e)
    return gates, idx, aux


def dispatch_positions(cfg, idx, T: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slot of each (token, choice) in its expert's capacity buffer: the
    k choices in priority order, a cumsum of the one-hot assignment over
    tokens. idx is [T,k], or [L,T,k] for L lanes dispatched each on its
    own (a cumsum over each lane's T tokens). -> pos (clipped to C - 1)
    and keep, idx's shape."""
    m = cfg.moe
    C = capacity(cfg, T)
    experts = torch.arange(m.n_experts, device=idx.device)
    counts = torch.zeros(idx.shape[:-2] + (m.n_experts,), dtype=torch.int64,
                         device=idx.device)
    pos_list, keep_list = [], []
    for j in range(m.top_k):
        e = idx[..., j]
        oh = (e[..., None] == experts).to(torch.int64)        # [..,T,E]
        pos_in_e = torch.cumsum(oh, dim=-2) - oh              # 0-based
        pos_j = torch.sum(pos_in_e * oh, dim=-1) + \
            torch.gather(counts, -1, e)
        keep_list.append(pos_j < C)
        pos_list.append(torch.clamp(pos_j, max=C - 1))
        counts = counts + torch.sum(oh, dim=-2)
    return torch.stack(pos_list, -1), torch.stack(keep_list, -1)


def _ffn(cfg, p, buf):
    """The experts' FFN of their buffers: [E, C, D] -> [E, C, D]."""
    h = torch.bmm(buf, p["w_up"])
    if cfg.gated_mlp:
        h = activation(cfg, torch.bmm(buf, p["w_gate"])) * h
    else:
        h = activation(cfg, h)
    return torch.bmm(h, p["w_down"])


def expert_ffn(cfg, p, buf, tp=None):
    """Every expert's FFN of the dispatched buffer [E, C, D], whole on
    every GPU of the node; on the model axis (`tp`) from this GPU's
    slices of the expert weights (the module docstring): the experts' own
    rows gathered (``expert`` split, fewer experts than E here) or the
    d_ff slices' partial sums reduced (``expert_ffn`` split)."""
    if tp is None:
        return _ffn(cfg, p, buf)
    buf = copy_to_model(buf, tp)
    n = p["w_up"].shape[0]
    if n != cfg.moe.n_experts:
        own = buf[tp.index * n:(tp.index + 1) * n]
        return gather_from_model(_ffn(cfg, p, own), tp)
    return reduce_from_model(_ffn(cfg, p, buf), tp)


def apply_moe(cfg, p, x, *, per_lane: bool = False, tp=None):
    """x:[B,S,D] -> ([B,S,D], aux loss). Capacity is that of the call's
    B*S tokens, as the reference's; with `per_lane` that of each lane's S
    tokens, each lane dispatched into its own buffer (the module
    docstring). The aux loss is the call's either way (the engine, the
    one caller with `per_lane`, discards it). `tp`: this GPU's share of
    a node split over the model axis, `p`'s expert weights its slices."""
    m = cfg.moe
    B, S, D = x.shape
    T, E, k = B * S, m.n_experts, m.top_k
    L, S_l = (B, S) if per_lane else (1, T)   # lanes, tokens a lane
    xf = x.reshape(T, D)
    gates, idx, aux = route(cfg, p["router"], xf)
    pos, keep = dispatch_positions(cfg, idx.reshape(L, S_l, k), S_l)
    C = capacity(cfg, S_l)
    lane = torch.arange(L, device=x.device).reshape(L, 1, 1)
    slot = (((lane * E + idx.reshape(L, S_l, k)) * C) + pos).reshape(-1)
    keep_f = keep.reshape(-1)
    rows = xf.repeat_interleave(k, dim=0)                     # token order
    data = torch.where(keep_f[:, None], rows, torch.zeros_like(rows))
    buf = torch.zeros((L * E * C, D), dtype=x.dtype, device=x.device)
    buf = buf.scatter_add(0, slot[:, None].expand(-1, D), data)
    # every lane's rows of one expert side by side: [E, L*C, D]
    buf = buf.reshape(L, E, C, D).transpose(0, 1).reshape(E, L * C, D)

    out_buf = expert_ffn(cfg, p, buf, tp).reshape(E, L, C, D) \
        .transpose(0, 1).reshape(L * E * C, D)

    gathered = torch.gather(out_buf, 0, slot[:, None].expand(-1, D))
    w = (gates.reshape(-1) * keep_f).to(torch.float32)
    terms = (gathered.to(torch.float32) * w[:, None]).reshape(T, k, D)
    combined = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    for j in range(k):
        combined = combined + terms[:, j]
    return combined.reshape(B, S, D).to(x.dtype), aux
