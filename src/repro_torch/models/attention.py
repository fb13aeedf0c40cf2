"""Causal attention for training (``attention_causal`` of
``repro/models/attention.py``), in plain torch ops.

The reference is not a Pallas kernel: SwarmSGD optimizes communication,
not attention, and the JAX package leaves attention to XLA. The port keeps
the reference's online-softmax formulation over KV chunks (query chunks
bound the live score tensor to [B, H, Cq, Ckv]), so the same inputs give
the same numbers up to summation order.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def repeat_kv(k, n_rep: int):
    """[B,S,KVH,hd] -> [B,S,KVH*n_rep,hd]"""
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


def attention_causal(q, k, v, *, q_offset: int = 0, chunk_kv: int = 1024,
                     chunk_q: int = 1024):
    """Global causal attention. q:[B,Sq,H,hd] k,v:[B,Sk,KVH,hd] ->
    [B,Sq,H,hd]."""
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    chunk_q = min(chunk_q, Sq)
    chunk_kv = min(chunk_kv, Sk)
    assert Sq % chunk_q == 0 and Sk % chunk_kv == 0, (Sq, chunk_q, Sk,
                                                      chunk_kv)
    nq, nk = Sq // chunk_q, Sk // chunk_kv
    kf = repeat_kv(k, H // KVH)
    vf = repeat_kv(v, H // KVH)
    scale = hd ** -0.5
    outs = []
    for qi in range(nq):
        qc = q[:, qi * chunk_q:(qi + 1) * chunk_q]
        qpos = q_offset + qi * chunk_q + torch.arange(chunk_q,
                                                      device=q.device)
        m = torch.full((B, H, chunk_q), NEG_INF, dtype=torch.float32,
                       device=q.device)
        s = torch.zeros((B, H, chunk_q), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, chunk_q, hd), dtype=torch.float32,
                          device=q.device)
        for ki in range(nk):
            kc = kf[:, ki * chunk_kv:(ki + 1) * chunk_kv]
            vc = vf[:, ki * chunk_kv:(ki + 1) * chunk_kv]
            kpos = ki * chunk_kv + torch.arange(chunk_kv, device=q.device)
            logits = torch.einsum("bqhd,bkhd->bhqk", qc, kc).to(torch.float32)
            logits = logits * scale
            mask = qpos[:, None] >= kpos[None, :]
            logits = torch.where(mask[None, None], logits, NEG_INF)
            m_new = torch.maximum(m, torch.amax(logits, dim=-1))
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m - m_new)
            s = s * corr + torch.sum(p, dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p, vc.to(torch.float32))
            m = m_new
        out = acc / torch.clamp_min(s, 1e-30)[..., None]
        outs.append(out.permute(0, 2, 1, 3).to(q.dtype))      # [B,Cq,H,hd]
    return outs[0] if nq == 1 else torch.cat(outs, dim=1)
