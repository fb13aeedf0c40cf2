"""Attention in plain torch ops (``repro/models/attention.py``):

* ``attention_causal`` — training and prefill: the reference's
  online-softmax formulation over KV chunks (query chunks bound the live
  score tensor to [B, H, Cq, Ckv]);
* ``attention_banded`` — sliding-window training and prefill: each query
  chunk attends only its [qpos - W, qpos] band, O(S * (W + C)) compute;
* ``attention_decode`` — one query token over a KV cache;
* ``attention_chunk_decode`` — a T-token chunk of queries over a cache
  that already holds the chunk's own rows (chunked prefill);
* ``gather_pages`` — a lane's page table over a page pool back to the
  contiguous cache layout (paged KV).

The reference is not a Pallas kernel: SwarmSGD optimizes communication,
not attention, and the JAX package leaves attention to XLA, so the same
inputs give the same numbers up to summation order. The decode paths take
``cache_len`` as a scalar, as the reference does, or as one length per
lane ``[B]``: the serving engine runs its slots as one batch where the
reference vmaps a batch-1 call over them. The reference's bf16 products
with ``preferred_element_type=float32`` are fp32 products of the widened
operands here (exact: a bf16 product fits fp32).
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import per_lane

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


def attention_banded(q, k, v, *, window: int, q_offset: int = 0,
                     chunk_q: int = 1024):
    """Sliding-window causal attention: query chunk i attends keys in
    [i*C - W, i*C + C). Compute O(Sq * (W + C)); when the band covers
    every key, the dense path with a window mask."""
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    chunk_q = min(chunk_q, Sq)
    if Sk <= window + chunk_q:
        return _windowed_dense(q, k, v, window=window, q_offset=q_offset)
    assert Sq % chunk_q == 0, (Sq, chunk_q)
    band = window + chunk_q
    kf = repeat_kv(k, H // KVH)
    vf = repeat_kv(v, H // KVH)
    outs = []
    for qi in range(Sq // chunk_q):
        qc = q[:, qi * chunk_q:(qi + 1) * chunk_q]
        qpos = q_offset + qi * chunk_q + torch.arange(chunk_q,
                                                      device=q.device)
        start = min(max(q_offset + qi * chunk_q - window, 0), Sk - band)
        kpos = start + torch.arange(band, device=q.device)
        logits = torch.einsum("bqhd,bkhd->bhqk", qc,
                              kf[:, start:start + band]).to(torch.float32)
        logits = logits * hd ** -0.5
        mask = (qpos[:, None] >= kpos[None, :]) & \
            (qpos[:, None] - kpos[None, :] < window)
        logits = torch.where(mask[None, None], logits, NEG_INF)
        p = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", p,
                           vf[:, start:start + band].to(torch.float32))
        outs.append(out.to(q.dtype))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def _windowed_dense(q, k, v, *, window: int, q_offset: int):
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    kf = repeat_kv(k, H // k.shape[2])
    vf = repeat_kv(v, H // v.shape[2])
    qpos = q_offset + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, kf).to(torch.float32) * \
        hd ** -0.5
    mask = (qpos[:, None] >= kpos[None, :]) & \
        (qpos[:, None] - kpos[None, :] < window)
    logits = torch.where(mask[None, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p,
                        vf.to(torch.float32)).to(q.dtype)


def gather_pages(pool, pages):
    """Reconstruct contiguous KV caches from a page pool.

    pool:[n_pages, page, KVH, hd], pages:[n_pp] (a lane's page table row)
    -> [1, n_pp*page, KVH, hd], or pages:[B, n_pp] -> [B, n_pp*page, KVH,
    hd]: row ``i`` of a lane's result is row ``i % page`` of page
    ``pages[i // page]`` — exactly the contiguous cache layout, so the
    attention below is bitwise the dense path. Unallocated table entries
    (-1) read the last page, as the reference's indexing wraps; every
    position they cover is beyond the lane's length and masked to NEG_INF
    before the softmax, so the garbage never reaches the output."""
    n_pp, (page, kvh, hd) = pages.shape[-1], pool.shape[1:]
    out = pool[pages.reshape(-1, n_pp).to(torch.int64)]
    return out.reshape(-1, n_pp * page, kvh, hd)


def attention_chunk_decode(q, k_cache, v_cache, cache_len, *, window: int = 0,
                           min_kpos=0):
    """T-query chunk decode: q:[B,T,H,hd] at absolute positions
    ``cache_len + t`` over a cache whose rows [0, cache_len + T) are
    populated (the chunk's own k/v already written). Query t attends keys
    at positions <= cache_len + t; ``window`` > 0 additionally bounds the
    lookback and ``min_kpos`` invalidates rows below it. T=1 is the
    single-token decode (same mask, same math)."""
    B, T, H, hd = q.shape
    Sc, KVH = k_cache.shape[1], k_cache.shape[2]
    kf = repeat_kv(k_cache, H // KVH)
    vf = repeat_kv(v_cache, H // KVH)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          kf.to(torch.float32)) * (hd ** -0.5)
    dev = q.device
    qpos = per_lane(cache_len, B, dev)[:, None] + \
        torch.arange(T, device=dev)                          # [B,T]
    kpos = torch.arange(Sc, device=dev)[None, None, :]       # row == pos
    valid = (kpos <= qpos[:, :, None]) & \
        (kpos >= per_lane(min_kpos, B, dev)[:, None, None])    # [B,T,Sc]
    if window:
        valid = valid & (qpos[:, :, None] - kpos < window)
    logits = torch.where(valid[:, None], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).to(torch.float32),
                       vf.to(torch.float32))
    return out.to(q.dtype)


def attention_decode(q, k_cache, v_cache, cache_len, *, window: int = 0):
    """One-token decode. q:[B,1,H,hd]; k_cache/v_cache:[B,Sc,KVH,hd];
    ``cache_len`` — number of valid cache entries (scalar or per lane);
    rows i < min(cache_len, Sc) are valid (a ring-buffered sliding-window
    cache of size Sc with ``window`` > 0 reads the same way)."""
    B, _, H, hd = q.shape
    Sc, KVH = k_cache.shape[1], k_cache.shape[2]
    kf = repeat_kv(k_cache, H // KVH)
    vf = repeat_kv(v_cache, H // KVH)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          kf.to(torch.float32)) * (hd ** -0.5)
    clen = per_lane(cache_len, B, q.device)
    valid = torch.arange(Sc, device=q.device)[None, :] < \
        torch.clamp(clen, max=Sc)[:, None]                   # [B,Sc]
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype).to(torch.float32),
                       vf.to(torch.float32))
    return out.to(q.dtype)
