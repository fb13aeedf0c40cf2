"""Mamba2 (SSD — state-space duality) block, ``repro/models/ssm.py`` in
plain torch ops. arXiv:2405.21060.

Chunked SSD forward (quadratic intra-chunk + linear inter-chunk
recurrence), a single-token decode step and a T-token chunk step with
(conv, ssm) state, and the param template.

Layout follows the reference Mamba2 block:
  in_proj: d_model -> [z (d_in), x (d_in), B (G*N), C (G*N), dt (nh)]
  causal depthwise conv(k) over [x, B, C]; silu
  SSD with A = -exp(A_log) (per head), discretized per-token by dt
  gated RMSNorm(y * silu(z)); out_proj: d_in -> d_model

Every step keeps the reference's dtype: the SSD runs in fp32 on widened
inputs whatever the parameter dtype, and the block's input and output stay
in the model dtype. The chunk step takes ``n_valid`` per lane ([B]) where
the reference vmaps a scalar over the serving engine's slots.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import ParamInfo, per_lane, rms_norm_simple


def dims(cfg):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return d_in, nh, conv_dim


def mamba_template(cfg):
    s = cfg.ssm
    d = cfg.d_model
    d_in, nh, conv_dim = dims(cfg)
    proj_out = 2 * d_in + 2 * s.n_groups * s.d_state + nh
    return {
        "in_proj": ParamInfo((d, proj_out), ("embed", "ssm_proj")),
        "conv_w": ParamInfo((s.conv_kernel, conv_dim), (None, "ssm_conv"),
                            "normal", 0.5),
        "A_log": ParamInfo((nh,), ("ssm_head",), "zeros"),
        "dt_bias": ParamInfo((nh,), ("ssm_head",), "zeros"),
        "D": ParamInfo((nh,), ("ssm_head",), "ones"),
        "gate_norm": ParamInfo((d_in,), ("ssm_inner",), "ones"),
        "out_proj": ParamInfo((d_in, d), ("ssm_inner", "embed")),
    }


def _split_proj(cfg, zxbcdt):
    s = cfg.ssm
    d_in, nh, _ = dims(cfg)
    gn = s.n_groups * s.d_state
    return torch.split(zxbcdt, [d_in, d_in, gn, gn, nh], dim=-1)


def _conv_causal(xBC, conv_w):
    """Depthwise causal conv over time. xBC:[B,S,Cd], conv_w:[K,Cd]."""
    K, S = conv_w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = pad[:, 0:S, :] * conv_w[0][None, None, :]
    for i in range(1, K):
        out = out + pad[:, i:i + S, :] * conv_w[i][None, None, :]
    return F.silu(out)


def ssd_chunked(x, dt, A, B, C, chunk: int, state0=None):
    """SSD scan. x:[b,S,nh,hd] dt:[b,S,nh] A:[nh] B,C:[b,S,G,N].

    Returns y:[b,S,nh,hd] and final state [b,nh,hd,N]. ``state0`` seeds
    the carried state (default zeros): chunked prefill resumes the
    recurrence from the previous chunk's state. A token with dt == 0 is an
    exact no-op on the state (decay exp(0·A)=1, update dt·B·x=0), which is
    how length-masked chunks keep ragged prompts from polluting the
    recurrence."""
    b, S, nh, hd = x.shape
    G, N = B.shape[2], B.shape[3]
    assert S % chunk == 0, (S, chunk)
    nc = S // chunk
    rep = nh // G
    Bh = torch.repeat_interleave(B, rep, dim=2)        # [b,S,nh,N]
    Ch = torch.repeat_interleave(C, rep, dim=2)
    xc = x.reshape(b, nc, chunk, nh, hd)
    dtc = dt.reshape(b, nc, chunk, nh)
    Bc = Bh.reshape(b, nc, chunk, nh, N)
    Cc = Ch.reshape(b, nc, chunk, nh, N)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))
    state = torch.zeros((b, nh, hd, N), dtype=x.dtype, device=x.device) \
        if state0 is None else state0.to(x.dtype)
    ys = []
    for c in range(nc):
        xq, dtq, Bq, Cq = xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c]
        dA = dtq * A[None, None, :]                    # [b,q,nh] (negative)
        dA_cum = torch.cumsum(dA, dim=1)
        # intra-chunk (quadratic): L[i,j] = exp(dA_cum[i]-dA_cum[j]), i>=j
        seg = dA_cum[:, :, None, :] - dA_cum[:, None, :, :]   # [b,i,j,nh]
        L = torch.where(causal[None, :, :, None], torch.exp(seg),
                        torch.zeros((), dtype=seg.dtype, device=x.device))
        scores = torch.einsum("bihn,bjhn->bijh", Cq, Bq)
        y_intra = torch.einsum("bijh,bjh,bjhp->bihp",
                               scores * L.to(scores.dtype), dtq, xq)
        # inter-chunk: contribution of the carried state
        decay_from_start = torch.exp(dA_cum)           # [b,q,nh]
        y_inter = torch.einsum("bqhn,bhpn->bqhp", Cq, state) * \
            decay_from_start[..., None]
        # update carried state
        decay_to_end = torch.exp(dA_cum[:, -1:, :] - dA_cum)
        cs = torch.einsum("bqh,bqhn,bqhp->bhpn", decay_to_end * dtq, Bq, xq)
        cd = torch.exp(dA_cum[:, -1, :])
        state = state * cd[:, :, None, None] + cs
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, dim=1).reshape(b, S, nh, hd)
    return y, state


def mask_padded_dt(dt, n_valid):
    """Zero dt [B,T,nh] at each lane's tokens t >= n_valid [B]. The mask
    comes AFTER the softplus: dt == 0 makes a padded token an exact no-op
    on the SSD state."""
    T = dt.shape[1]
    live = torch.arange(T, device=dt.device)[None, :, None] < \
        n_valid[:, None, None]
    return torch.where(live, dt, torch.zeros((), device=dt.device))


def _gate_out(cfg, p, y, z, x_dtype):
    """y [B,S,d_in] fp32 -> gated RMSNorm(y * silu(z)) @ out_proj."""
    y = y.to(x_dtype)
    y = rms_norm_simple(y * F.silu(z.to(torch.float32)).to(x_dtype),
                        p["gate_norm"])
    return torch.matmul(y, p["out_proj"])


def apply_mamba(cfg, p, x, *, state=None, mode: str = "train",
                n_valid=None):
    """x:[B,S,D]. mode train/prefill: chunked SSD (prefill also returns
    the final (conv, ssm) state). mode decode: S==1 single-step update of
    `state`. mode chunk: S==T tokens extend `state` in one step (chunked
    prefill); only the first ``n_valid`` tokens (scalar or per lane) are
    real — the rest are exact no-ops on both the conv window and the SSD
    recurrence."""
    s = cfg.ssm
    d_in, nh, conv_dim = dims(cfg)
    gn = s.n_groups * s.d_state
    zxbcdt = torch.matmul(x, p["in_proj"])
    z, xs, B, C, dt = _split_proj(cfg, zxbcdt)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"].to(torch.float32))
    A = -torch.exp(p["A_log"].to(torch.float32))
    D = p["D"].to(torch.float32)
    bsz, S = x.shape[0], x.shape[1]

    if mode == "decode":
        assert state is not None
        # conv [B,K-1,Cd], ssm [B,nh,hd,N]
        conv_st, ssm_st = state["conv"], state["ssm"]
        xBC = torch.cat([xs, B, C], dim=-1)             # [B,1,Cd]
        window = torch.cat([conv_st, xBC], dim=1)       # [B,K,Cd]
        conv = torch.einsum("bkc,kc->bc", window, p["conv_w"])
        conv = F.silu(conv)[:, None, :]
        xs2, B2, C2 = torch.split(conv, [d_in, gn, gn], dim=-1)
        xh = xs2.reshape(bsz, nh, s.head_dim)
        rep = nh // s.n_groups
        Bh = torch.repeat_interleave(
            B2.reshape(bsz, s.n_groups, s.d_state), rep, dim=1)
        Ch = torch.repeat_interleave(
            C2.reshape(bsz, s.n_groups, s.d_state), rep, dim=1)
        dt1 = dt[:, 0]                                   # [B,nh]
        decay = torch.exp(dt1 * A[None, :])              # [B,nh]
        upd = torch.einsum("bhn,bhp->bhpn", Bh.to(torch.float32),
                           xh.to(torch.float32)) * dt1[:, :, None, None]
        ssm_new = ssm_st * decay[:, :, None, None] + upd.to(ssm_st.dtype)
        y = torch.einsum("bhn,bhpn->bhp", Ch.to(torch.float32),
                         ssm_new.to(torch.float32))
        y = y + D[None, :, None] * xh.to(torch.float32)
        out = _gate_out(cfg, p, y.reshape(bsz, 1, d_in), z, x.dtype)
        return out, {"conv": window[:, 1:, :], "ssm": ssm_new}

    if mode == "chunk":
        assert state is not None and n_valid is not None
        conv_st, ssm_st = state["conv"], state["ssm"]
        K = s.conv_kernel
        xBC = torch.cat([xs, B, C], dim=-1)              # [B,T,Cd]
        ext = torch.cat([conv_st.to(xBC.dtype), xBC], dim=1)
        conv = ext[:, 0:S, :] * p["conv_w"][0][None, None, :]
        for i in range(1, K):
            conv = conv + ext[:, i:i + S, :] * p["conv_w"][i][None, None, :]
        conv = F.silu(conv)                              # [B,T,Cd]
        xs2, B2, C2 = torch.split(conv, [d_in, gn, gn], dim=-1)
        xh = xs2.reshape(bsz, S, nh, s.head_dim)
        Bg = B2.reshape(bsz, S, s.n_groups, s.d_state)
        Cg = C2.reshape(bsz, S, s.n_groups, s.d_state)
        nv = per_lane(n_valid, bsz, x.device)
        dt = mask_padded_dt(dt, nv)
        y, final = ssd_chunked(xh.to(torch.float32), dt, A,
                               Bg.to(torch.float32), Cg.to(torch.float32),
                               S, state0=ssm_st.to(torch.float32))
        y = y + D[None, None, :, None] * xh.to(torch.float32)
        out = _gate_out(cfg, p, y.reshape(bsz, S, d_in), z, x.dtype)
        # conv window ending at the last VALID token: ext rows
        # [n_valid, n_valid+K-2]. n_valid==0 passes conv_st through.
        rows = nv[:, None] + torch.arange(K - 1, device=x.device)[None, :]
        new_conv = torch.gather(
            ext, 1, rows[:, :, None].expand(bsz, K - 1, ext.shape[2]))
        return out, {"conv": new_conv.to(conv_st.dtype),
                     "ssm": final.to(ssm_st.dtype)}

    xBC = torch.cat([xs, B, C], dim=-1)
    conv = _conv_causal(xBC, p["conv_w"])
    xs2, B2, C2 = torch.split(conv, [d_in, gn, gn], dim=-1)
    xh = xs2.reshape(bsz, S, nh, s.head_dim)
    Bg = B2.reshape(bsz, S, s.n_groups, s.d_state)
    Cg = C2.reshape(bsz, S, s.n_groups, s.d_state)
    y, final = ssd_chunked(xh.to(torch.float32), dt, A,
                           Bg.to(torch.float32), Cg.to(torch.float32),
                           min(s.chunk, S))
    y = y + D[None, None, :, None] * xh.to(torch.float32)
    out = _gate_out(cfg, p, y.reshape(bsz, S, d_in), z, x.dtype)
    if mode == "prefill":
        K = s.conv_kernel
        tail = xBC[:, -(K - 1):, :]
        pad = K - 1 - min(K - 1, S)
        if pad:
            tail = F.pad(tail, (0, 0, pad, 0))
        return out, {"conv": tail, "ssm": final.to(x.dtype)}
    return out, None


def init_mamba_state(cfg, batch: int, dtype, device):
    s = cfg.ssm
    d_in, nh, conv_dim = dims(cfg)
    return {
        "conv": torch.zeros((batch, s.conv_kernel - 1, conv_dim),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, nh, s.head_dim, s.d_state), dtype=dtype,
                           device=device),
    }
