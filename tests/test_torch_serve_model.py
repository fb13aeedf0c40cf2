"""The port's inference half of the model against the JAX package, on the
CPU, from identical weights (``models/convert.py``) and identical numpy
inputs: decode attention, page gathers, the SSD scan and the Mamba2 block
in every mode, then ``forward`` in prefill / decode / chunk mode and
``logits_head`` for transformer-wmt, olmo-1b and mamba2-780m at
``reduced(n_layers=2, d_model=32)``, fp32.

Tolerance: 1e-5 absolute on logits, hidden states and Mamba states
(jitted XLA and eager torch sum in different orders; fp32), and greedy
tokens equal. The length-masking contracts (dt = 0 padding, cache writes)
are bitwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, reduced as jreduced
from repro.models import attention as jattn
from repro.models import forward as jforward
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models import loss_fn as jloss_fn
from repro.models import param_template as jparam_template
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro.serve.engine import grow_cache as jgrow_cache
from repro_torch.configs import get_config, reduced
from repro_torch.models import (attention, forward, init_cache, logits_head,
                                loss_fn, param_template, ssm)
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.serve.engine import grow_cache
from repro_torch.tree import tree_flatten, tree_key_paths

ARCHS = ["transformer-wmt", "olmo-1b", "mamba2-780m"]
ATOL = 1e-5
# the reference's forward, jitted once per mode (eager JAX dispatch of the
# whole stack costs more than its compile)
_jfwd = jax.jit(jforward, static_argnums=(0,), static_argnames=("mode",))


def _cfgs(arch, layers_=2, d_model=32):
    return (jreduced(jget_config(arch), n_layers=layers_, d_model=d_model),
            reduced(get_config(arch), n_layers=layers_, d_model=d_model))


_NP_WEIGHTS = {}


def _weights(jc, seed=0):
    """JAX's init for (config, seed), drawn once per module; each call
    hands out fresh copies in both packages."""
    key = (jc, seed)
    if key not in _NP_WEIGHTS:
        _NP_WEIGHTS[key] = jax.device_get(
            jinit_params(jax.random.PRNGKey(seed), jc))
    np_tree = _NP_WEIGHTS[key]
    return (jax.tree.map(jnp.asarray, np_tree),
            params_from_numpy(np_tree, "cpu"))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(j, t, atol=ATOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=0,
                               atol=atol)


def _caches_close(jcache, tcache, atol=ATOL):
    jl = jax.tree.leaves(jcache)
    tl = tree_flatten(tcache)[0]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        _close(a, b.to(torch.float32) if b.is_floating_point() else b, atol)


# ---------------------------------------------------------------------------
# Configs and templates
# ---------------------------------------------------------------------------


def test_mamba_config_equals_jax():
    jc, tc = jget_config("mamba2-780m"), get_config("mamba2-780m")
    assert dataclasses.asdict(tc) == {
        k: v for k, v in dataclasses.asdict(jc).items()
        if k in {f.name for f in dataclasses.fields(tc)}}
    assert tc.n_params() == jc.n_params() == 779_989_248
    jr, tr = _cfgs("mamba2-780m")
    assert dataclasses.asdict(tr)["ssm"] == dataclasses.asdict(jr)["ssm"]
    assert tr.n_params() == jr.n_params()


@pytest.mark.parametrize("arch", ARCHS)
def test_param_template_and_cache_equal_jax(arch):
    jc, tc = _cfgs(arch)
    from repro.models.layers import is_info
    jt = jax.tree_util.tree_flatten_with_path(jparam_template(jc),
                                              is_leaf=is_info)[0]
    tleaves, _ = tree_flatten(param_template(tc))
    assert [(ti.shape, ti.axes, ti.init, ti.scale) for ti in tleaves] == \
        [(ji.shape, ji.axes, ji.init, ji.scale) for _, ji in jt]
    jcache = jinit_cache(jc, 3, 16)
    tcache = init_cache(tc, 3, 16, device="cpu")
    jpaths = [tuple(k.key for k in p) for p, _ in
              jax.tree_util.tree_flatten_with_path(jcache)[0]]
    assert tree_key_paths(tcache) == jpaths
    assert [tuple(x.shape) for x in tree_flatten(tcache)[0]] == \
        [x.shape for x in jax.tree.leaves(jcache)]


def test_convert_roundtrip_mamba_leaves():
    jc, _ = _cfgs("mamba2-780m")
    np_tree = jax.device_get(jinit_params(jax.random.PRNGKey(3), jc))
    np_tree = jax.tree.map(lambda a: a + np.float32(0.25), np_tree)
    back = params_to_numpy(params_from_numpy(np_tree, "cpu"))
    mamba = back["blocks"]["layer_0"]["mamba"]
    assert set(mamba) == {"A_log", "D", "conv_w", "dt_bias", "gate_norm",
                          "in_proj", "out_proj"}
    for a, b in zip(jax.tree.leaves(np_tree), tree_flatten(back)[0]):
        assert np.array_equal(a, b)


# ---------------------------------------------------------------------------
# Attention decode paths and page gathers
# ---------------------------------------------------------------------------


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("cache_len", [0, 5, 11])
def test_attention_decode_equals_jax(cache_len):
    rng = np.random.default_rng(cache_len)
    q, k, v = _rand(rng, 2, 1, 4, 8), _rand(rng, 2, 12, 2, 8), \
        _rand(rng, 2, 12, 2, 8)
    want = jattn.attention_decode(q, k, v, jnp.int32(cache_len + 1))
    got = attention.attention_decode(_t(q), _t(k), _t(v), cache_len + 1)
    _close(want, got)


@pytest.mark.parametrize("cache_len,window,min_kpos",
                         [(0, 0, 0), (3, 0, 0), (6, 0, 2), (5, 4, 0)])
def test_attention_chunk_decode_equals_jax(cache_len, window, min_kpos):
    rng = np.random.default_rng(cache_len + window)
    q, k, v = _rand(rng, 2, 4, 4, 8), _rand(rng, 2, 12, 4, 8), \
        _rand(rng, 2, 12, 4, 8)
    want = jattn.attention_chunk_decode(q, k, v, jnp.int32(cache_len),
                                        window=window, min_kpos=min_kpos)
    got = attention.attention_chunk_decode(_t(q), _t(k), _t(v), cache_len,
                                           window=window, min_kpos=min_kpos)
    _close(want, got)


def test_chunk_decode_per_lane_equals_each_lane():
    """A per-lane length [B] is each lane's scalar call, bitwise."""
    rng = np.random.default_rng(1)
    q, k, v = _t(_rand(rng, 3, 4, 2, 8)), _t(_rand(rng, 3, 12, 2, 8)), \
        _t(_rand(rng, 3, 12, 2, 8))
    lens = torch.tensor([0, 5, 8])
    got = attention.attention_chunk_decode(q, k, v, lens)
    for b in range(3):
        one = attention.attention_chunk_decode(q[b:b + 1], k[b:b + 1],
                                               v[b:b + 1], int(lens[b]))
        assert torch.equal(got[b:b + 1], one)


def test_gather_pages_equals_jax_and_wraps_minus_one():
    rng = np.random.default_rng(0)
    pool = _rand(rng, 6, 4, 2, 3)
    table = np.array([4, 0, -1], np.int32)
    want = jattn.gather_pages(jnp.asarray(pool), jnp.asarray(table))
    got = attention.gather_pages(_t(pool), _t(table))
    assert np.array_equal(np.asarray(want), got.numpy())
    both = attention.gather_pages(_t(pool), _t(np.stack([table, table[::-1]])))
    assert torch.equal(both[0:1], got)
    assert torch.equal(both[1, :4], _t(pool)[-1])     # -1 reads the last page


def test_cache_writes_equal_jax_per_lane():
    rng = np.random.default_rng(2)
    cache = _rand(rng, 2, 10, 2, 3)
    new1, newT = _rand(rng, 2, 1, 2, 3), _rand(rng, 2, 4, 2, 3)
    idx = [3, 9]
    got1 = tf._cache_write(_t(cache), _t(new1), torch.tensor(idx))
    gotT = tf._cache_write_chunk(_t(cache), _t(newT), torch.tensor(idx))
    for b in range(2):
        w1 = jtf._cache_write(cache[b:b + 1], new1[b:b + 1], idx[b])
        wT = jtf._cache_write_chunk(cache[b:b + 1], newT[b:b + 1], idx[b])
        assert np.array_equal(np.asarray(w1), got1[b:b + 1].numpy())
        assert np.array_equal(np.asarray(wT), gotT[b:b + 1].numpy())


# ---------------------------------------------------------------------------
# SSD scan and the Mamba2 block
# ---------------------------------------------------------------------------


def _ssd_inputs(rng, b=2, S=16, nh=4, hd=8, G=1, N=6):
    x = _rand(rng, b, S, nh, hd)
    dt = np.abs(_rand(rng, b, S, nh)) * 0.5
    A = -np.abs(_rand(rng, nh)) - 0.1
    B, C = _rand(rng, b, S, G, N), _rand(rng, b, S, G, N)
    return x, dt, A, B, C


@pytest.mark.parametrize("chunk,with_state", [(16, False), (4, False),
                                              (8, True)])
def test_ssd_chunked_equals_jax(chunk, with_state):
    rng = np.random.default_rng(chunk)
    x, dt, A, B, C = _ssd_inputs(rng)
    st = _rand(rng, 2, 4, 8, 6) if with_state else None
    wy, ws = jssm.ssd_chunked(x, dt, A, B, C, chunk, state0=st)
    gy, gs = ssm.ssd_chunked(_t(x), _t(dt), _t(A), _t(B), _t(C), chunk,
                             state0=None if st is None else _t(st))
    _close(wy, gy)
    _close(ws, gs)


def _mamba(seed=0):
    jc, tc = _cfgs("mamba2-780m")
    jp, tp = _weights(jc, seed)
    return jc, tc, jp["blocks"], tp["blocks"]


@pytest.mark.parametrize("mode", ["prefill", "decode", "chunk"])
def test_apply_mamba_equals_jax(mode):
    jc, tc, jb, tb = _mamba()
    jp = jax.tree.map(lambda a: a[0], jb["layer_0"]["mamba"])
    tp = {k: v[0] for k, v in tb["layer_0"]["mamba"].items()}
    rng = np.random.default_rng(5)
    S = {"prefill": 8, "decode": 1, "chunk": 4}[mode]
    x = _rand(rng, 2, S, jc.d_model)
    jstate = tstate = None
    nv = None
    if mode != "prefill":
        st = jssm.init_mamba_state(jc, 2, jnp.float32)
        st = jax.tree.map(lambda a: jnp.asarray(_rand(rng, *a.shape)), st)
        jstate = st
        tstate = {k: _t(v) for k, v in st.items()}
    if mode == "chunk":
        nv = 3
    wout, wst = jssm.apply_mamba(jc, jp, x, state=jstate, mode=mode,
                                 n_valid=None if nv is None
                                 else jnp.int32(nv))
    gout, gst = ssm.apply_mamba(tc, tp, _t(x), state=tstate, mode=mode,
                                n_valid=nv)
    _close(wout, gout)
    for k in ("conv", "ssm"):
        _close(wst[k], gst[k])


def test_mamba_chunk_padding_is_an_exact_noop():
    """dt = 0 on padded tokens: n_valid = 0 passes the state through
    bitwise, and what the padded tokens hold changes nothing (state, conv
    window and the valid tokens' outputs bitwise)."""
    _, tc, _, tb = _mamba()
    p = {k: v[0] for k, v in tb["layer_0"]["mamba"].items()}
    rng = np.random.default_rng(7)
    st = {k: _t(_rand(rng, *v.shape)) for k, v in
          ssm.init_mamba_state(tc, 2, torch.float32, "cpu").items()}
    x = _t(_rand(rng, 2, 4, tc.d_model))
    _, same = ssm.apply_mamba(tc, p, x, state=st, mode="chunk", n_valid=0)
    for k in st:
        assert torch.equal(same[k], st[k]), k
    nv = torch.tensor([2, 3])
    x2 = x.clone()
    x2[0, 2:] = 7.0
    x2[1, 3:] = -3.0
    o1, s1 = ssm.apply_mamba(tc, p, x, state=st, mode="chunk", n_valid=nv)
    o2, s2 = ssm.apply_mamba(tc, p, x2, state=st, mode="chunk", n_valid=nv)
    for k in st:
        assert torch.equal(s1[k], s2[k]), k
    assert torch.equal(o1[0, :2], o2[0, :2]) and torch.equal(o1[1, :3],
                                                             o2[1, :3])


def test_mamba_train_loss_equals_jax():
    """Train mode (two SSD chunks of 64) through the chunked CE: the loss
    within 1e-5 relative."""
    jc, tc = _cfgs("mamba2-780m")
    jp, tp = _weights(jc)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jc.vocab_size, (2, 128)).astype(np.int32)
    tgts = rng.integers(0, jc.vocab_size, (2, 128)).astype(np.int32)
    jl = jloss_fn(jc, jp, {"tokens": toks, "targets": tgts})
    tl = loss_fn(tc, tp, {"tokens": _t(toks), "targets": _t(tgts)})
    assert abs(float(tl) - float(jl)) <= ATOL * max(1.0, abs(float(jl)))


# ---------------------------------------------------------------------------
# forward in prefill / decode / chunk mode, and the logits head
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_equals_jax(arch):
    """Batched prefill, the cache grown to capacity, then 4 greedy decode
    steps: logits within 1e-5, caches within 1e-5, tokens equal."""
    jc, tc = _cfgs(arch)
    jp, tp = _weights(jc)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jc.vocab_size, (2, 8)).astype(np.int32)
    jh, jcache, _ = _jfwd(jc, jp, jnp.asarray(toks), mode="prefill")
    th, tcache, _ = forward(tc, tp, _t(toks), mode="prefill")
    _close(jh, th)
    _caches_close(jcache, tcache)
    jl, tl = jtf.logits_head(jc, jp, jh[:, -1:]), logits_head(tc, tp,
                                                               th[:, -1:])
    _close(jl, tl)
    jcache = jgrow_cache(jinit_cache(jc, 2, 16), jcache)
    tcache = grow_cache(init_cache(tc, 2, 16, device="cpu"), tcache)
    for _ in range(4):
        jt = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
        tt = torch.argmax(tl[:, -1], -1)[:, None]
        assert np.asarray(jt).tolist() == tt.tolist()
        jh, jcache, _ = _jfwd(jc, jp, jt, mode="decode", cache=jcache)
        th, tcache, _ = forward(tc, tp, tt, mode="decode", cache=tcache)
        jl, tl = jtf.logits_head(jc, jp, jh), logits_head(tc, tp, th)
        _close(jl, tl)
        _caches_close(jcache, tcache)
    assert int(tcache["len"]) == int(jcache["len"]) == 12


@pytest.mark.parametrize("arch", ARCHS)
def test_chunk_mode_equals_jax(arch):
    """Three chunks of 4 tokens (the last ragged: n_valid 2) from an empty
    cache: hidden states, caches and len within 1e-5 / equal, against the
    reference run eagerly (ROADMAP.md C 6: jitted, XLA contracts the SSD
    chunk's multiply-adds into FMAs by rules that depend on the host's
    CPU, which moved mamba2-780m's hidden states by 1.1e-5 on one host)."""
    jc, tc = _cfgs(arch)
    jp, tp = _weights(jc, 1)
    rng = np.random.default_rng(1)
    jcache = jinit_cache(jc, 1, 16)
    tcache = init_cache(tc, 1, 16, device="cpu")
    for nv in (4, 4, 2):
        ch = rng.integers(0, jc.vocab_size, (1, 4)).astype(np.int32)
        with jax.disable_jit():
            jh, jcache, _ = _jfwd(jc, jp, jnp.asarray(ch), mode="chunk",
                                  cache=jcache, n_valid=jnp.int32(nv))
            jlogits = jtf.logits_head(jc, jp, jh[:, nv - 1:nv])
        th, tcache, _ = forward(tc, tp, _t(ch), mode="chunk", cache=tcache,
                                n_valid=nv)
        _close(jh[:, :nv], th[:, :nv])
        _caches_close(jcache, tcache)
        _close(jlogits, logits_head(tc, tp, th[:, nv - 1:nv]))
    assert int(tcache["len"]) == int(jcache["len"]) == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_forward_equals_dense(arch):
    """Decode through page pools (gather, attend, hand rows back) gives
    the dense cache's hidden states bitwise."""
    from repro_torch.serve import paged as P
    _, tc = _cfgs(arch)
    _, tp = _weights(_cfgs(arch)[0])
    rng = np.random.default_rng(2)
    toks = _t(rng.integers(0, tc.vocab_size, (2, 8)).astype(np.int32))
    _, c, _ = forward(tc, tp, toks, mode="prefill")
    dense = grow_cache(init_cache(tc, 2, 16, device="cpu"), c)
    pools = P.build_pools(tc, 8, 4, torch.float32, "cpu")
    tables = torch.tensor([[5, 1, 7, 3], [2, 6, 0, 4]], dtype=torch.int32)
    lane, rows = P.strip_attn_kv(tc, dense)
    zero = torch.zeros(2, dtype=torch.int64)
    if rows:
        # the whole dense cache rows (16 = 4 pages of 4) into the pools
        pools = P.scatter_tree(pools, rows, tables, zero,
                               torch.full((2,), 16), torch.ones(2, dtype=bool),
                               4)
    lane["pages"] = tables
    step = torch.tensor([[3], [4]])
    hd, _, _ = forward(tc, tp, step, mode="decode", cache=dense)
    hp, _, _ = forward(tc, tp, step, mode="decode", cache=lane, pools=pools)
    assert torch.equal(hd, hp)
