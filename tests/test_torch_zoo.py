"""The port's model zoo against the JAX package, on the CPU, from identical
weights (``models/convert.py``) and identical numpy inputs: all eleven
architectures at ``reduced`` (d_model 32; gemma3 and jamba at 8 layers so
that the 5:1 and 1:7 patterns hold a global attention layer), fp32.

* configs: fields, exact parameter counts, templates, cost model;
* training: ``loss_fn`` (CE + router aux) and its gradients, the aux
  itself, per node under ``vmap`` as the swarm takes them;
* serving: prefill, decode and ragged chunks, a sliding-window ring that
  wraps, and the banded path;
* MoE: ``route`` / ``dispatch_positions`` bitwise (drops at capacity
  factor 1.25, a tied router), ``apply_moe``;
* frontend: the prefix in the loss and in the one-shot serving path;
* both training drivers on the new families.

Tolerance: 1e-5 on losses, gradients, hidden states, logits and caches,
absolute, or relative to the reference leaf's largest magnitude where that
exceeds 1 (jitted XLA and eager torch sum in different orders; fp32);
jamba's gradients through its 8 layers 2e-5 on that scale: its embedding
gradient reaches 3.8, and each package's fp32 gradient lies 1.9e-5 (the
port) and 2.9e-5 (JAX) from the port's float64 run of the same weights.
Routing choices, capacity slots, ring writes and greedy tokens equal.
"""
import dataclasses
import json
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, reduced as jreduced
from repro.configs import list_archs as jlist_archs
from repro.models import attention as jattn
from repro.models import forward as jforward
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models import loss_fn as jloss_fn
from repro.models import moe as jmoe
from repro.models import param_template as jparam_template
from repro.models import transformer as jtf
from repro.models.layers import is_info as jis_info
from repro.serve.engine import grow_cache as jgrow_cache
from repro_torch.configs import get_config, list_archs, reduced
from repro_torch.launch import train as ttrain
from repro_torch.models import (attention, forward, init_cache, logits_head,
                                loss_fn, moe, param_template)
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.layers import is_info
from repro_torch.serve.engine import grow_cache
from repro_torch.tree import (tree_flatten, tree_key_paths,
                              tree_map_with_path)

ZOO = sorted(jlist_archs())
NEW = ["chatglm3-6b", "gemma3-27b", "gemma3-4b", "granite-moe-3b-a800m",
       "jamba-1.5-large-398b", "musicgen-large", "paligemma-3b",
       "qwen3-moe-30b-a3b"]
FRONTEND = ["musicgen-large", "paligemma-3b"]
LAYERS = {"gemma3-4b": 8, "gemma3-27b": 8, "jamba-1.5-large-398b": 8}
ATOL = 1e-5
GRAD_ATOL = {"jamba-1.5-large-398b": 2e-5}
_jfwd = jax.jit(jforward, static_argnums=(0,), static_argnames=("mode",))


def _cfgs(arch, d_model=32, **replace):
    n = LAYERS.get(arch, 2)
    jc = jreduced(jget_config(arch), n_layers=n, d_model=d_model)
    tc = reduced(get_config(arch), n_layers=n, d_model=d_model)
    if replace:
        jc = dataclasses.replace(jc, **replace)
        tc = dataclasses.replace(tc, **replace)
    return jc, tc


_NP_WEIGHTS = {}


def _weights(jc, seed=0):
    """JAX's init for (config, seed), drawn once; fresh copies in both
    packages."""
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
    """Within `atol` of the reference, scaled by its largest magnitude
    where that exceeds 1."""
    j = np.asarray(j)
    t = np.asarray(t.detach() if isinstance(t, torch.Tensor) else t)
    scale = max(1.0, float(np.abs(j).max())) if j.size else 1.0
    np.testing.assert_allclose(t, j, rtol=0, atol=atol * scale)


def _trees_close(jtree, ttree, atol=ATOL):
    jl, tl = jax.tree.leaves(jtree), tree_flatten(ttree)[0]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        _close(a, b.to(torch.float32) if b.is_floating_point() else b, atol)


def _prefix(cfg, batch, seed=0):
    f = cfg.frontend
    return (np.random.default_rng(seed).standard_normal(
        (batch, f.n_prefix, f.d_embed)) * 0.02).astype(np.float32)


# ---------------------------------------------------------------------------
# Configs, templates, counts
# ---------------------------------------------------------------------------


def test_registry_is_the_reference():
    assert list_archs() == jlist_archs() == ZOO
    assert not hasattr(tf, "_check_layer")


@pytest.mark.parametrize("arch", ZOO)
def test_config_and_counts_equal_jax(arch):
    jc, tc = jget_config(arch), get_config(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert tc.n_params() == jc.n_params()
    assert tc.n_active_params() == jc.n_active_params()
    for n in (2, 8):
        jr = jreduced(jc, n_layers=n, d_model=64)
        tr = reduced(tc, n_layers=n, d_model=64)
        assert dataclasses.asdict(tr) == dataclasses.asdict(jr)
        assert tr.n_params() == jr.n_params()
        assert tr.n_active_params() == jr.n_active_params()
    # the counts are the templates' sizes
    jr, tr = _cfgs(arch)
    leaves, _ = tree_flatten(param_template(tr))
    assert sum(math.prod(i.shape) for i in leaves) == tr.n_params()


def test_full_size_counts():
    assert get_config("granite-moe-3b-a800m").n_params() == 3_298_793_472
    assert get_config("gemma3-4b").n_params() == 3_879_925_248
    assert get_config("paligemma-3b").n_params() == 2_512_857_088


@pytest.mark.parametrize("arch", NEW)
def test_param_template_and_cache_equal_jax(arch):
    jc, tc = _cfgs(arch)
    jt = jax.tree_util.tree_flatten_with_path(jparam_template(jc),
                                              is_leaf=jis_info)[0]
    tleaves, _ = tree_flatten(param_template(tc))
    assert all(is_info(i) for i in tleaves)
    assert [(ti.shape, ti.axes, ti.init, ti.scale) for ti in tleaves] == \
        [(ji.shape, ji.axes, ji.init, ji.scale) for _, ji in jt]
    jcache = jinit_cache(jc, 3, 16)
    tcache = init_cache(tc, 3, 16, device="cpu")
    jpaths = [tuple(k.key for k in p) for p, _ in
              jax.tree_util.tree_flatten_with_path(jcache)[0]]
    assert tree_key_paths(tcache) == jpaths
    for a, b in zip(jax.tree.leaves(jcache), tree_flatten(tcache)[0]):
        assert tuple(a.shape) == tuple(b.shape)


@pytest.mark.parametrize("arch", ZOO)
def test_cost_params_count_the_reference(arch):
    """The scheduler's FLOPs / bytes / payload of one local step equal
    the reference's for every arch, full size and reduced (the SSD term of
    Mamba2 layers included)."""
    from repro.sched import cost as J
    from repro_torch.sched import cost as T
    for red in (False, True):
        cfg, jcfg = get_config(arch), jget_config(arch)
        if red:
            cfg, jcfg = reduced(cfg, n_layers=8, d_model=64), \
                jreduced(jcfg, n_layers=8, d_model=64)
        kw = dict(seq_len=128, local_batch=4, quantize=True, topology=None)
        a = T.cost_params_from_model(cfg, **kw)
        b = J.cost_params_from_model(jcfg, **kw)
        assert (a.flops_per_step, a.hbm_bytes_per_step, a.payload_bytes,
                a.meta) == (b.flops_per_step, b.hbm_bytes_per_step,
                            b.payload_bytes, b.meta)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "qwen3-moe-30b-a3b", "gemma3-4b",
                                  "paligemma-3b", "jamba-1.5-large-398b"])
def test_convert_round_trips_the_new_leaves(arch):
    """Router, [E, D, F] / [E, F, D] experts, q_norm / k_norm and the
    frontend projection cross both ways leaf by leaf, bf16 included."""
    jc, _ = _cfgs(arch)
    jc = dataclasses.replace(jc, dtype="bfloat16")
    np_tree = jax.device_get(jinit_params(jax.random.PRNGKey(3), jc))
    t = params_from_numpy(np_tree, "cpu")
    paths = tree_key_paths(t)
    names = {p[-1] for p in paths}
    want = {"router", "w_up", "w_down", "q_norm", "k_norm", "proj"}
    assert names & want
    back = params_to_numpy(t)
    for p, a, b in zip(paths, jax.tree.leaves(np_tree),
                       tree_flatten(back)[0]):
        assert a.shape == b.shape, p
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)
        assert tree_flatten(t)[0][paths.index(p)].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# Training: loss (CE + aux), aux, gradients
# ---------------------------------------------------------------------------


def _batch(cfg, B=2, S=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    tgts = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return toks, tgts


@pytest.mark.parametrize("arch", ZOO)
def test_loss_aux_and_grads_equal_jax(arch):
    jc, tc = _cfgs(arch)
    jp, tp = _weights(jc)
    toks, tgts = _batch(jc)
    jb = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts)}
    tb = {"tokens": _t(toks), "targets": _t(tgts)}
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jloss_fn(jc, p, jb)))(jp)
    tg, tl = torch.func.grad_and_value(lambda p: loss_fn(tc, p, tb))(tp)
    _close(jl, tl)
    _trees_close(jg, tg, GRAD_ATOL.get(arch, ATOL))
    _, _, jaux = _jfwd(jc, jp, jb["tokens"], mode="train")
    _, _, taux = forward(tc, tp, tb["tokens"])
    assert taux.dtype == torch.float32 and taux.shape == ()
    _close(jaux, taux)
    if jc.moe is None:
        assert float(taux) == 0.0
    else:
        assert float(taux) > 0.0


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "jamba-1.5-large-398b"])
def test_node_vmapped_grads_equal_jax(arch):
    """The swarm's per-node gradients (vmap over the node axis) through
    the MoE dispatch: out of place, so it vmaps, and equal to JAX's."""
    jc, tc = _cfgs(arch)
    np_nodes = [jax.device_get(jinit_params(jax.random.PRNGKey(s), jc))
                for s in (0, 1)]
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *np_nodes)
    toks, tgts = _batch(jc, B=1)
    jb = {"tokens": jnp.asarray(np.stack([toks, toks[:, ::-1]])),
          "targets": jnp.asarray(np.stack([tgts, tgts]))}
    tb = {k: _t(np.asarray(v)) for k, v in jb.items()}
    jg = jax.jit(jax.vmap(jax.grad(lambda p, b: jloss_fn(jc, p, b))))(
        jax.tree.map(jnp.asarray, stacked), jb)
    tg = torch.func.vmap(torch.func.grad(lambda p, b: loss_fn(tc, p, b)))(
        params_from_numpy(stacked, "cpu"), tb)
    _trees_close(jg, tg, GRAD_ATOL.get(arch, ATOL))


@pytest.mark.parametrize("arch", FRONTEND)
def test_loss_with_prefix_equals_jax(arch):
    """The prefix is projected, prepended, and dropped from the CE."""
    jc, tc = _cfgs(arch)
    jp, tp = _weights(jc)
    toks, tgts = _batch(jc)
    pref = _prefix(jc, 2)
    jb = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts),
          "prefix_embeds": jnp.asarray(pref)}
    tb = {"tokens": _t(toks), "targets": _t(tgts), "prefix_embeds": _t(pref)}
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jloss_fn(jc, p, jb)))(jp)
    tg, tl = torch.func.grad_and_value(lambda p: loss_fn(tc, p, tb))(tp)
    _close(jl, tl)
    _trees_close(jg, tg)
    assert float(tg["frontend"]["proj"].abs().sum()) > 0
    th, _, _ = forward(tc, tp, tb["tokens"], prefix_embeds=tb["prefix_embeds"])
    assert th.shape == (2, jc.frontend.n_prefix + 16, jc.d_model)


# ---------------------------------------------------------------------------
# Serving modes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ZOO)
def test_prefill_decode_chunk_equal_jax(arch):
    """Prefill 8 tokens, grow the cache to 16, 4 greedy decode steps; then
    from an empty cache three chunks of 4 (the last ragged, n_valid 2):
    hidden states, logits, caches within 1e-5, tokens and lengths equal."""
    jc, tc = _cfgs(arch)
    jp, tp = _weights(jc, 1)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jc.vocab_size, (2, 8)).astype(np.int32)
    jh, jcache, _ = _jfwd(jc, jp, jnp.asarray(toks), mode="prefill")
    th, tcache, _ = forward(tc, tp, _t(toks), mode="prefill")
    _close(jh, th)
    _trees_close(jcache, tcache)
    jl, tl = jtf.logits_head(jc, jp, jh[:, -1:]), logits_head(tc, tp,
                                                               th[:, -1:])
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
        _trees_close(jcache, tcache)
    jcache = jinit_cache(jc, 1, 16)
    tcache = init_cache(tc, 1, 16, device="cpu")
    for nv in (4, 4, 2):
        ch = rng.integers(0, jc.vocab_size, (1, 4)).astype(np.int32)
        jh, jcache, _ = _jfwd(jc, jp, jnp.asarray(ch), mode="chunk",
                              cache=jcache, n_valid=jnp.int32(nv))
        th, tcache, _ = forward(tc, tp, _t(ch), mode="chunk", cache=tcache,
                                n_valid=nv)
        _close(jh[:, :nv], th[:, :nv])
        _trees_close(jcache, tcache)
    assert int(tcache["len"]) == int(jcache["len"]) == 10


@pytest.mark.parametrize("S", [12, 21])
def test_swa_ring_wraps_equal_jax(S):
    """gemma3-4b with an 8-row window: prefill S (> window: the ring is
    rolled by S % 8), then 10 decode steps that wrap the ring, and chunks
    of 4 whose ragged tail must not write; the global layer keeps its
    full cache beside the rings."""
    jc, tc = _cfgs("gemma3-4b", sliding_window=8)
    jp, tp = _weights(jc, 2)
    rng = np.random.default_rng(S)
    toks = rng.integers(0, jc.vocab_size, (2, S)).astype(np.int32)
    jh, jcache, _ = _jfwd(jc, jp, jnp.asarray(toks), mode="prefill")
    th, tcache, _ = forward(tc, tp, _t(toks), mode="prefill")
    _close(jh, th)
    _trees_close(jcache, tcache)
    assert tcache["tail"]["layer_0"]["k"].shape[1] == 8
    cap = S + 12
    jcache = jgrow_cache(jinit_cache(jc, 2, cap), jcache)
    tcache = grow_cache(init_cache(tc, 2, cap, device="cpu"), tcache)
    for _ in range(10):
        step = rng.integers(0, jc.vocab_size, (2, 1)).astype(np.int32)
        jh, jcache, _ = _jfwd(jc, jp, jnp.asarray(step), mode="decode",
                              cache=jcache)
        th, tcache, _ = forward(tc, tp, _t(step), mode="decode",
                                cache=tcache)
        _close(jh, th)
        _trees_close(jcache, tcache)
    jcache = jinit_cache(jc, 1, 32)
    tcache = init_cache(tc, 1, 32, device="cpu")
    for nv in (4, 3, 4, 4, 2, 4):
        ch = rng.integers(0, jc.vocab_size, (1, 4)).astype(np.int32)
        jh, jcache, _ = _jfwd(jc, jp, jnp.asarray(ch), mode="chunk",
                              cache=jcache, n_valid=jnp.int32(nv))
        th, tcache, _ = forward(tc, tp, _t(ch), mode="chunk", cache=tcache,
                                n_valid=nv)
        _close(jh[:, :nv], th[:, :nv])
        _trees_close(jcache, tcache)
    assert int(tcache["len"]) == 21


def test_swa_per_lane_chunks_equal_batch_one():
    """The port's engine runs lanes of different lengths as one batch:
    a [2, T] chunk step with per-lane len and n_valid equals each lane's
    own batch-1 step (ring slot, unroll and min_kpos are per lane)."""
    _, tc = _cfgs("gemma3-4b", sliding_window=8)
    _, tp = _weights(_cfgs("gemma3-4b", sliding_window=8)[0], 2)
    rng = np.random.default_rng(5)
    lanes = []
    for L in (11, 3):
        c = init_cache(tc, 1, 32, device="cpu")
        toks = _t(rng.integers(0, tc.vocab_size, (1, L)).astype(np.int32))
        for s in range(0, L, 4):
            n = min(4, L - s)
            pad = torch.zeros((1, 4), dtype=torch.int32)
            pad[:, :n] = toks[:, s:s + n]
            _, c, _ = forward(tc, tp, pad, mode="chunk", cache=c, n_valid=n)
        lanes.append(c)
    both = tree_map_with_path(
        lambda p, a, b: torch.stack([a, b]) if p == ("len",) else
        torch.cat([a, b], dim=1 if p[0] == "blocks" else 0), *lanes)
    ch = _t(rng.integers(0, tc.vocab_size, (2, 4)).astype(np.int32))
    nv = torch.tensor([4, 2])
    hb, cb, _ = forward(tc, tp, ch, mode="chunk", cache=both, n_valid=nv)
    for i in range(2):
        h1, c1, _ = forward(tc, tp, ch[i:i + 1], mode="chunk",
                            cache=lanes[i], n_valid=int(nv[i]))
        _close(h1[0, :int(nv[i])], hb[i, :int(nv[i])])
        for p, a, b in zip(tree_key_paths(c1), tree_flatten(c1)[0],
                           tree_flatten(cb)[0]):
            if p == ("len",):
                assert int(a) == int(b[i])
            else:
                ax = 1 if p[0] == "blocks" else 0
                _close(a.select(ax, 0), b.select(ax, i))


# ---------------------------------------------------------------------------
# Attention pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,chunk,kvh", [(48, 16, 2), (192, 64, 2),
                                         (256, 64, 1)])
def test_attention_banded_both_branches(S, chunk, kvh):
    """Sk <= window + chunk takes the windowed dense path, longer
    sequences the band path (window 64); bf16 and fp32."""
    rng = np.random.default_rng(S)
    q = rng.standard_normal((2, S, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, S, kvh, 8)).astype(np.float32)
    v = rng.standard_normal((2, S, kvh, 8)).astype(np.float32)
    assert (S > 64 + chunk) == (S != 48)
    jo = jattn.attention_banded(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), window=64, chunk_q=chunk)
    to = attention.attention_banded(_t(q), _t(k), _t(v), window=64,
                                    chunk_q=chunk)
    _close(jo, to)
    # the band equals plain causal attention with a window mask
    qpos = np.arange(S)
    mask = (qpos[:, None] >= qpos[None, :]) & \
        (qpos[:, None] - qpos[None, :] < 64)
    kf = np.repeat(k, 4 // kvh, axis=2)
    vf = np.repeat(v, 4 // kvh, axis=2)
    lg = np.einsum("bqhd,bkhd->bhqk", q, kf) * 8 ** -0.5
    lg = np.where(mask[None, None], lg, -1e30)
    p = np.exp(lg - lg.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    _close(np.einsum("bhqk,bkhd->bqhd", p, vf), to, atol=1e-5)
    jb = jattn.attention_banded(*(jnp.asarray(a, jnp.bfloat16)
                                  for a in (q, k, v)), window=64,
                                chunk_q=chunk)
    tb = attention.attention_banded(*(_t(a).to(torch.bfloat16)
                                      for a in (q, k, v)), window=64,
                                    chunk_q=chunk)
    _close(np.asarray(jb, np.float32), tb.float(), atol=2e-2)


@pytest.mark.parametrize("start,n_valid", [(0, 4), (6, 4), (13, 2),
                                           (29, 0), (7, 3)])
def test_ring_write_chunk_equals_jax(start, n_valid):
    rng = np.random.default_rng(start)
    ring = rng.standard_normal((2, 8, 2, 4)).astype(np.float32)
    new = rng.standard_normal((2, 4, 2, 4)).astype(np.float32)
    j = jtf._ring_write_chunk(jnp.asarray(ring), jnp.asarray(new),
                              jnp.int32(start), jnp.int32(n_valid))
    t = tf._ring_write_chunk(_t(ring), _t(new), start, n_valid)
    np.testing.assert_array_equal(np.asarray(j), t.numpy())
    # per lane: lane 1 at another start and count
    t2 = tf._ring_write_chunk(_t(ring), _t(new), torch.tensor([start, 5]),
                              torch.tensor([n_valid, 4]))
    j2 = jtf._ring_write_chunk(jnp.asarray(ring[1:]), jnp.asarray(new[1:]),
                               jnp.int32(5), jnp.int32(4))
    np.testing.assert_array_equal(t2[:1].numpy(), t[:1].numpy())
    np.testing.assert_array_equal(t2[1:].numpy(), np.asarray(j2))


# ---------------------------------------------------------------------------
# MoE routing, dispatch, combine
# ---------------------------------------------------------------------------


def _skewed(rng, T, jc, scale=1.0):
    """Tokens with a common component and a router that favours experts
    0 and 1 along it: most tokens choose the same two experts, so a
    capacity factor below 4.0 drops some."""
    x = (rng.standard_normal((T, jc.d_model)) + 1.0).astype(np.float32)
    w = (rng.standard_normal((jc.d_model, jc.moe.n_experts)) * 0.05 +
         np.array([0.08, 0.05, 0.0, -0.05]) * scale).astype(np.float32)
    return x, w


def _moe_cfgs(capacity_factor=4.0, arch="granite-moe-3b-a800m"):
    jc, tc = _cfgs(arch)
    return (dataclasses.replace(jc, moe=dataclasses.replace(
                jc.moe, capacity_factor=capacity_factor)),
            dataclasses.replace(tc, moe=dataclasses.replace(
                tc.moe, capacity_factor=capacity_factor)))


@pytest.mark.parametrize("cf,T", [(4.0, 24), (1.25, 24), (1.25, 64),
                                  (1.0, 40)])
def test_route_and_dispatch_bitwise(cf, T):
    """idx, pos and keep equal the reference's bitwise (drops included);
    gates and aux within 1e-6."""
    jc, tc = _moe_cfgs(cf)
    x, w = _skewed(np.random.default_rng(int(T * cf)), T, jc)
    jg, ji, ja = jmoe.route(jc, jnp.asarray(w), jnp.asarray(x))
    tg, ti, ta = moe.route(tc, _t(w), _t(x))
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    _close(jg, tg, 1e-6)
    _close(ja, ta, 1e-6)
    jpos, jkeep = jmoe.dispatch_positions(jc, ji, T)
    tpos, tkeep = moe.dispatch_positions(tc, ti, T)
    np.testing.assert_array_equal(np.asarray(jpos), tpos.numpy())
    np.testing.assert_array_equal(np.asarray(jkeep), tkeep.numpy())
    assert moe.capacity(tc, T) == jmoe.capacity(jc, T)
    # the skew overflows experts 0 and 1 below capacity factor 4.0, and
    # reduced's 4.0 is dropless
    assert bool(tkeep.all()) == (cf == 4.0)


def test_tied_router_picks_the_lower_index():
    """Identical router columns tie every expert: jax.lax.top_k puts the
    lower index first, and so does the port."""
    jc, tc = _moe_cfgs()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, jc.d_model)).astype(np.float32)
    col = rng.standard_normal((jc.d_model, 1)).astype(np.float32)
    w = np.repeat(col, jc.moe.n_experts, axis=1)
    _, ji, _ = jmoe.route(jc, jnp.asarray(w), jnp.asarray(x))
    _, ti, _ = moe.route(tc, _t(w), _t(x))
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    assert ti.tolist() == [[0, 1]] * 16


@pytest.mark.parametrize("cf", [4.0, 1.25])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "qwen3-moe-30b-a3b"])
def test_apply_moe_equals_jax(cf, arch):
    """The combined output and aux within 1e-5, with and without drops;
    a dropped choice contributes nothing, not the kept token at its
    clipped slot."""
    jc, tc = _moe_cfgs(cf, arch)
    jp, tp = _weights(jc, 4)
    p_np = jax.device_get(jp["blocks"]["layer_0"]["moe"])
    p_np = {k: v[0] for k, v in p_np.items()}
    x, p_np["router"] = _skewed(np.random.default_rng(1), 40, jc)
    x = x.reshape(2, 20, jc.d_model)
    jo, ja = jmoe.apply_moe(jc, jax.tree.map(jnp.asarray, p_np),
                            jnp.asarray(x))
    to, ta = moe.apply_moe(tc, params_from_numpy(p_np, "cpu"), _t(x))
    _close(jo, to)
    _close(ja, ta)
    # by hand: each token's kept choices, gated
    g, idx, _ = moe.route(tc, _t(p_np["router"]), _t(x).reshape(40, -1))
    pos, keep = moe.dispatch_positions(tc, idx, 40)
    if cf == 1.25:
        assert not keep.all()
    xf = _t(x).reshape(40, -1)
    want = torch.zeros_like(xf)
    for t in range(40):
        for j in range(tc.moe.top_k):
            if keep[t, j]:
                e = int(idx[t, j])
                up = xf[t] @ _t(p_np["w_up"][e])
                gate = torch.nn.functional.silu(xf[t] @ _t(p_np["w_gate"][e]))
                want[t] += g[t, j] * ((gate * up) @ _t(p_np["w_down"][e]))
    _close(want.numpy(), to.reshape(40, -1), atol=1e-5)


# ---------------------------------------------------------------------------
# Frontend: the one-shot serving path with its prefix
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", FRONTEND)
def test_oneshot_prefix_path_equals_jax(arch):
    """``launch/serve.run_oneshot`` with an injected prefix: the cache
    holds prefix + prompt + gen rows, and its greedy tokens equal JAX's
    prefill-with-prefix then decode, as ``repro.launch.serve`` runs it."""
    from repro_torch.launch import serve as tserve
    jc, tc = _cfgs(arch)
    jp, tp = _weights(jc, 5)
    prompts = np.random.default_rng(5).integers(
        0, jc.vocab_size, (2, 8)).astype(np.int32)
    pref = _prefix(jc, 2, 5)
    args = tserve.build_parser().parse_args(
        ["--arch", arch, "--device", "cpu", "--gen", "5"])
    gens = tserve.make_generators(0, "cpu")
    got = tserve.run_oneshot(tc, args, tp, gens, prompts=prompts,
                             prefix=pref)
    jh, jcache, _ = _jfwd(jc, jp, jnp.asarray(prompts), mode="prefill",
                          prefix_embeds=jnp.asarray(pref))
    assert int(jcache["len"]) == jc.frontend.n_prefix + 8
    jcache = jgrow_cache(jinit_cache(jc, 2, jc.frontend.n_prefix + 8 + 5),
                         jcache)
    tok = jnp.argmax(jtf.logits_head(jc, jp, jh[:, -1:])[:, -1], -1)
    out = [np.asarray(tok)]
    for _ in range(4):
        jh, jcache, _ = _jfwd(jc, jp, tok.astype(jnp.int32)[:, None],
                              mode="decode", cache=jcache)
        tok = jnp.argmax(jtf.logits_head(jc, jp, jh)[:, -1], -1)
        out.append(np.asarray(tok))
    assert got["tokens"].tolist() == np.stack(out, 1).tolist()
    assert got["finite"]
    # the prefilled cache holds the prefix rows too
    _, c, _ = forward(tc, tp, _t(prompts), mode="prefill",
                      prefix_embeds=_t(pref))
    assert int(c["len"]) == tc.frontend.n_prefix + 8


def test_synth_prefix_is_seeded():
    from repro_torch.models.multimodal import synth_prefix_embeds
    _, tc = _cfgs("paligemma-3b")
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(7), g2.manual_seed(7)
    a = synth_prefix_embeds(g1, tc, 2, "cpu")
    b = synth_prefix_embeds(g2, tc, 2, "cpu")
    assert a.shape == (2, 16, 32) and torch.equal(a, b)
    assert 0.01 < float(a.std()) < 0.03


# ---------------------------------------------------------------------------
# Both drivers on the new families
# ---------------------------------------------------------------------------


def _records(out: str) -> list:
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "gemma3-4b",
                                  "paligemma-3b"])
def test_drivers_print_the_same_records(arch, capsys, monkeypatch):
    from repro.launch.train import main as jmain
    for var in ("REPRO_AVAIL_PROFILE", "REPRO_RATE_PROFILE", "REPRO_CODEC",
                "REPRO_SCAN_CHUNK", "REPRO_TOPOLOGY"):
        monkeypatch.delenv(var, raising=False)
    flags = ["--arch", arch, "--reduced", "--layers", "1", "--d-model",
             "32", "--nodes", "4", "--steps", "3", "--batch", "1", "--seq",
             "16", "--quantize", "--log-every", "1"]
    monkeypatch.setattr(sys, "argv", ["train"] + flags)
    jmain()
    jrecs = _records(capsys.readouterr().out)
    trecs = ttrain.main(flags + ["--device", "cpu"])
    assert [sorted(r) for r in trecs] == [sorted(r) for r in jrecs]
    assert [r["step"] for r in trecs] == [r["step"] for r in jrecs] == \
        [0, 1, 2]
    for tr, jr in zip(trecs, jrecs):
        assert all(np.isfinite(v) for v in tr.values())
        # both start near ln(vocab) from their own random inits
        assert abs(tr["loss"] - jr["loss"]) < 0.5
