"""The port's transport axis against the JAX package, on the CPU: every
``gossip_impl`` of the reference — ``gather``, ``ppermute`` (one static
matching), ``ppermute_pool`` (an index a superstep into K matchings) and
the ``*_legacy`` per-leaf oracle of each — on one shard, from the same
numpy-seeded inputs.

* The lattice schemes (``encode_modular`` / ``decode_modular`` /
  ``quantized_pair_average``) at q4, q8 and q16 with JAX's uniforms:
  codes, scales and floats bitwise eager JAX, floats within 1e-6 of
  jitted JAX.
* The per-leaf oracles ``gossip_exact`` / ``gossip_quantized`` (with
  JAX's per-leaf uniforms) and the flat one-shard ``gossip_flat_ppermute``
  / ``gossip_flat_ppermute_pool`` bitwise eager JAX; the matchings
  (``pairs_from_perm``, ``make_matching_pool``, ``static_ppermute_matching``,
  the two-tier pool) equal JAX's from the same seeds.
* One engine per impl, exact and q8, blocking and non-blocking (the flat
  ppermute impls overlapped too), against JAX's jitted engine on the same
  impl: exact trajectories within 2e-5 over 4 supersteps, q8 supersteps
  restarted from JAX's state within one lattice step of the partner's row
  (the rows a legacy oracle's per-leaf encode scaled) and 99.9% within
  2e-5 — the slice contract of ROADMAP.md.
* The port's own bitwise pairs, as the reference's tests hold them: each
  flat exact impl equals its ``*_legacy`` oracle (and the five baselines
  on gather / gather_legacy, masked too); ``ppermute_pool`` fed gather's
  matchings equals gather; the chunk driver equals the per-step driver on
  the pool.
* The refusals the reference makes, the scheduler bridge's pool inputs,
  and both drivers' records per ``--gossip-impl``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.algorithms import make_algorithm as jmake_algorithm
from repro.core import bucket as JB
from repro.core import exchange as JE
from repro.core.graph import make_graph as jmake_graph
from repro.core.hier import parse_topology as jparse_topology
from repro.core.swarm import SwarmConfig as JSwarmConfig
from repro.core.swarm import make_swarm_step as jmake_swarm_step
from repro.core.swarm import swarm_init as jswarm_init
from repro.launch import train as jtrain
from repro.optim import make_optimizer as jmake_optimizer
from repro.quant import schemes as JS
from repro.quant.codecs import make_codec as jmake_codec
from repro.sched import bridge as JBR
from repro_torch.algorithms import make_algorithm, validate_run_config
from repro_torch.core import bucket as TB
from repro_torch.core import exchange as TE
from repro_torch.core.graph import make_graph, sample_matching
from repro_torch.core.hier import parse_topology
from repro_torch.core.scan import make_superstep_scan
from repro_torch.core.swarm import (SwarmConfig, SwarmState, make_swarm_step,
                                    swarm_init)
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import NodeMesh
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import make_optimizer
from repro_torch.quant import schemes as TS
from repro_torch.quant.codecs import LatticeCodec, make_codec
from repro_torch.sched import bridge as TBR
from repro_torch.tree import tree_leaves

N, D, HID = 8, 6, 16
STEPS, H, B, K = 4, 2, 4, 4
LR = 0.05
SEED = 5
IMPLS = ("gather", "ppermute", "ppermute_pool", "gather_legacy",
         "ppermute_legacy", "ppermute_pool_legacy")
Q8 = dict(safety=16.0)


def _np(x):
    return np.asarray(x)


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


# ---------------------------------------------------------------------------
# The lattice schemes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", [4, 8, 16])
@pytest.mark.parametrize("resolution", [None, 1e-3], ids=["proxy", "eps"])
def test_schemes_match_jax(bits, resolution):
    jc = JS.ModularQuantConfig(bits=bits, resolution=resolution)
    tc = TS.ModularQuantConfig(bits=bits, resolution=resolution)
    r = np.random.default_rng(bits)
    x = r.normal(size=(5, 70)).astype(np.float32)          # ragged: padded
    ref = (x + 0.01 * r.normal(size=x.shape)).astype(np.float32)
    y = (x + 0.002 * r.normal(size=x.shape)).astype(np.float32)
    key = jax.random.PRNGKey(bits)
    xb, pad = JS._blocked(jnp.asarray(x), 256)
    tb, tpad = TS._blocked(_t(x), 256)
    assert pad == tpad and tb.shape == xb.shape
    u = np.asarray(jax.random.uniform(key, xb.shape))
    jq, js = JS.encode_modular(jc, jnp.asarray(x), jnp.asarray(ref), key)
    q, s = TS.encode_modular(tc, _t(x), _t(ref), u=_t(u))
    if bits > 8:     # uint16 codes compared through an int16 view
        _bits(np.asarray(jq).view(np.int16), q.view(torch.int16))
    else:
        _bits(jq, q)
    _bits(js, s)
    jd = JS.decode_modular(jc, jq, js, jnp.asarray(y))
    d = TS.decode_modular(tc, q, s, _t(y))
    _bits(jd, d)
    ja = JS.quantized_pair_average(jc, jnp.asarray(y), jq, js)
    a = TS.quantized_pair_average(tc, _t(y), q, s)
    _bits(ja, a)
    jitted = jax.jit(lambda y_: JS.quantized_pair_average(jc, y_, jq, js))
    np.testing.assert_allclose(a.numpy(), _np(jitted(jnp.asarray(y))),
                               rtol=1e-6, atol=1e-7)
    # the generator's draw lands in [0, 1) of the blocked shape
    g = torch.Generator().manual_seed(0)
    q2, s2 = TS.encode_modular(tc, _t(x), _t(ref), g)
    assert q2.shape == q.shape and torch.equal(s2, s)


def _mixed_tree(rng, n=N, spread=0.01):
    """Node-stacked tree of mixed dtypes and shapes, nodes close."""
    base = {"emb": rng.normal(size=(33, 16)),
            "w": {"in": rng.normal(size=(6, 16)),
                  "out": rng.normal(size=(16, 1))},
            "scale": rng.normal(size=(5,))}

    def noise(v):
        return v[None] + spread * rng.normal(size=(n,) + v.shape)
    return {"emb": noise(base["emb"]).astype(np.float32),
            "w": {"in": noise(base["w"]["in"]).astype(np.float32),
                  "out": noise(base["w"]["out"]).astype(np.float32)},
            "scale": noise(base["scale"]).astype(np.float32)}


def _trees(np_tree):
    j = jax.tree.map(jnp.asarray, np_tree)
    j["emb"] = j["emb"].astype(jnp.bfloat16)
    t = params_from_numpy(np_tree, "cpu")
    t["emb"] = t["emb"].to(torch.bfloat16)
    return j, t


def _leaves_bits(jtree, ttree):
    for a, b in zip(jax.tree.leaves(jtree), tree_leaves(ttree)):
        a = np.asarray(a.astype(jnp.float32))
        np.testing.assert_array_equal(a, b.to(torch.float32).numpy())


def _legacy_uniforms(key, tree, n=N, block=256):
    """JAX's per-leaf draws of `gossip_quantized`: a key a leaf, a key a
    node, uniforms of the node's blocked leaf; -> [n, nb, block] a leaf."""
    leaves = jax.tree.leaves(tree)
    out = []
    for x, k in zip(leaves, jax.random.split(key, len(leaves))):
        nb = -(-int(np.prod(x.shape[1:])) // block)
        out.append(np.stack([np.asarray(jax.random.uniform(nk, (nb, block)))
                             for nk in jax.random.split(k, n)]))
    return out


PERM = np.asarray([1, 0, 3, 2, 6, 7, 4, 5])


def test_per_leaf_oracles_match_jax():
    rng = np.random.default_rng(2)
    jt, tt = _trees(_mixed_tree(rng))
    jp, tp = _trees(jax.tree.map(
        lambda v: (v + 0.005 * rng.normal(size=v.shape)).astype(v.dtype),
        _mixed_tree(np.random.default_rng(2))))
    matched = PERM != np.arange(N)
    _leaves_bits(JE.gossip_exact(jt, jnp.asarray(PERM), jnp.asarray(matched)),
                 TE.gossip_exact(tt, _t(PERM), _t(matched)))
    for bits in (4, 8, 16):
        jq = JS.ModularQuantConfig(bits=bits, safety=16.0)
        tq = TS.ModularQuantConfig(bits=bits, safety=16.0)
        key = jax.random.PRNGKey(bits)
        u = [_t(a) for a in _legacy_uniforms(key, jt)]
        want = JE.gossip_quantized(jq, jt, jp, jnp.asarray(PERM),
                                   jnp.asarray(matched), key)
        got = TE.gossip_quantized(tq, tt, tp, _t(PERM), _t(matched), None,
                                  u=u)
        _leaves_bits(want, got)
    # the one-shard ppermute oracles: the static pairs, or a pool entry
    pairs = TB.pairs_from_perm(PERM)
    _leaves_bits(JE.gossip_exact(jt, jnp.asarray(PERM), jnp.asarray(matched)),
                 TE.gossip_ppermute(tt, pairs))
    pool = [np.arange(N), PERM]
    _leaves_bits(JE.gossip_exact(jt, jnp.asarray(PERM), jnp.asarray(matched)),
                 TE.gossip_ppermute_pool(tt, pool, torch.tensor([1])))
    _leaves_bits(jt, TE.gossip_ppermute_pool(tt, pool, 0))


def test_matchings_match_jax():
    for kind in ("complete", "ring", "torus", "hypercube"):
        g, jg = make_graph(kind, N), jmake_graph(kind, N)
        for seed in (0, 3, 11):
            _bits(JE.static_ppermute_matching(jg, seed),
                  TE.static_ppermute_matching(g, seed))
            for a, b in zip(JE.make_matching_pool(jg, K, seed),
                            TE.make_matching_pool(g, K, seed)):
                _bits(a, b)
    for perm in (PERM, np.arange(N), np.asarray([2, 1, 0, 3, 5, 4, 7, 6])):
        assert TB.pairs_from_perm(perm) == JB.pairs_from_perm(perm)
        _bits(JB._perm_from_pairs(N, JB.pairs_from_perm(perm)),
              TB._perm_from_pairs(N, TB.pairs_from_perm(perm)))
    # the two-tier pool: K intra matchings + the inter-group suffix
    tp, tt = parse_topology("hier:4", N).matching_pool(K, 7)
    jp, jt = jparse_topology("hier:4", N).matching_pool(K, 7)
    for a, b in zip(jp, tp):
        _bits(a, b)
    _bits(jt, tt)
    for impl, topo in (("ppermute", None), ("ppermute_pool", None),
                       ("ppermute_pool", "hier:4")):
        jscfg = JSwarmConfig(n_nodes=N, gossip_impl=impl, pool_size=K,
                             topology=topo)
        scfg = SwarmConfig(n_nodes=N, gossip_impl=impl, pool_size=K,
                           topology=topo)
        jtr = JE.transport_from_config(jscfg, jmake_graph("complete", N), 9)
        ttr = TE.transport_from_config(scfg, make_graph("complete", N), 9)
        if impl == "ppermute":
            assert ttr.static_pairs == jtr.static_pairs
        else:
            for a, b in zip(jtr.matching_pool, ttr.matching_pool):
                _bits(a, b)


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("bits", [None, 4, 8, 16],
                         ids=["exact", "q4", "q8", "q16"])
@pytest.mark.parametrize("pool", [False, True], ids=["static", "pool"])
def test_flat_one_shard_ppermute_matches_jax(pool, bits, masked):
    from repro.compat import make_mesh_compat
    rng = np.random.default_rng(4)
    buf = rng.normal(size=(N, 2048)).astype(np.float32)
    prev = (buf + 0.01 * rng.normal(size=buf.shape)).astype(np.float32)
    mask = rng.random(N) < 0.6 if masked else None
    key = jax.random.PRNGKey(3)
    u = np.asarray(jax.random.uniform(key, buf.shape, jnp.float32))
    jq = None if bits is None else JS.ModularQuantConfig(bits=bits)
    tq = None if bits is None else TS.ModularQuantConfig(bits=bits)
    mesh = make_mesh_compat((1,), ("node",))
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else _t(mask)
    if pool:
        matchings = [np.arange(N), PERM, np.roll(PERM, 2)]
        got = TB.gossip_flat_ppermute_pool(
            _t(buf), matchings, torch.tensor([1]), quant=tq,
            prev_buf=_t(prev), u=_t(u), mask=tm)
        switched = JB.gossip_flat_ppermute_pool(
            jnp.asarray(buf), mesh, (), matchings, 1, quant=jq,
            prev_buf=jnp.asarray(prev), rng=key, mask=jm)
        # lax.switch compiles its branches (XLA contracts multiply-adds):
        # bitwise for fp32, a few ulp (one code at an integer edge) q
        d = np.abs(_np(switched) - got.numpy())
        assert (d <= 1e-6).mean() >= 0.999 and d.max() < 0.05, d.max()
        # bitwise the eager one-shard exchange of the entry it selects
        want = JB.gossip_flat_ppermute(
            jnp.asarray(buf), mesh, (), JB.pairs_from_perm(matchings[1]),
            quant=jq, prev_buf=jnp.asarray(prev), rng=key, mask=jm)
        if bits is None:
            _bits(switched, got)
    else:
        pairs = JB.pairs_from_perm(PERM)
        want = JB.gossip_flat_ppermute(jnp.asarray(buf), mesh, (), pairs,
                                       quant=jq, prev_buf=jnp.asarray(prev),
                                       rng=key, mask=jm)
        got = TB.gossip_flat_ppermute(_t(buf), pairs, quant=tq,
                                      prev_buf=_t(prev), u=_t(u), mask=tm)
    _bits(want, got)
    # the in-flight payload permutes move rows exactly as JAX's
    payload = (jnp.asarray(buf), jnp.asarray(prev[:, :8]))
    tpay = (_t(buf), _t(prev[:, :8]))
    if pool:
        jr = JB.permute_payload_pool(payload, mesh, (), matchings, 2, N)
        tr = TB.permute_payload_pool(tpay, matchings, torch.tensor([2]), N)
    else:
        pairs = JB.pairs_from_perm(PERM)
        jr = JB.permute_payload_ppermute(payload, mesh, (), pairs, N)
        tr = TB.permute_payload_ppermute(tpay, pairs, N)
    for a, b in zip(jr, tr):
        _bits(a, b)


def test_encode_flat_and_flat_quantized_match_jax():
    rng = np.random.default_rng(6)
    buf = rng.normal(size=(N, 2048)).astype(np.float32)
    prev = (buf + 0.01 * rng.normal(size=buf.shape)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    u = np.asarray(jax.random.uniform(key, buf.shape, jnp.float32))
    jq, tq = JS.ModularQuantConfig(), TS.ModularQuantConfig()
    for a, b in zip(JB.encode_flat(jq, jnp.asarray(buf), jnp.asarray(prev),
                                   key),
                    TB.encode_flat(tq, _t(buf), _t(prev), None, u=_t(u))):
        _bits(a, b)
    matched = PERM != np.arange(N)
    _bits(JB.gossip_flat_quantized(jq, jnp.asarray(buf), jnp.asarray(prev),
                                   jnp.asarray(PERM), jnp.asarray(matched),
                                   key),
          TB.gossip_flat_quantized(tq, _t(buf), _t(prev), _t(PERM),
                                   _t(matched), None, u=_t(u)))


# ---------------------------------------------------------------------------
# One engine per impl against JAX's
# ---------------------------------------------------------------------------


def _jtiny_init(rng):
    k1, k2 = jax.random.split(rng)
    return {"w1": jax.random.normal(k1, (D, HID)) * 0.3,
            "w2": jax.random.normal(k2, (HID, 1)) * 0.3}


def _jloss(p, mb):
    x, y = mb
    return jnp.mean((jnp.tanh(x @ p["w1"]) @ p["w2"] - y) ** 2)


def _tloss(p, mb):
    return torch.mean((torch.tanh(mb["x"] @ p["w1"]) @ p["w2"] - mb["y"])
                      ** 2)


def _data(t, h):
    r = np.random.default_rng(100 + t)
    x = r.normal(size=(N, h, B, D)).astype(np.float32)
    y = (x.sum(-1, keepdims=True) > 0).astype(np.float32)
    return x, y


def _cfgs(impl, quantize, mode, algo="swarm"):
    nonblocking, overlap = mode in ("nonblocking", "overlap"), \
        mode == "overlap"
    h = H if algo == "swarm" else 1
    kw = dict(n_nodes=N, H=h, quantize=quantize, nonblocking=nonblocking,
              overlap=overlap, gossip_impl=impl, pool_size=K)
    return (JSwarmConfig(quant=JS.ModularQuantConfig(**Q8), codec=None,
                         **kw),
            SwarmConfig(quant=TS.ModularQuantConfig(**Q8), **kw))


@functools.lru_cache(maxsize=None)
def _jax_run(impl, quantize, mode, algo="swarm"):
    """STEPS jitted JAX supersteps on `impl`; -> the numpy states before
    each superstep and after the last, the perms fed, the uniforms, the
    batches and the losses."""
    jscfg, _ = _cfgs(impl, quantize, mode, algo)
    g = jmake_graph("complete", N)
    opt = jmake_optimizer("sgd", lr=LR, momentum=0.9)
    probe = jax.eval_shape(_jtiny_init, jax.random.PRNGKey(0))
    tr = JE.transport_from_config(jscfg, g, SEED, probe)
    if algo == "swarm":
        step = jmake_swarm_step(jscfg, _jloss, opt.update, lambda s: LR,
                                transport=tr)
    else:
        step = jmake_algorithm(algo, loss_fn=_jloss, opt_update=opt.update,
                               lr_fn=lambda s: LR, n_nodes=N, transport=tr,
                               quantize=quantize,
                               nonblocking=mode == "nonblocking")
    step = jax.jit(step)
    state = jswarm_init(jax.random.PRNGKey(0), jscfg, _jtiny_init, opt.init,
                        same_init=quantize)
    rng_np = np.random.default_rng(3)
    n_padded = JB.build_layout(state.params).n_padded
    out = {"states": [], "perms": [], "us": [], "batches": [],
           "losses": []}
    h_slots = jscfg.h_loop_bound
    for t in range(STEPS):
        out["states"].append(jax.device_get(
            (state.params, state.opt, state.prev, state.inflight)))
        perm = jtrain.sample_gossip_perm(jscfg, g, rng_np, SEED)
        x, y = _data(t, h_slots)
        key = jax.random.PRNGKey(1000 + t)
        state, m = step(state, (jnp.asarray(x), jnp.asarray(y)),
                        jnp.asarray(perm), jnp.full((N,), h_slots, jnp.int32),
                        key)
        out["perms"].append(perm)
        out["batches"].append((x, y))
        out["losses"].append(float(m["loss"]))
        if not quantize:
            u = None
        elif impl.endswith("_legacy"):
            u = _legacy_uniforms(key, state.params)
        else:
            u = np.asarray(jax.random.uniform(key, (N, n_padded)))
        out["us"].append(u)
    out["states"].append(jax.device_get(
        (state.params, state.opt, state.prev, state.inflight)))
    return out


def _port_step(impl, quantize, mode, algo="swarm"):
    _, scfg = _cfgs(impl, quantize, mode, algo)
    opt = make_optimizer("sgd", lr=LR, momentum=0.9)
    tr = TE.transport_from_config(scfg, make_graph("complete", N), SEED)
    if algo == "swarm":
        return make_swarm_step(scfg, _tloss, opt.update, lambda s: LR,
                               transport=tr), scfg
    return make_algorithm(algo, loss_fn=_tloss, opt_update=opt.update,
                          lr_fn=lambda s: LR, n_nodes=N, transport=tr,
                          quantize=quantize,
                          nonblocking=mode == "nonblocking"), scfg


def _port_state(np_state, t):
    params, opt, prev, infl = np_state
    conv = (lambda x: None if x is None else params_from_numpy(x, "cpu"))
    if infl is not None:
        infl = {k: (tuple(_t(w) for w in v) if isinstance(v, tuple)
                    else _t(v)) for k, v in infl.items()}
    return SwarmState(conv(params), conv(opt), conv(prev), t, infl)


def _flat(params):
    if not isinstance(tree_leaves(params)[0], torch.Tensor):
        params = params_from_numpy(params, "cpu")
    return TB.pack(TB.build_layout(params), params).numpy()


def _call(step, state, run, t):
    x, y = run["batches"][t]
    u = run["us"][t]
    if isinstance(u, list):
        u = [_t(a) for a in u]
    elif u is not None:
        u = _t(u)
    h = np.full((N,), x.shape[1], np.int32)
    return step(state, {"x": _t(x), "y": _t(y)}, run["perms"][t], h, None,
                u=u)


class _Scales:
    """The port's lattice scales of the last exchange, [N, rows] in the
    flat layout's rows (a legacy oracle's per-leaf blocks are those rows:
    every leaf segment is padded to whole 256-blocks)."""

    def __init__(self, monkeypatch, legacy):
        self.rows = None
        if legacy:
            orig = TE.encode_modular

            def rec(cfg, x, ref, rng=None, **kw):
                q, s = orig(cfg, x, ref, rng, **kw)
                self._leaf.append(s)
                return q, s
            monkeypatch.setattr(TE, "encode_modular", rec)
        else:
            orig = LatticeCodec.encode

            def rec(codec, buf, prev_buf, rng, **kw):
                q, s = orig(codec, buf, prev_buf, rng, **kw)
                self.rows = s.reshape(N, -1)
                return q, s
            monkeypatch.setattr(LatticeCodec, "encode", rec)
        self._leaf = []

    def of(self, n_rows):
        if self._leaf:
            s = torch.cat(self._leaf, dim=1)
            self._leaf = []
            pad = torch.ones((N, n_rows - s.shape[1]))
            self.rows = torch.cat([s, pad], dim=1)
        return self.rows


def _q8_readings(tparams, jparams, scales, partner):
    d = np.abs(_flat(tparams) - _flat(jparams)).reshape(N, -1, 256)
    s = scales.numpy().reshape(N, -1, 1)[np.asarray(partner)]
    return {"max_abs": float(d.max()),
            "share_within_2e-5": float((d <= 2e-5).mean()),
            "beyond_one_step": int((d > s + 2e-5).sum())}


def _node_perm(impl, tr, perm):
    if impl.startswith("ppermute_pool"):
        return np.asarray(tr.matching_pool[int(perm[0])])
    return np.asarray(perm)


ENGINE_CASES = [(impl, mode) for impl in IMPLS
                for mode in ("blocking", "nonblocking")] + \
    [("ppermute", "overlap"), ("ppermute_pool", "overlap")]


@pytest.mark.parametrize("quantize", [False, True], ids=["exact", "q8"])
@pytest.mark.parametrize("impl,mode", ENGINE_CASES,
                         ids=[f"{i}-{m}" for i, m in ENGINE_CASES])
def test_superstep_per_impl_matches_jax(impl, mode, quantize, monkeypatch):
    run = _jax_run(impl, quantize, mode)
    step, scfg = _port_step(impl, quantize, mode)
    # the driver's perm stream is the JAX driver's: a matching, the
    # static one, or the pool index broadcast
    rng_np = np.random.default_rng(3)
    g = make_graph("complete", N)
    for t in range(STEPS):
        _bits(run["perms"][t],
              ttrain.sample_gossip_perm(scfg, g, rng_np, SEED))
    if not quantize:
        state = _port_state(run["states"][0], 0)
        losses = []
        for t in range(STEPS):
            state, m = _call(step, state, run, t)
            losses.append(float(m["loss"]))
            np.testing.assert_allclose(_flat(state.params),
                                       _flat(run["states"][t + 1][0]),
                                       atol=2e-5, rtol=0, err_msg=str(t))
        np.testing.assert_allclose(losses, run["losses"], rtol=1e-5)
        return
    scales = _Scales(monkeypatch, impl.endswith("_legacy"))
    tr = TE.transport_from_config(scfg, g, SEED)
    for t in range(STEPS):
        state, m = _call(step, _port_state(run["states"][t], t), run, t)
        np.testing.assert_allclose(float(m["loss"]), run["losses"][t],
                                   rtol=1e-5)
        rows = TB.build_layout(state.params).rows_per_node
        r = _q8_readings(state.params, run["states"][t + 1][0],
                         scales.of(rows),
                         _node_perm(impl, tr, run["perms"][t]))
        assert r["beyond_one_step"] == 0 and \
            r["share_within_2e-5"] >= 0.999, (t, r)


# ---------------------------------------------------------------------------
# The port's own bitwise pairs
# ---------------------------------------------------------------------------


def _port_run(impl, algo="swarm", mode="blocking", perms=None, masks=None,
              quantize=False):
    """STEPS port supersteps from the port's own init (distinct nodes);
    -> the flat trajectory [STEPS, N, n_padded]."""
    step, scfg = _port_step(impl, quantize, mode, algo)
    opt = make_optimizer("sgd", lr=LR, momentum=0.9)
    gen = torch.Generator().manual_seed(0)

    def init(g):
        return {"w1": torch.randn(D, HID, generator=g) * 0.3,
                "w2": torch.randn(HID, 1, generator=g) * 0.3}
    state = swarm_init(gen, scfg, init, opt.init)
    # distinct nodes, so that every exchange moves something
    state.params = {k: v + 0.1 * torch.randn(v.shape, generator=gen)
                    for k, v in state.params.items()}
    if state.inflight is not None:
        from repro_torch.core.swarm import pipeline_prologue
        state = pipeline_prologue(scfg, SwarmState(state.params, state.opt,
                                                   None, 0), gen)
    rng_np = np.random.default_rng(3)
    g = make_graph("complete", N)
    traj = []
    for t in range(STEPS):
        perm = perms[t] if perms is not None else \
            ttrain.sample_gossip_perm(scfg, g, rng_np, SEED)
        x, y = _data(t, scfg.h_loop_bound)
        state, _ = step(state, {"x": _t(x), "y": _t(y)}, perm,
                        np.full((N,), scfg.h_loop_bound, np.int32), gen,
                        None if masks is None else masks[t])
        traj.append(_flat(state.params))
    return np.stack(traj)


@pytest.mark.parametrize("mode", ["blocking", "nonblocking"])
@pytest.mark.parametrize("base", ["gather", "ppermute", "ppermute_pool"])
def test_flat_exact_equals_its_legacy_oracle(base, mode):
    np.testing.assert_array_equal(_port_run(base, mode=mode),
                                  _port_run(base + "_legacy", mode=mode))


def test_flat_exact_equals_legacy_on_mixed_dtypes():
    _, tt = _trees(_mixed_tree(np.random.default_rng(2)))
    layout = TB.build_layout(tt)
    matched = _t(PERM != np.arange(N))
    flat = TB.unpack(layout, TB.gossip_flat_exact(TB.pack(layout, tt),
                                                  _t(PERM), matched))
    for a, b in zip(tree_leaves(flat),
                    tree_leaves(TE.gossip_exact(tt, _t(PERM), matched))):
        assert torch.equal(a, b)


def _masks(seed=7):
    r = np.random.default_rng(seed)
    return [r.random(N) < 0.6 for _ in range(STEPS)]


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("algo,mode", [("adpsgd", "blocking"),
                                       ("adpsgd", "nonblocking"),
                                       ("sgp", "blocking"),
                                       ("localsgd", "blocking"),
                                       ("dpsgd", "blocking"),
                                       ("allreduce", "blocking")])
def test_baselines_flat_equal_gather_legacy(algo, mode, masked):
    """As the reference's tests/test_baseline_parity.py: bitwise for the
    gather and mean exchanges, fp32 tolerance for D-PSGD's matmul."""
    masks = _masks() if masked else None
    a = _port_run_algo(algo, "gather", mode, masks)
    b = _port_run_algo(algo, "gather_legacy", mode, masks)
    if algo == "dpsgd":
        np.testing.assert_allclose(a, b, rtol=2e-6, atol=2e-6)
    else:
        np.testing.assert_array_equal(a, b)


def _port_run_algo(algo, impl, mode, masks):
    opt = make_optimizer("sgd", lr=LR, momentum=0.0)
    _, scfg = _cfgs(impl, False, mode, algo)
    tr = TE.transport_from_config(scfg, make_graph("complete", N), SEED)
    kw = dict(loss_fn=_tloss, opt_update=opt.update, lr_fn=lambda s: LR,
              n_nodes=N, transport=tr)
    h = H if algo == "localsgd" else 1
    if algo == "localsgd":
        kw["H"] = H
    if algo == "dpsgd":
        kw["graph"] = make_graph("complete", N)
    if algo in ("adpsgd", "sgp"):
        kw["quantize"] = False
    if algo == "adpsgd":
        kw["nonblocking"] = mode == "nonblocking"
    step = make_algorithm(algo, **kw)
    gen = torch.Generator().manual_seed(0)
    sc = SwarmConfig(n_nodes=N, H=h, nonblocking=mode == "nonblocking")
    state = swarm_init(gen, sc, lambda g: {
        "w1": torch.randn(D, HID, generator=g) * 0.3,
        "w2": torch.randn(HID, 1, generator=g) * 0.3}, opt.init)
    state.params = {k: v + 0.1 * torch.randn(v.shape, generator=gen)
                    for k, v in state.params.items()}
    if algo == "sgp":
        from repro_torch.algorithms.sgp import sgp_init_state
        state = sgp_init_state(state, N, False)
    rng_np = np.random.default_rng(3)
    g = make_graph("complete", N)
    traj = []
    for t in range(STEPS):
        x, y = _data(t, h)
        state, m = step(state, {"x": _t(x), "y": _t(y)},
                        sample_matching(g, rng_np),
                        np.full((N,), h, np.int32), gen,
                        None if masks is None else masks[t])
        assert np.isfinite(float(m["loss"]))
        p = state.params["model"] if algo == "sgp" else state.params
        traj.append(_flat(p))
    return np.stack(traj)


@pytest.mark.parametrize("algo", ["swarm", "adpsgd"])
def test_pool_fed_gathers_matchings_equals_gather(algo):
    """ppermute_pool fed pool indices equals gather fed the matchings
    those indices select (the reference's
    test_adpsgd_pool_transport_matches_gather), bitwise."""
    _, scfg = _cfgs("ppermute_pool", False, "blocking", algo)
    pool = TE.transport_from_config(scfg, make_graph("complete", N),
                                    SEED).matching_pool
    r = np.random.default_rng(5)
    idxs = [int(r.integers(K)) for _ in range(STEPS)]
    if algo == "swarm":
        a = _port_run("ppermute_pool",
                      perms=[np.full((N,), i, np.int32) for i in idxs])
        b = _port_run("gather", perms=[pool[i] for i in idxs])
    else:
        a = _port_run("ppermute_pool", algo="adpsgd",
                      perms=[np.full((N,), i, np.int32) for i in idxs])
        b = _port_run("gather", algo="adpsgd", perms=[pool[i] for i in idxs])
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", ["blocking", "overlap"])
def test_chunk_driver_on_the_pool_equals_per_step(mode):
    """--scan-chunk on ppermute_pool (the pool index rides the chunk's
    perm rows) equals the per-step driver bitwise, q8."""
    outs = []
    for chunked in (False, True):
        step, scfg = _port_step("ppermute_pool", True, mode)
        opt = make_optimizer("sgd", lr=LR, momentum=0.9)
        gen = torch.Generator().manual_seed(0)
        state = swarm_init(gen, scfg, lambda g: {
            "w1": torch.randn(D, HID, generator=g) * 0.3,
            "w2": torch.randn(HID, 1, generator=g) * 0.3}, opt.init)
        rng_np = np.random.default_rng(3)
        g = make_graph("complete", N)
        perms = np.stack([ttrain.sample_gossip_perm(scfg, g, rng_np, SEED)
                          for _ in range(STEPS)])
        hs = np.full((STEPS, N), H, np.int32)
        xs, ys = zip(*[_data(t, H) for t in range(STEPS)])
        if chunked:
            chunk = make_superstep_scan(step)
            state, ms = chunk(state, gen, {"x": _t(np.stack(xs)),
                                           "y": _t(np.stack(ys))}, perms, hs)
            loss = ms["loss"].tolist()
        else:
            loss = []
            for t in range(STEPS):
                state, m = step(state, {"x": _t(xs[t]), "y": _t(ys[t])},
                                perms[t], hs[t], gen)
                loss.append(float(m["loss"]))
        outs.append((loss, _flat(state.params)))
    assert outs[0][0] == outs[1][0]
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


# ---------------------------------------------------------------------------
# Refusals, the bridge, the drivers
# ---------------------------------------------------------------------------


def test_refusals_are_the_reference():
    g = make_graph("complete", N)
    pool = TE.make_matching_pool(g, K, 0)
    # a codec with no per-leaf form on a legacy oracle
    for impl in ("gather_legacy", "ppermute_pool_legacy"):
        with pytest.raises(ValueError, match="no per-leaf form"):
            TE.GossipTransport(N, impl=impl, codec=make_codec("bf16"),
                               matching_pool=pool)
        with pytest.raises(ValueError, match="no per-leaf form"):
            JE.GossipTransport(impl, N, codec=jmake_codec("bf16"),
                               matching_pool=pool, mesh=object(),
                               node_axes=())
    # a residual codec off gather
    with pytest.raises(ValueError, match="error-feedback residual"):
        TE.GossipTransport(N, impl="ppermute_pool",
                           codec=make_codec("topk:0.25"), matching_pool=pool)
    # a mask on a per-leaf ppermute oracle
    tr = TE.GossipTransport(N, impl="ppermute_legacy",
                            static_pairs=TB.pairs_from_perm(PERM))
    tree = {"w": torch.zeros(N, 3)}
    with pytest.raises(NotImplementedError, match="masks"):
        tr.mix_pair(tree, _t(PERM), _t(PERM != np.arange(N)),
                    mask=torch.ones(N, dtype=torch.bool))
    # the overlap pipeline runs flat
    with pytest.raises(ValueError, match="flat transport"):
        make_swarm_step(SwarmConfig(n_nodes=N, nonblocking=True,
                                    overlap=True, gossip_impl="gather_legacy"),
                        _tloss, make_optimizer("sgd").update, lambda s: LR)
    # compress_state keeps a packed comm copy
    with pytest.raises(ValueError, match="compress_state"):
        make_swarm_step(SwarmConfig(n_nodes=N, quantize=True,
                                    compress_state=True,
                                    gossip_impl="gather_legacy"),
                        _tloss, make_optimizer("sgd").update, lambda s: LR)
    # the wiring each ppermute transport needs
    with pytest.raises(ValueError, match="static_pairs"):
        TE.GossipTransport(N, impl="ppermute")
    with pytest.raises(ValueError, match="matching_pool"):
        TE.GossipTransport(N, impl="ppermute_pool")
    with pytest.raises(ValueError, match="unknown gossip impl"):
        TE.GossipTransport(N, impl="allgather")
    with pytest.raises(ValueError, match="gossip_impl"):
        SwarmConfig(n_nodes=N, gossip_impl="allgather")
    # on a node mesh: gather and the chunk driver build there too, and a
    # rank holds one node — no fallback to the one-shard path
    mesh = NodeMesh(0, 2, torch.device("cpu"))
    assert TE.GossipTransport(2, mesh=mesh).mesh is mesh
    assert validate_run_config("swarm", n_nodes=2, mesh=mesh,
                               scan_chunk=4) is not None
    for fn in (lambda: TE.GossipTransport(N, impl="ppermute",
                                          static_pairs=[(0, 1)], mesh=mesh),
               lambda: TB.gossip_flat_ppermute(torch.zeros(N, 256),
                                               [(0, 1)], mesh=mesh),
               lambda: TE.gossip_ppermute({"w": torch.zeros(N, 2)},
                                          [(0, 1)], mesh=mesh)):
        with pytest.raises(ValueError, match="ROADMAP"):
            fn()


@pytest.mark.parametrize("algo", ["swarm", "adpsgd", "sgp", "localsgd",
                                  "dpsgd", "allreduce"])
def test_validate_is_the_reference_over_every_impl(algo, monkeypatch):
    from repro.algorithms import validate_run_config as jvalidate
    for var in ("REPRO_DEFAULT_GOSSIP_IMPL", "REPRO_CODEC", "REPRO_TOPOLOGY",
                "REPRO_AVAIL_PROFILE"):
        monkeypatch.delenv(var, raising=False)

    def ok(fn, **kw):
        try:
            fn(algo, **kw)
        except ValueError:
            return False
        return True
    for impl in IMPLS:
        for kw in ({}, {"quantize": True}, {"nonblocking": True},
                   {"overlap": True, "nonblocking": True},
                   {"quantize": True, "codec": "topk:0.25"},
                   {"quantize": True, "compress_state": True},
                   {"topology": "hier:4", "n_nodes": 8},
                   {"rate_profile": "lognormal"}):
            assert ok(validate_run_config, gossip_impl=impl, **kw) == \
                ok(jvalidate, gossip_impl=impl, **kw), (impl, kw)


@pytest.mark.parametrize("impl", ["gather", "gather_legacy",
                                  "ppermute_pool", "ppermute_pool_legacy"])
def test_engine_inputs_for_each_impl(impl):
    from repro_torch.sched import generate_trace, pool_edges, bin_trace
    from repro_torch.sched import RateProfile
    from repro.sched import bin_trace as jbin_trace
    from repro.sched import generate_trace as jgenerate_trace
    from repro.sched import RateProfile as JRateProfile
    g, jg = make_graph("complete", N), jmake_graph("complete", N)
    pool = TE.make_matching_pool(g, K, 2)
    tt = generate_trace(g, RateProfile(), 40, seed=1, edges=pool_edges(pool))
    jt = jgenerate_trace(jg, JRateProfile(), 40, seed=1,
                         edges=pool_edges(pool))
    ts, js = bin_trace(tt, pool=pool), jbin_trace(jt, pool=pool)
    for s in range(ts.n_supersteps):
        for a, b in zip(TBR.engine_inputs(ts, s, impl),
                        JBR.engine_inputs(js, s, impl)):
            _bits(b, a)
    for a, b in zip(TBR.stacked_engine_inputs(ts, 0, None, impl),
                    JBR.stacked_engine_inputs(js, 0, None, impl)):
        _bits(b, a)
    if impl.startswith("ppermute_pool"):
        perm, _, _ = TBR.engine_inputs(ts, 0, impl)
        assert (perm == ts.pool_idx[0]).all()


DRIVER = ["--reduced", "--layers", "1", "--d-model", "32", "--nodes", "4",
          "--steps", "3", "--seq", "16", "--batch", "2", "--log-every", "1",
          "--pool-size", "4", "--seed", "2"]


@pytest.mark.parametrize("base", ["gather", "ppermute", "ppermute_pool"])
def test_driver_runs_every_gossip_impl(base, capsys):
    """`--gossip-impl` in the port's driver, exact: each flat transport's
    records equal its *_legacy oracle's bit for bit (the transports differ
    in how they move rows, not in what lands), and the (perm, h) streams
    the driver feeds are the JAX driver's for the same seed."""
    recs = {impl: ttrain.main(DRIVER + ["--device", "cpu", "--gossip-impl",
                                        impl])
            for impl in (base, base + "_legacy")}
    capsys.readouterr()
    a, b = recs[base], recs[base + "_legacy"]
    assert [(r["step"], r["loss"], r["gamma"]) for r in a] == \
        [(r["step"], r["loss"], r["gamma"]) for r in b]
    assert all(np.isfinite(r["loss"]) for r in a)
    for impl in (base, base + "_legacy"):
        for topo in (None, "hier:2") if base != "ppermute" else (None,):
            jscfg = JSwarmConfig(n_nodes=4, gossip_impl=impl, pool_size=4,
                                 topology=topo)
            scfg = SwarmConfig(n_nodes=4, gossip_impl=impl, pool_size=4,
                               topology=topo)
            jtopo = None if topo is None else jparse_topology(topo, 4)
            ttopo = None if topo is None else parse_topology(topo, 4)
            jp, jh = jtrain.presample_inputs(
                jscfg, jmake_graph("complete", 4), np.random.default_rng(2),
                2, 5, topo=jtopo)
            tp, th = ttrain.presample_inputs(
                scfg, make_graph("complete", 4), np.random.default_rng(2),
                5, topo=ttopo, seed=2)
            _bits(jp, tp)
            _bits(jh, th)


def test_driver_refuses_where_the_reference_refuses():
    ap = ttrain.build_parser()
    args = ap.parse_args(DRIVER + ["--device", "cpu", "--gossip-impl",
                                   "ppermute", "--rate-profile",
                                   "lognormal"])
    with pytest.raises(ValueError, match="only the gather transports"):
        ttrain.build(args)
    args = ap.parse_args(DRIVER + ["--device", "cpu", "--gossip-impl",
                                   "ppermute", "--topology", "hier:2"])
    with pytest.raises(ValueError, match="does not support"):
        ttrain.build(args)
    with pytest.raises(SystemExit) as e:
        ap.parse_args(["--gossip-impl", "allgather"])
    assert e.value.code == 2
    assert ap.parse_args([]).gossip_impl is None
    assert ap.parse_args([]).device == "cuda"


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["blocking", "overlap"])
def test_wrap_counter_counts_the_rows_decoded_wrong(pipelined, monkeypatch):
    """`bucket.WRAPS` counts the matched rows whose sender and receiver
    differ by 2^(bits-1) or more of the sender's steps — the rows whose
    decode is wrong — and nothing while it is None."""
    rng = np.random.default_rng(0)
    base = rng.normal(size=(1, 2048)).astype(np.float32)
    buf = base + 0.001 * rng.normal(size=(N, 2048)).astype(np.float32)
    prev = buf + 0.01 * rng.normal(size=buf.shape).astype(np.float32)
    buf[2, 256:512] += 100.0                 # one far row of node 2
    buf, prev = _t(buf), _t(prev)
    codec = LatticeCodec(TS.ModularQuantConfig())
    perm = _t(PERM)
    matched = perm != torch.arange(N)
    gen = torch.Generator().manual_seed(0)
    monkeypatch.setattr(TB, "WRAPS", None)
    TB.gossip_flat_coded(codec, buf, prev, perm, matched, gen)
    assert TB.WRAPS is None
    monkeypatch.setattr(TB, "WRAPS", {})
    if pipelined:
        wire = codec.encode(buf, prev, gen)
        recv = tuple(TB.permute_rows(w, perm, N) for w in wire)
        TB.count_wraps(codec, recv, buf, perm, matched)
        dec = codec.decode(recv, buf).reshape(N, -1, 256)
    else:
        wire_p = tuple(TB.permute_rows(w, perm, N)
                       for w in codec.encode(buf, prev, gen))
        TB.count_wraps(codec, wire_p, buf, perm, matched)
        dec = codec.decode(wire_p, buf).reshape(N, -1, 256)
    sent = buf[perm].reshape(N, -1, 256)
    s = (wire_p if not pipelined else recv)[1].reshape(N, -1, 1)
    wrong = ((dec - sent).abs() > s).any(-1) & matched[:, None]
    # node 2 decodes node 3's row against its far row and wraps; node 3
    # decodes node 2's row at node 2's step, which its own proxy widened
    assert int(TB.WRAPS["rows"]) == int(wrong.sum()) == 1
    assert bool(wrong[2, 1])
    assert int(TB.WRAPS["checked"]) == 8 * 8
