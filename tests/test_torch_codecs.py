"""The port's whole wire-codec family against the JAX package, on the CPU.

* Wires, bitwise JAX's with the same inputs (uniforms drawn by JAX and
  injected into the port): lattice codes and scales at q2/q4/q8/q12/q16
  and at a fixed resolution ε, and their decode-average; the bf16 wire and
  its decode-average; top-k's dense transmitted part and the residual after
  ``encode_ef`` (compared through the dense scatter, since ``lax.top_k``
  and ``torch.topk`` may pick different coordinates among equal
  magnitudes), and its decode-average; ``encode_state`` /
  ``decode_state``.
* Declared payload bytes equal the real arrays for every spec.
* One step per codec and per mode the capability row allows, for
  SwarmSGD (blocking, non-blocking, overlapped, compress_state), AD-PSGD
  and SGP, each restarted from the jitted JAX engine's state before it with
  its uniforms, on the tiny tanh-regression engine of
  ``tests/test_torch_algorithms.py``. Bound (the slice contract): at least
  99.9% of the coordinates within 2e-5 and every one within 2e-5 plus a
  codec term — one lattice step of the decoded row (the partner's) for
  the lattice; 2^-7 of the value (one bf16 step of the cast) for bf16;
  half the largest transmitted magnitude of the partner's row for top-k,
  whose selection may swap two coordinates whose magnitudes differ by an
  ulp (jitted JAX contracts multiply-adds). Top-k's residual is held to
  the same form, with its own row's largest transmitted magnitude.
* Checkpoints of a top-k run (with its residual) and of a compress_state
  run (its comm copy a wire tuple) load across packages both ways,
  bitwise.
* ``validate_run_config`` over algo x transport x mode x codec x
  compress_state: the port accepts exactly what JAX accepts, minus the
  transports other than gather.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.algorithms import make_algorithm as jmake_algorithm
from repro.algorithms import validate_run_config as jvalidate
from repro.algorithms.sgp import sgp_init_state as jsgp_init_state
from repro.checkpoint import load_checkpoint as jload_checkpoint
from repro.checkpoint import save_checkpoint as jsave_checkpoint
from repro.core import GossipTransport as JGossipTransport
from repro.core import SwarmConfig as JSwarmConfig
from repro.core import bucket as JB
from repro.core import make_graph as jmake_graph
from repro.core import sample_matching as jsample_matching
from repro.core import swarm_init as jswarm_init
from repro.optim import make_optimizer as jmake_optimizer
from repro.quant import codecs as JC
from repro.quant.schemes import ModularQuantConfig as JQuant
from repro_torch.algorithms import make_algorithm, validate_run_config
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.core import bucket as TB
from repro_torch.core.exchange import GossipTransport
from repro_torch.core.swarm import (SwarmConfig, SwarmState,
                                    codec_checkpoint_tree)
from repro_torch.optim import make_optimizer
from repro_torch.quant import codecs as TC
from repro_torch.quant.schemes import ModularQuantConfig
from repro_torch.tree import tree_flatten, tree_leaves

N, D, HID, B, STEPS, H = 8, 6, 16, 4, 3, 2
LR = 0.05
SAFETY = 16.0
EPS = 1e-3


# ---------------------------------------------------------------------------
# conversions
# ---------------------------------------------------------------------------


def _t(a):
    """numpy array -> tensor (uint16 through an int16 view, bfloat16
    through float32, which is exact)."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.uint16)
    return torch.from_numpy(np.array(a))


def _np(t):
    if t.dtype == torch.uint16:
        return t.view(torch.int16).numpy().view(np.uint16)
    if t.dtype == torch.bfloat16:
        return t.to(torch.float32).numpy()
    return t.numpy()


def _jnp_np(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _port_tree(x):
    """A JAX numpy tree (dicts, tuples, None) -> tensors."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _port_tree(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_port_tree(v) for v in x)
    return _t(x)


def _same(port_tree, jax_tree) -> bool:
    a = tree_flatten(port_tree, tuples=True)[0]
    b = jax.tree.leaves(jax.device_get(jax_tree))
    return len(a) == len(b) and all(
        np.array_equal(_np(x), _jnp_np(y)) for x, y in zip(a, b))


def _inputs(seed, shape=(2, 2048), scale=0.01):
    r = np.random.default_rng(seed)
    buf = r.standard_normal(shape).astype(np.float32)
    prev = (buf + scale * r.standard_normal(shape)).astype(np.float32)
    return buf, prev


# ---------------------------------------------------------------------------
# wires, bitwise
# ---------------------------------------------------------------------------


LATTICE = [("q2", None), ("q4", None), ("q8", None), ("q12", None),
           ("q16", None), ("q8", EPS), ("q4", EPS), ("q16", EPS)]


@pytest.mark.parametrize("spec,eps", LATTICE,
                         ids=[f"{s}{'-eps' if e else ''}" for s, e in LATTICE])
def test_lattice_wire_and_decode_bitwise(spec, eps):
    buf, prev = _inputs(0)
    key = jax.random.PRNGKey(5)
    jc = JC.make_codec(spec, JQuant(safety=SAFETY, resolution=eps))
    tc = TC.make_codec(spec, ModularQuantConfig(safety=SAFETY,
                                                resolution=eps))
    assert tc.needs_prev == jc.needs_prev == (eps is None)
    jw = jc.encode(jnp.asarray(buf), jnp.asarray(prev), key)
    u = np.asarray(jax.random.uniform(key, buf.shape, jnp.float32))
    tw = tc.encode(torch.from_numpy(buf), torch.from_numpy(prev), None,
                   u=torch.from_numpy(u.copy()))
    assert len(tw) == len(jw) == 2
    for a, b in zip(tw, jw):
        assert _np(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    # the receiver: decode against its own y, matched rows averaged
    rows = tw[0].shape[0]
    m = np.arange(rows) % 3 != 0
    y = prev
    want = jc.decode_avg(jw, jnp.asarray(y), jnp.asarray(m))
    got = tc.decode_avg(tw, torch.from_numpy(y), torch.from_numpy(m))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bf16_wire_and_decode_bitwise():
    buf, y = _inputs(1)
    jc, tc = JC.make_codec("bf16"), TC.make_codec("bf16")
    (jv,) = jc.encode(jnp.asarray(buf), None, None)
    (tv,) = tc.encode(torch.from_numpy(buf), None, None)
    assert tv.dtype == torch.bfloat16 and tv.shape == (16, 256)
    np.testing.assert_array_equal(_np(tv), _jnp_np(jv))
    m = np.arange(16) % 4 != 1
    for ydt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        jy = jnp.asarray(y).astype(ydt)
        ty = torch.from_numpy(y).to(tdt)
        want = jc.decode_avg((jv,), jy, jnp.asarray(m))
        got = tc.decode_avg((tv,), ty, torch.from_numpy(m))
        np.testing.assert_array_equal(_np(got), _jnp_np(want))
        np.testing.assert_array_equal(_np(tc.decode((tv,), ty)),
                                      _jnp_np(jc.decode((jv,), jy)))


@pytest.mark.parametrize("frac", [0.25, 0.1, 1.0])
def test_topk_dense_part_and_residual_bitwise(frac):
    """The dense transmitted part (the scatter of the shipped values at
    their indices), the residual after the send and the decode-average
    are JAX's; a row with x = prev and no residual (every coordinate
    ties) ships zeros in both."""
    buf, prev = _inputs(2)
    prev[1, :256] = buf[1, :256]                   # an all-tie row
    res = (0.003 * np.random.default_rng(3).standard_normal(buf.shape)) \
        .astype(np.float32)
    res[1, :256] = 0.0
    spec = f"topk:{frac}"
    jc, tc = JC.make_codec(spec), TC.make_codec(spec)
    assert tc.k == jc.k and tc.name == jc.name
    (jv, ji), jres = jc.encode_ef(jnp.asarray(buf), jnp.asarray(prev), None,
                                  jnp.asarray(res))
    (tv, ti), tres = tc.encode_ef(torch.from_numpy(buf),
                                  torch.from_numpy(prev), None,
                                  torch.from_numpy(res.copy()))
    assert ti.dtype == torch.uint8 and tv.dtype == torch.float32
    d = (buf - prev).reshape(-1, 256) + res.reshape(-1, 256)
    jdense = np.asarray(jc._scatter(jnp.asarray(d), ji.astype(jnp.int32),
                                    jv))
    tdense = TC.TopKCodec._scatter(torch.from_numpy(d), ti.long(), tv)
    np.testing.assert_array_equal(tdense.numpy(), jdense)
    np.testing.assert_array_equal(tres.numpy(), np.asarray(jres))
    assert not np.any(jdense[8]) and not tdense[8].any()
    # the plain encode ships the same dense part without a residual
    tv0, ti0 = tc.encode(torch.from_numpy(buf), torch.from_numpy(prev), None)
    jv0, ji0 = jc.encode(jnp.asarray(buf), jnp.asarray(prev), None)
    d0 = (buf - prev).reshape(-1, 256)
    np.testing.assert_array_equal(
        TC.TopKCodec._scatter(torch.from_numpy(d0), ti0.long(), tv0).numpy(),
        np.asarray(jc._scatter(jnp.asarray(d0), ji0.astype(jnp.int32), jv0)))
    m = np.arange(16) % 3 != 2
    want = jc.decode_avg((jv, ji), jnp.asarray(prev), jnp.asarray(m))
    got = tc.decode_avg((tv, ti), torch.from_numpy(prev), torch.from_numpy(m))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tc.decode((tv, ti), torch.from_numpy(prev)).numpy(),
        np.asarray(jc.decode((jv, ji), jnp.asarray(prev))))


SPECS = ["q2", "q3", "q4", "q5", "q8", "q9", "q12", "q16", "bf16",
         "topk:0.25", "topk:0.1", "topk:1.0"]


@pytest.mark.parametrize("spec", SPECS)
def test_payload_num_bytes_equals_the_real_arrays(spec):
    buf, prev = _inputs(4, shape=(4, 4096))
    tc, jc = TC.make_codec(spec), JC.make_codec(spec)
    wire = tc.encode(torch.from_numpy(buf), torch.from_numpy(prev), None,
                     u=torch.rand(buf.shape))
    real = sum(w.numel() * w.element_size() for w in wire) // 4
    assert tc.payload_num_bytes(4096) == real == jc.payload_num_bytes(4096)
    assert tc.wire_layout().bytes_per_row == jc.wire_layout().bytes_per_row
    assert [(g.name, g.dtype, g.cols) for g in tc.wire_layout().groups] == \
        [(g.name, g.dtype, g.cols) for g in jc.wire_layout().groups]


@pytest.mark.parametrize("spec", ["q8", "q4", "q16"])
def test_encode_state_and_decode_state_bitwise(spec):
    buf, _ = _inputs(5)
    key = jax.random.PRNGKey(9)
    jc, tc = JC.make_codec(spec), TC.make_codec(spec)
    jw = jc.encode_state(jnp.asarray(buf), key)
    u = np.asarray(jax.random.uniform(key, buf.shape, jnp.float32))
    tw = tc.encode_state(torch.from_numpy(buf), None,
                         u=torch.from_numpy(u.copy()))
    for a, b in zip(tw, jw):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    want = jc.decode_state(jw, buf.shape)
    got = tc.decode_state(tw, buf.shape)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("spec", ["q4", "bf16", "topk:0.25"])
def test_transport_residual_like_matches_jax(spec):
    """GossipTransport(codec=): the zero residual of an error-feedback
    codec (None otherwise), as JAX's."""
    tree = np.zeros((N, 300), np.float32)
    jt = JGossipTransport("gather", N, codec=JC.make_codec(spec))
    tt = GossipTransport(N, codec=TC.make_codec(spec))
    jr = jt.residual_like({"w": jnp.asarray(tree)})
    tr = tt.residual_like({"w": torch.from_numpy(tree)})
    assert (jr is None) == (tr is None) == (spec != "topk:0.25")
    if tr is not None:
        assert tuple(tr.shape) == jr.shape and not tr.any()


# ---------------------------------------------------------------------------
# one step per codec and mode, restarted from the reference
# ---------------------------------------------------------------------------


def _jinit(rng):
    k1, k2 = jax.random.split(rng)
    return {"w1": jax.random.normal(k1, (D, HID)) * 0.3,
            "w2": jax.random.normal(k2, (HID, 1)) * 0.3}


def _jloss(p, mb):
    x, y = mb
    return jnp.mean((jnp.tanh(x @ p["w1"]) @ p["w2"] - y) ** 2)


def _tloss(p, mb):
    return torch.mean((torch.tanh(mb["x"] @ p["w1"]) @ p["w2"] - mb["y"])
                      ** 2)


def _data(t, h_slots):
    r = np.random.default_rng(100 + t)
    x = r.normal(size=(N, h_slots, B, D)).astype(np.float32)
    y = (x.sum(-1, keepdims=True) > 0).astype(np.float32)
    return x, y


MODE_KW = {"blocking": {}, "nonblocking": {"nonblocking": True},
           "overlap": {"nonblocking": True, "overlap": True},
           "compress": {"compress_state": True}}


@functools.lru_cache(maxsize=None)
def _jax_run(algo, spec, mode):
    """STEPS jitted JAX steps; -> dict of numpy states before each step
    (and after the last), perms, batches, losses and the uniforms of each
    step's encode (`us`) and of compress_state's re-encode (`us_state`)."""
    quant = JQuant(safety=SAFETY)
    codec = JC.make_codec(spec, quant)
    h_slots = H if algo == "swarm" else 1
    scfg = JSwarmConfig(n_nodes=N, H=h_slots, quantize=True, quant=quant,
                        codec=spec, gossip_impl="gather",
                        track_potential=False, **MODE_KW[mode])
    opt = jmake_optimizer("sgd", lr=LR, momentum=0.9)
    tr = JGossipTransport("gather", N, quant=quant, codec=codec)
    kw = dict(loss_fn=_jloss, opt_update=opt.update, lr_fn=lambda s: LR,
              n_nodes=N, transport=tr)
    if algo == "swarm":
        kw["scfg"] = scfg
    else:
        kw["quantize"] = True
    if algo == "adpsgd":
        kw["nonblocking"] = mode == "nonblocking"
    step = jax.jit(jmake_algorithm(algo, **kw))
    state = jswarm_init(jax.random.PRNGKey(0), scfg, _jinit, opt.init,
                        same_init=True)
    if algo == "sgp":
        state = jsgp_init_state(state, N, True)
    g = jmake_graph("complete", N)
    rng_np = np.random.default_rng(3)
    n_padded = JB.build_layout(state.params).n_padded
    h = jnp.full((N,), h_slots, jnp.int32)
    out = {"states": [], "perms": [], "batches": [], "losses": [], "us": [],
           "us_state": []}

    def snap(st):
        return jax.device_get((st.params, st.opt, st.prev, st.inflight,
                               st.residual))
    for t in range(STEPS):
        out["states"].append(snap(state))
        perm = jsample_matching(g, rng_np)
        x, y = _data(t, h_slots)
        key = jax.random.PRNGKey(1000 + t)
        state, m = step(state, (jnp.asarray(x), jnp.asarray(y)),
                        jnp.asarray(perm), h, key)
        out["perms"].append(perm)
        out["batches"].append((x, y))
        out["losses"].append(float(m["loss"]))
        out["us"].append(np.asarray(jax.random.uniform(
            key, (N, n_padded), jnp.float32)))
        out["us_state"].append(np.asarray(jax.random.uniform(
            jax.random.fold_in(key, 0x5E), (N, n_padded), jnp.float32)))
    out["states"].append(snap(state))
    return out


class Recording:
    """Wraps a port codec: remembers each encode's per-row bound term —
    the lattice scale, or top-k's largest shipped magnitude."""

    def __init__(self, codec):
        self.codec = codec
        self.rows = []

    def __getattr__(self, name):
        return getattr(self.codec, name)

    def _note(self, wire):
        if isinstance(self.codec, TC.LatticeCodec):
            self.rows.append(wire[1].reshape(-1).clone())
        elif isinstance(self.codec, TC.TopKCodec):
            self.rows.append(wire[0].abs().amax(dim=1))

    def encode(self, *a, **kw):
        w = self.codec.encode(*a, **kw)
        self._note(w)
        return w

    def encode_ef(self, *a, **kw):
        w, r = self.codec.encode_ef(*a, **kw)
        self._note(w)
        return w, r

    def encode_state(self, buf, rng, *, u=None, tile_rows=8):
        return self.codec.encode_state(buf, rng, u=u, tile_rows=tile_rows)


def _port_state(np_state, t):
    params, opt, prev, infl, res = np_state
    return SwarmState(_port_tree(params), _port_tree(opt) or {},
                      _port_tree(prev), t, _port_tree(infl),
                      _port_tree(res))


def _flat(tree):
    if not isinstance(tree_leaves(tree)[0], torch.Tensor):
        tree = _port_tree(jax.device_get(tree))
    return TB.pack(TB.build_layout(tree), tree).numpy()


def _within(d, term, partner=None):
    """(share within 2e-5, count beyond 2e-5 + term) for d [N, rows, 256]
    and a per-row term [N, rows, 1] (taken at the partner's rows)."""
    if partner is not None:
        term = term[np.asarray(partner)]
    return float((d <= 2e-5).mean()), int((d > term + 2e-5).sum())


CASES = ([("swarm", s, m) for s in ("q4", "q16", "bf16", "topk:0.25")
          for m in ("blocking", "nonblocking", "overlap")
          if not (s.startswith("topk") and m == "overlap")]
         + [("swarm", "q8", "compress"), ("swarm", "q4", "compress")]
         + [("adpsgd", s, m) for s in ("q4", "q16", "bf16", "topk:0.25")
            for m in ("blocking", "nonblocking")]
         + [("sgp", s, "blocking") for s in ("q4", "q16", "bf16")])


@pytest.mark.parametrize("algo,spec,mode", CASES,
                         ids=[f"{a}-{s}-{m}" for a, s, m in CASES])
def test_step_per_codec_matches_jax(algo, spec, mode):
    run = _jax_run(algo, spec, mode)
    quant = ModularQuantConfig(safety=SAFETY)
    codec = Recording(TC.make_codec(spec, quant))
    h_slots = H if algo == "swarm" else 1
    opt = make_optimizer("sgd", lr=LR, momentum=0.9)
    kw = dict(loss_fn=_tloss, opt_update=opt.update, lr_fn=lambda s: LR,
              n_nodes=N, transport=GossipTransport(N, codec=codec))
    if algo == "swarm":
        kw["scfg"] = SwarmConfig(n_nodes=N, H=h_slots, quantize=True,
                                 quant=quant, codec=spec,
                                 track_potential=False, **MODE_KW[mode])
    else:
        kw["quantize"] = True
    if algo == "adpsgd":
        kw["nonblocking"] = mode == "nonblocking"
    step = make_algorithm(algo, **kw)
    h = np.full((N,), h_slots, np.int32)
    for t in range(STEPS):
        x, y = run["batches"][t]
        extra = {"u": torch.from_numpy(run["us"][t].copy())}
        if mode == "compress":
            extra["u_state"] = torch.from_numpy(run["us_state"][t].copy())
        before = run["states"][t]
        codec.rows.clear()
        state, m = step(_port_state(before, t),
                        {"x": torch.from_numpy(x), "y": torch.from_numpy(y)},
                        run["perms"][t], h, None, None, **extra)
        np.testing.assert_allclose(float(m["loss"]), run["losses"][t],
                                   rtol=1e-5)
        after = run["states"][t + 1]
        want = _flat(after[0])
        d = np.abs(_flat(state.params) - want).reshape(N, -1, 256)
        partner = run["perms"][t] if algo != "sgp" else \
            (np.arange(N) - 2 ** (t % 3)) % N
        if spec == "bf16":
            term = 2.0 ** -7 * np.abs(want).reshape(N, -1, 256)
            share, beyond = _within(d, term)
        else:
            if mode == "overlap":
                # the payload decoded here was encoded a step earlier
                rows = torch.from_numpy(np.array(before[3]["wire"][1]))
            else:
                rows = codec.rows[0]
            term = rows.numpy().reshape(N, -1, 1)
            if spec.startswith("topk"):
                term = 0.5 * term
            share, beyond = _within(d, term, partner)
        assert share >= 0.999 and beyond == 0, (t, share, beyond)
        if spec.startswith("topk"):
            dr = np.abs(state.residual.numpy() -
                        np.asarray(after[4])).reshape(N, -1, 256)
            share, beyond = _within(
                dr, codec.rows[0].numpy().reshape(N, -1, 1))
            assert share >= 0.999 and beyond == 0, ("residual", t, share,
                                                    beyond)
        if mode == "compress":
            assert isinstance(state.prev, tuple) and len(state.prev) == 2
            assert state.prev[0].dtype == \
                (torch.uint16 if spec == "q16" else torch.uint8)


# ---------------------------------------------------------------------------
# checkpoints across packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec,mode", [("topk:0.25", "nonblocking"),
                                       ("q8", "compress"),
                                       ("q16", "compress")])
def test_codec_checkpoints_load_across_packages(spec, mode, tmp_path):
    """A top-k run's {params, prev, residual} and a compress_state run's
    {params, prev: wire tuple}: the port's checkpoint loads in JAX and
    JAX's in the port, bitwise, names and tree definitions equal."""
    import json
    jstate = _jax_run("swarm", spec, mode)["states"][1]
    keys = ("params", "prev", "residual")
    jtree = {k: v for k, v in zip(keys, (jstate[0], jstate[2], jstate[4]))
             if v is not None}
    tstate = _port_state(jstate, 1)
    ttree = codec_checkpoint_tree(tstate)
    assert sorted(ttree) == sorted(jtree)
    save_checkpoint(str(tmp_path / "port"), ttree, {"spec": spec})
    back_j = jload_checkpoint(str(tmp_path / "port"),
                              jax.tree.map(jnp.asarray, jtree))
    assert _same(ttree, back_j)
    jsave_checkpoint(str(tmp_path / "jax"), jtree, {"spec": spec})
    back_t = load_checkpoint(str(tmp_path / "jax"), ttree)
    assert _same(back_t, jtree)
    metas = [json.load(open(tmp_path / f"{n}.json")) for n in ("port",
                                                                 "jax")]
    for k in ("names", "dtypes", "treedef"):
        assert metas[0][k] == metas[1][k], k


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def _accepts(fn, algo, **kw):
    try:
        fn(algo, **kw)
    except (ValueError, NotImplementedError):
        return False
    return True


GRID_CODECS = (None, "q2", "q4", "q8", "q12", "q16", "bf16", "topk:0.25",
               "topk:2", "q17")


@pytest.mark.parametrize("algo", ["swarm", "adpsgd", "sgp", "localsgd",
                                  "dpsgd", "allreduce"])
def test_validate_grid_with_codecs_and_compress_state(algo, monkeypatch):
    for var in ("REPRO_DEFAULT_GOSSIP_IMPL", "REPRO_CODEC", "REPRO_TOPOLOGY",
                "REPRO_AVAIL_PROFILE"):
        monkeypatch.delenv(var, raising=False)
    n_accept = 0
    for impl in ("gather", "ppermute_pool"):
        for mode in ({}, {"nonblocking": True},
                     {"nonblocking": True, "overlap": True}):
            for quantize in (False, True):
                for codec in GRID_CODECS:
                    for cs in (False, True):
                        kw = dict(gossip_impl=impl, quantize=quantize,
                                  codec=codec, compress_state=cs, **mode)
                        j = _accepts(jvalidate, algo, **kw)
                        assert _accepts(validate_run_config, algo, **kw) \
                            == j, (algo, kw, j)
                        n_accept += j
    assert n_accept > 0
