"""The port's baselines (LB-SGD all-reduce, Local SGD, D-PSGD, AD-PSGD,
SGP), its registry and capability matrix, interaction graphs and
participation masks, against the JAX package on the CPU.

* Exact trajectories, on the tiny tanh-regression engine of
  ``tests/test_baseline_parity.py`` (8 nodes, momentum 0 and 0.9, per-node
  initial models, 6 steps from JAX's initial state, seeded matchings,
  data and masks): every node's parameters within 2e-5 of the jitted JAX
  engine's after each step and the losses within rtol 1e-5, full and
  under the masks ``_masks(seed=7)``; SwarmSGD under the same masks too.
  SGP starts from a push-sum state whose weights w are not all 1 (a
  state the directed push leaves behind), so its de-bias, re-bias and
  w mixing all show.
* q8 (AD-PSGD blocking and non-blocking, SGP; full and masked): every
  step restarts from JAX's state before it with JAX's uniforms, and is
  held to the slice's bound — every coordinate within one lattice step
  (the step of the row its node decoded, the partner's) beyond 2e-5, at
  least 99.9% within 2e-5 — which two planted faults (SGP's w row group
  not landing; every received code one step off) must fail. SGP runs its
  six q8 steps from the driver's start (w = 1) and one step from the
  push-sum state: after a node's comm copy refreshes, its distance proxy
  is one gradient step while the nodes' X differ by (w_i - w_j) x, so
  from there on the lattice decode wraps, in the reference too.
* The drivers: the same flags give the same record keys and, in exact
  mode from the same initial weights, losses within rtol 1e-5; the
  presampled (perm, h) streams are bitwise JAX's for every algorithm and
  graph kind.
* Graphs, the capability matrix and the baselines' invariants equal
  JAX's (edge sets, degree, lambda2 to 1e-9, the accepted combinations
  minus what the port does not carry yet).
"""
import functools
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.algorithms import CAPABILITIES as JCAPS
from repro.algorithms import make_algorithm as jmake_algorithm
from repro.algorithms import validate_run_config as jvalidate
from repro.algorithms.sgp import sgp_init_state as jsgp_init_state
from repro.core import GossipTransport as JGossipTransport
from repro.core import SwarmConfig as JSwarmConfig
from repro.core import bucket as JB
from repro.core import make_graph as jmake_graph
from repro.core import sample_matching as jsample_matching
from repro.core import swarm_init as jswarm_init
from repro.core.swarm import SwarmState as JSwarmState
from repro.launch.train import presample_inputs as jpresample
from repro.optim import make_optimizer as jmake_optimizer
from repro.quant.schemes import ModularQuantConfig as JQuant
from repro_torch.algorithms import (ALGORITHMS, CAPABILITIES, make_algorithm,
                                    validate_run_config)
from repro_torch.algorithms.common import fold_batch
from repro_torch.algorithms.dpsgd import masked_metropolis, metropolis_weights
from repro_torch.algorithms.sgp import sgp_debias, sgp_init_state
from repro_torch.core import bucket as TB
from repro_torch.core.exchange import GossipTransport, transport_from_config
from repro_torch.core.graph import GRAPH_KINDS, make_graph
from repro_torch.core.swarm import SwarmConfig, SwarmState
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import NodeMesh
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import make_optimizer
from repro_torch.quant.codecs import LatticeCodec
from repro_torch.quant.schemes import ModularQuantConfig
from repro_torch.tree import tree_leaves, tree_map

N, D, HID = 8, 6, 16
STEPS, H, B = 6, 2, 4
LR = 0.05
LOCAL_H = ("swarm", "localsgd")
W0 = np.array([1.3, 0.7, 1.35, 0.65, 1.4, 0.6, 1.3, 0.7], np.float32)
Q8 = dict(safety=16.0)       # the JAX baselines' q8 tests' config


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


def _data(t, h_slots):
    r = np.random.default_rng(100 + t)
    x = r.normal(size=(N, h_slots, B, D)).astype(np.float32)
    y = (x.sum(-1, keepdims=True) > 0).astype(np.float32)
    return x, y


def _masks(steps, seed=7):
    r = np.random.default_rng(seed)
    return [r.random(N) < 0.6 for _ in range(steps)]


def _np(tree):
    return jax.device_get(tree)


def _to_port(tree):
    return None if tree is None else params_from_numpy(tree, "cpu")


@functools.lru_cache(maxsize=None)
def _jax_run(algo, *, masked=False, momentum=0.0, quantize=False,
             nonblocking=False, graph="complete", pushsum=True,
             average_momentum=False):
    """STEPS jitted JAX steps of `algo` on the tiny engine; -> dict of the
    numpy states before each step (and after the last), perms, masks, the
    q8 uniforms, batches and losses. SGP starts from the push-sum state
    with w = W0 (X = w x0, its comm copy at w = 1), or with `pushsum`
    False from the driver's start (w = 1)."""
    g = jmake_graph(graph, N)
    quant = JQuant(**Q8) if quantize else None
    opt = jmake_optimizer("sgd", lr=LR, momentum=momentum)
    h_slots = H if algo in LOCAL_H else 1
    scfg = JSwarmConfig(n_nodes=N, H=h_slots, quantize=quantize,
                        nonblocking=nonblocking, gossip_impl="gather",
                        codec=None, quant=quant or JQuant(),
                        average_momentum=average_momentum)
    kw = dict(loss_fn=_jloss, opt_update=opt.update, lr_fn=lambda s: LR,
              n_nodes=N, transport=JGossipTransport("gather", N,
                                                    quant=quant))
    if algo == "swarm":
        kw["scfg"] = scfg
    if algo == "localsgd":
        kw["H"] = H
    if algo == "dpsgd":
        kw["graph"] = g
    if algo in ("adpsgd", "sgp"):
        kw["quantize"] = quantize
    if algo == "adpsgd":
        kw["nonblocking"] = nonblocking
    step = jax.jit(jmake_algorithm(algo, **kw))
    state = jswarm_init(jax.random.PRNGKey(0), scfg, _jtiny_init, opt.init,
                        same_init=quantize)
    if algo == "sgp":
        state = jsgp_init_state(state, N, quantize)
    if algo == "sgp" and pushsum:
        w = jnp.asarray(W0)
        model = jax.tree.map(lambda x: x * w.reshape((-1, 1, 1)),
                             state.params["model"])
        state = JSwarmState({"model": model, "w": w}, state.opt, state.prev,
                            state.step)
    rng_np = np.random.default_rng(3)
    masks = _masks(STEPS) if masked else [None] * STEPS
    h = jnp.full((N,), h_slots, jnp.int32)
    n_padded = JB.build_layout(state.params).n_padded
    out = {"states": [], "perms": [], "masks": masks, "us": [],
           "batches": [], "losses": []}
    for t in range(STEPS):
        out["states"].append(_np((state.params, state.opt, state.prev)))
        perm = jsample_matching(g, rng_np)
        x, y = _data(t, h_slots)
        key = jax.random.PRNGKey(1000 + t)
        args = (state, (jnp.asarray(x), jnp.asarray(y)), jnp.asarray(perm),
                h, key)
        if masks[t] is not None:
            args += (jnp.asarray(masks[t]),)
        state, m = step(*args)
        out["perms"].append(perm)
        out["batches"].append((x, y))
        out["losses"].append(float(m["loss"]))
        out["us"].append(np.asarray(jax.random.uniform(
            key, (N, n_padded), jnp.float32)) if quantize else None)
    out["states"].append(_np((state.params, state.opt, state.prev)))
    return out


class RecordingCodec(LatticeCodec):
    """The q8 lattice codec, remembering the scales of every encode."""

    def __init__(self, fault=None):
        super().__init__(ModularQuantConfig(**Q8))
        self.scales = []
        self.fault = fault

    last_scales = None

    def encode(self, buf, prev_buf, rng, *, u=None, tile_rows: int = 8):
        q, s = super().encode(buf, prev_buf, rng, u=u, tile_rows=tile_rows)
        self.scales.append(s.reshape(-1).clone())
        RecordingCodec.last_scales = self.scales[-1]
        return q, s

    def decode_avg(self, wire, ybuf, matched_rows=None, *, tile_rows=8):
        q, s = wire
        if self.fault == "one_step_off":
            q = ((q.to(torch.int32) + 1) % 256).to(torch.uint8)
        return super().decode_avg((q, s), ybuf, matched_rows,
                                  tile_rows=tile_rows)


class WUnmixedTransport(GossipTransport):
    """A planted fault: SGP's w row group does not land (each node keeps
    its own push-sum weight)."""

    def mix_pair(self, tree, perm, matched, **kw):
        out = super().mix_pair(tree, perm, matched, **kw)
        if isinstance(tree, dict) and "w" in tree:
            out["w"] = tree["w"].clone()
        return out


def _port_step(algo, *, momentum=0.0, quantize=False, nonblocking=False,
               graph="complete", transport=None, average_momentum=False):
    opt = make_optimizer("sgd", lr=LR, momentum=momentum)
    tr = transport or GossipTransport(
        N, quant=ModularQuantConfig(**Q8) if quantize else None)
    kw = dict(loss_fn=_tloss, opt_update=opt.update, lr_fn=lambda s: LR,
              n_nodes=N, transport=tr)
    if algo == "swarm":
        kw.update(H=H, quantize=quantize, nonblocking=nonblocking,
                  average_momentum=average_momentum)
    if algo == "localsgd":
        kw["H"] = H
    if algo == "dpsgd":
        kw["graph"] = make_graph(graph, N)
    if algo in ("adpsgd", "sgp"):
        kw["quantize"] = quantize
    if algo == "adpsgd":
        kw["nonblocking"] = nonblocking
    return make_algorithm(algo, **kw)


def _port_state(np_state, t):
    params, opt, prev = (_to_port(x) for x in np_state)
    return SwarmState(params, opt if opt is not None else {}, prev, t)


def _batch(run, t):
    x, y = run["batches"][t]
    return {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}


def _call(step, state, run, t, mask=None):
    mask = run["masks"][t] if mask is None else mask
    u = run["us"][t]
    h = np.full((N,), H, np.int32)
    return step(state, _batch(run, t), run["perms"][t], h, None, mask,
                u=None if u is None else torch.from_numpy(u.copy()))


def _flat(params):
    """A parameter tree (port or JAX numpy) packed flat, in numpy."""
    if not isinstance(tree_leaves(params)[0], torch.Tensor):
        params = _to_port(params)
    return TB.pack(TB.build_layout(params), params).numpy()


EXACT_CASES = [("allreduce", {}), ("localsgd", {}),
               ("dpsgd", {"graph": "complete"}), ("dpsgd", {"graph": "ring"}),
               ("adpsgd", {}), ("adpsgd", {"nonblocking": True}),
               ("sgp", {}), ("swarm", {}), ("swarm", {"nonblocking": True}),
               ("swarm", {"average_momentum": True})]


def _case_id(case):
    algo, kw = case
    return "-".join([algo] + [str(v) if k == "graph" else k
                              for k, v in kw.items()])


@pytest.mark.parametrize("momentum", [0.0, 0.9], ids=["mom0", "mom0.9"])
@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("case", EXACT_CASES, ids=_case_id)
def test_exact_trajectory_matches_jax(case, masked, momentum):
    """Six steps from JAX's initial state: every node's parameters within
    2e-5 of JAX's after each step, losses within rtol 1e-5."""
    algo, kw = case
    run = _jax_run(algo, masked=masked, momentum=momentum, **kw)
    step = _port_step(algo, momentum=momentum, **kw)
    state = _port_state(run["states"][0], 0)
    losses = []
    for t in range(STEPS):
        state, m = _call(step, state, run, t)
        losses.append(float(m["loss"]))
        np.testing.assert_allclose(_flat(state.params),
                                   _flat(run["states"][t + 1][0]),
                                   atol=2e-5, rtol=0, err_msg=f"step {t}")
    np.testing.assert_allclose(losses, run["losses"], rtol=1e-5)


def _q8_readings(tparams, jparams, scales, partner):
    """Port vs JAX after one q8 step: max abs difference, share within
    2e-5, max difference in units of its row's lattice step (the step of
    the payload the node decoded, its partner's), and the count of
    coordinates beyond one step + 2e-5."""
    d = np.abs(_flat(tparams) - _flat(jparams)).reshape(N, -1, 256)
    s = scales.numpy().reshape(N, -1, 1)[np.asarray(partner)]
    return {"max_abs": float(d.max()),
            "share_within_2e-5": float((d <= 2e-5).mean()),
            "max_in_steps": float((d / s).max()),
            "beyond_one_step": int((d > s + 2e-5).sum())}


def _q8_ok(r):
    return r["beyond_one_step"] == 0 and r["share_within_2e-5"] >= 0.999


def _partner(algo, run, t):
    if algo == "sgp":
        shift = 2 ** (t % int(np.log2(N)))
        return (np.arange(N) - shift) % N
    return run["perms"][t]


def _q8_step(algo, nonblocking, masked, t, fault=None, pushsum=False):
    run = _jax_run(algo, masked=masked, momentum=0.9, quantize=True,
                   nonblocking=nonblocking, pushsum=pushsum)
    codec = RecordingCodec("one_step_off" if fault == "one_step_off"
                           else None)
    cls = WUnmixedTransport if fault == "w_unmixed" else GossipTransport
    step = _port_step(algo, momentum=0.9, quantize=True,
                      nonblocking=nonblocking, transport=cls(N, codec=codec))
    state, m = _call(step, _port_state(run["states"][t], t), run, t)
    r = _q8_readings(state.params, run["states"][t + 1][0],
                     codec.scales[-1], _partner(algo, run, t))
    return run, state, m, r


Q8_CASES = [("adpsgd", False), ("adpsgd", True), ("sgp", False)]


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("algo,nonblocking", Q8_CASES,
                         ids=["adpsgd", "adpsgd-nonblocking", "sgp"])
def test_q8_matches_jax(algo, nonblocking, masked):
    """Each q8 step restarted from JAX's state before it (params,
    momentum, comm copy) with JAX's uniforms, held to the slice's bound;
    the comm copy refreshed as JAX's."""
    for t in range(STEPS):
        run, state, m, r = _q8_step(algo, nonblocking, masked, t)
        np.testing.assert_allclose(float(m["loss"]), run["losses"][t],
                                   rtol=1e-5)
        assert _q8_ok(r), (t, r)
        # the comm copy refreshed as JAX's (to the post-exchange payload
        # when blocking, to the value sent when not)
        rp = _q8_readings(state.prev, run["states"][t + 1][2],
                          RecordingCodec.last_scales, _partner(algo, run, t))
        assert _q8_ok(rp), (t, rp)


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_q8_sgp_pushsum_step_matches_jax(masked):
    """One q8 SGP step from the push-sum state (w not all 1, the comm copy
    at w = 1, so the w rows carry a live distance proxy): within the
    slice's bound of JAX, and w really mixed."""
    run, state, m, r = _q8_step("sgp", False, masked, 0, pushsum=True)
    np.testing.assert_allclose(float(m["loss"]), run["losses"][0],
                               rtol=1e-5)
    assert _q8_ok(r), r
    w = state.params["w"].numpy()
    assert not np.allclose(w, W0, atol=1e-3), w
    np.testing.assert_allclose(w, run["states"][1][0]["w"], atol=2e-5)


@pytest.mark.parametrize("algo,nonblocking,fault", [
    ("sgp", False, "w_unmixed"), ("sgp", False, "one_step_off"),
    ("adpsgd", False, "one_step_off"), ("adpsgd", True, "one_step_off")],
    ids=["sgp-w_unmixed", "sgp-one_step_off", "adpsgd-one_step_off",
         "adpsgd-nonblocking-one_step_off"])
def test_q8_bound_rejects_a_planted_fault(algo, nonblocking, fault):
    """SGP at step 0 from the push-sum state (its w rows carry a live
    distance proxy there); AD-PSGD at step 1 (the nodes start from one
    model, so step 0's exchange moves little)."""
    t = 0 if algo == "sgp" else 1
    _, _, _, r = _q8_step(algo, nonblocking, False, t, fault,
                          pushsum=algo == "sgp")
    assert not _q8_ok(r), r


def test_sgp_w_row_group_rides_after_the_model():
    """The payload packs w as one 256-wide row group after the model (dict
    keys in sorted order), so it rides the q8 codec with the model."""
    X = {"w1": torch.zeros(N, D, HID), "w2": torch.zeros(N, HID, 1)}
    payload = {"model": X, "w": torch.arange(N, dtype=torch.float32)}
    lay, mlay = TB.build_layout(payload), TB.build_layout(X)
    assert lay.offsets[-1] == sum(mlay.seg_sizes)
    assert lay.seg_sizes[-1] == 256
    buf = TB.pack(lay, payload)
    np.testing.assert_array_equal(buf[:, lay.offsets[-1]].numpy(),
                                  np.arange(N))


@pytest.mark.parametrize("algo", sorted(ALGORITHMS))
def test_all_true_mask_equals_no_mask(algo):
    """An all-True participation mask gives the unmasked trajectory:
    bitwise for the pairwise exchanges and the gated gradient steps; the
    global mean (sum over the node axis / count, against torch.mean) and
    D-PSGD's masked Metropolis matrix (its diagonal summed in fp32,
    against W's in fp64) may differ by an ulp."""
    run = _jax_run(algo, momentum=0.9)
    step = _port_step(algo, momentum=0.9)
    a = b = _port_state(run["states"][0], 0)
    for t in range(STEPS):
        a, ma = _call(step, a, run, t)
        b, mb = _call(step, b, run, t, mask=np.ones(N, bool))
    if algo in ("swarm", "adpsgd", "sgp"):
        np.testing.assert_array_equal(_flat(a.params), _flat(b.params))
        assert float(ma["loss"]) == float(mb["loss"])
    else:
        np.testing.assert_allclose(_flat(a.params), _flat(b.params),
                                   atol=1e-6, rtol=0)


def _port_run(algo, steps=6, same_init=True, masked=False):
    run = _jax_run(algo, momentum=0.9, masked=masked)
    step = _port_step(algo, momentum=0.9)
    state = _port_state(run["states"][0], 0)
    if same_init and algo != "sgp":
        state = SwarmState(tree_map(lambda x: x[:1].repeat(
            (N,) + (1,) * (x.ndim - 1)), state.params), state.opt,
            state.prev, 0)
    hist = []
    for t in range(steps):
        state, m = _call(step, state, run, t)
        hist.append(m)
    return state, hist


def test_allreduce_keeps_nodes_identical():
    state, hist = _port_run("allreduce", masked=True)
    for x in tree_leaves(state.params):
        assert all(torch.equal(x[0], x[i]) for i in range(1, N))
    assert all(float(m["gamma"]) < 1e-10 for m in hist)


def test_localsgd_resyncs_every_superstep():
    state, _ = _port_run("localsgd", same_init=False)
    for x in tree_leaves(state.params):
        assert all(torch.equal(x[0], x[i]) for i in range(1, N))
    # the momenta stay each node's own
    m = tree_leaves(state.opt)[0]
    assert not torch.equal(m[0], m[1])


def test_metropolis_weights_doubly_stochastic():
    for g in (make_graph("random_regular", 16, r=4), make_graph("ring", 8),
              make_graph("torus", 12)):
        W = metropolis_weights(g)
        np.testing.assert_allclose(W.sum(0), 1.0, atol=1e-9)
        np.testing.assert_allclose(W.sum(1), 1.0, atol=1e-9)
        np.testing.assert_allclose(W, W.T)
        assert (W >= 0).all()


def test_masked_metropolis_doubly_stochastic_and_matches_jax():
    from repro.algorithms.dpsgd import masked_metropolis as jmm
    for kind in ("complete", "ring", "hypercube"):
        W = torch.from_numpy(metropolis_weights(make_graph(kind, N))
                             .astype(np.float32))
        r = np.random.default_rng(0)
        for _ in range(6):
            mask = r.random(N) < 0.5
            We = masked_metropolis(W, torch.from_numpy(mask))
            Wd = We.double().numpy()
            np.testing.assert_allclose(Wd.sum(0), 1.0, atol=1e-6)
            np.testing.assert_allclose(Wd.sum(1), 1.0, atol=1e-6)
            np.testing.assert_allclose(Wd, Wd.T, atol=1e-7)
            for i in np.nonzero(~mask)[0]:
                np.testing.assert_allclose(Wd[i], np.eye(N)[i], atol=1e-7)
            np.testing.assert_allclose(
                We.numpy(), np.asarray(jmm(jnp.asarray(W.numpy()),
                                           jnp.asarray(mask))),
                atol=1e-7, rtol=0)


def test_sgp_weights_stay_normalized():
    """Push-sum: with every node active the mean of w stays 1 (the shift
    is a permutation), and X / w is what the metrics read. (After log2 n
    steps the one-peer exponential graph has averaged w exactly, so this
    reads step 2.)"""
    state, hist = _port_run("sgp", steps=2)
    w = state.params["w"]
    np.testing.assert_allclose(float(w.mean()), 1.0, atol=1e-6)
    assert (w > 0).all()
    assert not np.allclose(w.numpy(), 1.0)       # w really mixes
    deb = sgp_debias(state.params)
    np.testing.assert_allclose(
        deb["w1"].numpy(),
        (state.params["model"]["w1"] / w[:, None, None]).numpy(), rtol=1e-6)


def test_sgp_init_state_wraps_the_payload():
    params = {"a": torch.randn(4, 3), "b": torch.randn(4, 2, 2)}
    st = sgp_init_state(SwarmState(params, {}, None, 0), 4, quantize=True)
    assert set(st.params) == {"model", "w"} and set(st.prev) == {"model",
                                                                 "w"}
    assert torch.equal(st.params["w"], torch.ones(4))
    assert st.prev["w"].data_ptr() != st.params["w"].data_ptr()
    assert sgp_init_state(SwarmState(params, {}, None, 0), 4).prev is None


def test_flat_mean_and_matrix_match_jax():
    r = np.random.default_rng(4)
    buf = r.normal(size=(N, 2048)).astype(np.float32)
    mask = r.random(N) < 0.5
    W = metropolis_weights(make_graph("ring", N)).astype(np.float32)
    for m in (None, mask):
        got = TB.gossip_flat_mean(torch.from_numpy(buf),
                                  None if m is None else torch.from_numpy(m))
        want = JB.gossip_flat_mean(jnp.asarray(buf),
                                   None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=0)
    np.testing.assert_allclose(
        TB.gossip_flat_matrix(torch.from_numpy(W), torch.from_numpy(buf))
        .numpy(), np.asarray(JB.gossip_flat_matrix(jnp.asarray(W),
                                                   jnp.asarray(buf))),
        atol=1e-6, rtol=0)
    # no participant: the mean is 0, not a division by zero
    assert torch.equal(TB.gossip_flat_mean(torch.ones(3, 8),
                                           torch.zeros(3, dtype=torch.bool)),
                       torch.zeros(3, 8))


def test_transport_payload_bytes_and_impls():
    tr = GossipTransport(N)
    tree = {"w1": torch.zeros(N, D, HID), "w2": torch.zeros(N, HID, 1)}
    jtr = JGossipTransport("gather", N)
    jtree = {"w1": jnp.zeros((N, D, HID)), "w2": jnp.zeros((N, HID, 1))}
    for q in (False, True):
        assert tr.payload_num_bytes(tree, q) == jtr.payload_num_bytes(jtree,
                                                                      q)
    assert tr.impl == tr.base_impl == "gather"
    # every impl of the reference builds from the config on one shard
    # (payload bytes as the gather's); on a node mesh every impl builds
    # too, and a rank holds one node
    g = make_graph("complete", N)
    mesh = NodeMesh(0, 2, torch.device("cpu"))
    for impl in ("ppermute", "ppermute_pool", "gather_legacy",
                 "ppermute_legacy", "ppermute_pool_legacy"):
        t = transport_from_config(SwarmConfig(n_nodes=N, gossip_impl=impl),
                                  g, 0)
        assert (t.impl, t.legacy) == (impl, impl.endswith("_legacy"))
        for q in (False, True):
            assert t.payload_num_bytes(tree, q) == tr.payload_num_bytes(tree,
                                                                        q)
        with pytest.raises(ValueError, match="ROADMAP.md Queue A 6"):
            GossipTransport(N, impl=impl, mesh=mesh)
        if impl.startswith("gather"):
            t = GossipTransport(2, impl=impl, mesh=mesh)
            assert (t.mesh, t.impl) == (mesh, impl)
            with pytest.raises(ValueError, match="ROADMAP.md Queue A 6"):
                validate_run_config("swarm", gossip_impl=impl, n_nodes=N,
                                    mesh=mesh)
    q4 = ModularQuantConfig(bits=4)
    assert transport_from_config(SwarmConfig(n_nodes=N, quant=q4)) \
        .codec.name == "q4"


# ---------------------------------------------------------------------------
# Graphs
# ---------------------------------------------------------------------------


def _graph_or_error(make, kind, n, **kw):
    try:
        g = make(kind, n, **kw)
    except Exception as e:           # noqa: BLE001 — compared by kind only
        return type(e)
    return g


@pytest.mark.parametrize("kind", GRAPH_KINDS)
def test_graphs_match_jax(kind):
    """Same edge set, degree and lambda2 (1e-9) as JAX for every kind and
    size, and an error wherever JAX raises."""
    if kind == "random_regular":
        pytest.importorskip("networkx")
    for n in (1, 2, 3, 4, 6, 8, 12, 16, 32):
        g = _graph_or_error(make_graph, kind, n)
        jg = _graph_or_error(jmake_graph, kind, n)
        if isinstance(jg, type):
            assert isinstance(g, type), (kind, n, g)
            continue
        assert not isinstance(g, type), (kind, n, g)
        assert g.name == jg.name and g.n == jg.n and g.r == jg.r
        np.testing.assert_array_equal(g.edges, jg.edges)
        assert abs(g.lambda2 - jg.lambda2) <= 1e-9
        assert g.is_regular == jg.is_regular


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_regular_matches_networkx(seed):
    pytest.importorskip("networkx")
    for n, r in ((16, 4), (8, 3), (10, 3), (12, 5)):
        g = make_graph("random_regular", n, r=r, seed=seed)
        jg = jmake_graph("random_regular", n, r=r, seed=seed)
        np.testing.assert_array_equal(g.edges, jg.edges)
        assert g.r == jg.r == r
        assert abs(g.lambda2 - jg.lambda2) <= 1e-9
    for n, r in ((5, 3), (4, 4)):            # odd n*r, r >= n
        with pytest.raises(ValueError):
            make_graph("random_regular", n, r=r)


def test_irregular_graph_carries_degrees():
    from repro.core.graph import irregular_graph as jirr
    from repro_torch.core.graph import irregular_graph
    es = [(0, 1), (1, 2), (2, 0), (2, 3)]
    g, jg = irregular_graph("x", 4, es), jirr("x", 4, es)
    assert not g.is_regular
    np.testing.assert_array_equal(g.degrees, jg.degrees)
    assert abs(g.lambda2 - jg.lambda2) <= 1e-9
    from repro_torch.core.graph import _finalize
    with pytest.raises(ValueError, match="not regular"):
        _finalize("x", 4, es)
    with pytest.raises(ValueError, match="isolated"):
        irregular_graph("y", 4, [(0, 1), (1, 2)])


# ---------------------------------------------------------------------------
# The capability matrix
# ---------------------------------------------------------------------------


def test_capability_matrix_is_the_reference():
    assert set(CAPABILITIES) == set(JCAPS) == set(ALGORITHMS)
    for algo, caps in CAPABILITIES.items():
        j = JCAPS[algo]
        for f in ("transports", "modes", "quantized", "codecs", "sched",
                  "uses_matching", "local_H", "pricing", "why", "churn",
                  "hier"):
            assert getattr(caps, f) == getattr(j, f), (algo, f)


def _accepts(fn, algo, **kw):
    try:
        fn(algo, **kw)
    except (ValueError, NotImplementedError):
        return False
    return True


GRID_IMPLS = ("gather", "ppermute", "ppermute_pool", "gather_legacy")
GRID_CODECS = (None, "q8", "q4", "q16", "q2", "bf16", "topk:0.25", "q17")
MODES = {"blocking": {}, "nonblocking": {"nonblocking": True},
         "overlap": {"overlap": True}}


@pytest.mark.parametrize("algo", sorted(JCAPS))
def test_validate_accepts_the_reference_set_minus_unported(algo,
                                                          monkeypatch):
    """Over algo x impl x mode x quantize x codec the port accepts exactly
    what JAX accepts: every transport and every codec is ported (a
    multi-shard mesh, which the reference's driver never builds, is
    refused by the transport itself)."""
    for var in ("REPRO_DEFAULT_GOSSIP_IMPL", "REPRO_CODEC", "REPRO_TOPOLOGY",
                "REPRO_AVAIL_PROFILE"):
        monkeypatch.delenv(var, raising=False)
    n_accept = 0
    for impl in GRID_IMPLS:
        for mode, mkw in MODES.items():
            for quantize in (False, True):
                for codec in GRID_CODECS:
                    kw = dict(gossip_impl=impl, quantize=quantize,
                              codec=codec, **mkw)
                    j = _accepts(jvalidate, algo, **kw)
                    assert _accepts(validate_run_config, algo, **kw) == j, \
                        (algo, kw, j)
                    n_accept += j
    assert n_accept > 0


@pytest.mark.parametrize("kw,item", [
    (dict(gossip_impl="ppermute_pool"), "NCCL"),
    (dict(rate_profile="lognormal", gossip_impl="ppermute_pool"), "NCCL"),
    (dict(topology="hier:4", rate_profile="lognormal",
          gossip_impl="ppermute_pool"), "NCCL")],
    ids=["kw0-NCCL", "kw3-NCCL", "kw5-NCCL"])
def test_validate_names_the_roadmap_item(kw, item, monkeypatch):
    """The pool transport, which the port refused until it was ported, is
    accepted where JAX accepts it (also under the scheduler's flags) with
    the same capability row; the chunk driver on a node mesh (NCCL inside
    CUDA graphs) is accepted now and its ROADMAP item is marked done;
    what the port still does not carry on a node mesh — more than one
    node a shard — is refused with the ROADMAP item it waits for."""
    for var in ("REPRO_DEFAULT_GOSSIP_IMPL", "REPRO_CODEC", "REPRO_TOPOLOGY",
                "REPRO_AVAIL_PROFILE"):
        monkeypatch.delenv(var, raising=False)
    want = jvalidate("swarm", n_nodes=8, **kw)
    got = validate_run_config("swarm", n_nodes=8, **kw)
    assert (got.transports, got.modes) == (want.transports, want.modes)
    pool = [np.arange(8)]
    assert validate_run_config("swarm", n_nodes=8, scan_chunk=4,
                               mesh=NodeMesh(0, 8, torch.device("cpu")),
                               **kw) is not None
    roadmap = (Path(__file__).resolve().parents[1] / "ROADMAP.md").read_text()
    queue_a = roadmap[roadmap.index("### Queue A"):roadmap.index(
        "### Queue B")]
    heads = [m.group(1) for m in re.finditer(r"^\d+\. \*\*(.*?)\*\*",
                                             queue_a, re.S | re.M)
             if item in m.group(1)]
    assert heads and all("done in PR" in h for h in heads), heads
    with pytest.raises(ValueError, match="ROADMAP.md Queue A 6"):
        GossipTransport(8, impl=kw["gossip_impl"], matching_pool=pool,
                        mesh=NodeMesh(0, 2, torch.device("cpu")))


@pytest.mark.parametrize("kw", [
    dict(quantize=True, codec="bf16"),
    dict(quantize=True, codec="topk:0.25"),
    dict(rate_profile="uniform", quantize=True, codec="bf16"),
    dict(quantize=True, compress_state=True),
    dict(avail="day_night:period=4,duty=0.5", rate_profile="lognormal",
         quantize=True, codec="topk:0.25")],
    ids=["bf16", "topk", "uniform-bf16", "compress-state", "avail-topk"])
def test_validate_accepts_the_ported_codecs(kw, monkeypatch):
    """The bf16 and top-k codecs and --compress-state, which the port
    refused until they were ported, are accepted where JAX accepts them
    (also under the scheduler's flags), with the same capability row."""
    for var in ("REPRO_DEFAULT_GOSSIP_IMPL", "REPRO_CODEC", "REPRO_TOPOLOGY",
                "REPRO_AVAIL_PROFILE"):
        monkeypatch.delenv(var, raising=False)
    want = jvalidate("swarm", n_nodes=8, **kw)
    got = validate_run_config("swarm", n_nodes=8, **kw)
    assert (got.codecs, got.modes) == (want.codecs, want.modes)


def test_validate_rejects_like_the_reference():
    for algo, kw in (("sgp", dict(gossip_impl="ppermute")),
                     ("localsgd", dict(quantize=True)),
                     ("dpsgd", dict(gossip_impl="ppermute_pool")),
                     ("allreduce", dict(nonblocking=True)),
                     ("adpsgd", dict(overlap=True)),
                     ("sgp", dict(quantize=True, codec="topk:0.5")),
                     ("adpsgd", dict(compress_state=True, quantize=True))):
        with pytest.raises(ValueError, match=f"--algo {algo} does not"):
            validate_run_config(algo, **kw)
    with pytest.raises(ValueError, match="unknown algorithm"):
        validate_run_config("sgd-3000")
    with pytest.raises(ValueError, match="unknown algorithm"):
        make_algorithm("sgd-3000")


def test_make_algorithm_routes_swarm():
    """make_algorithm('swarm') builds the swarm superstep from a config or
    from its fields, not both."""
    from repro_torch.core.swarm import make_swarm_step
    opt = make_optimizer("sgd", lr=LR, momentum=0.9)
    run = _jax_run("swarm", momentum=0.9)
    scfg = SwarmConfig(n_nodes=N, H=H)
    a = make_algorithm("swarm", loss_fn=_tloss, opt_update=opt.update,
                       lr_fn=lambda s: LR, n_nodes=N, scfg=scfg)
    b = make_swarm_step(scfg, _tloss, opt.update, lambda s: LR)
    sa = sb = _port_state(run["states"][0], 0)
    for t in range(3):
        sa, _ = _call(a, sa, run, t)
        sb, _ = _call(b, sb, run, t)
    np.testing.assert_array_equal(_flat(sa.params), _flat(sb.params))
    with pytest.raises(TypeError):
        make_algorithm("swarm", loss_fn=_tloss, opt_update=opt.update,
                       lr_fn=lambda s: LR, n_nodes=N, scfg=scfg,
                       nonblocking=True)
    s = make_algorithm("swarm", loss_fn=_tloss, opt_update=opt.update,
                       lr_fn=lambda s: LR, n_nodes=N, H=3,
                       track_potential=False)
    _, m = _call(s, _port_state(run["states"][0], 0), run, 0)
    assert "gamma" not in m


def test_fold_batch():
    x = torch.arange(2 * 3 * 4 * 5).reshape(2, 3, 4, 5)
    out = fold_batch({"tokens": x})["tokens"]
    assert out.shape == (2, 12, 5)
    assert torch.equal(out[1, 4], x[1, 1, 0])


# ---------------------------------------------------------------------------
# The drivers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("kind", GRAPH_KINDS)
def test_presampled_streams_equal_jax_driver(kind, n):
    """Every algorithm's (perm, h) stream is bitwise the JAX driver's; an
    algorithm that ignores the matching still draws it (Local SGD's
    geometric h stream would shift otherwise)."""
    if kind == "random_regular":
        pytest.importorskip("networkx")
    g, jg = make_graph(kind, n), jmake_graph(kind, n)
    for algo, caps in CAPABILITIES.items():
        H_, h_mode = (2, "geometric") if caps.local_H else (1, "fixed")
        jscfg = JSwarmConfig(n_nodes=n, H=H_, h_mode=h_mode, h_max=8,
                             gossip_impl="gather", codec=None)
        scfg = SwarmConfig(n_nodes=n, H=H_, h_mode=h_mode, h_max=8)
        jp, jh = jpresample(jscfg, jg, np.random.default_rng(5), 5, 7,
                            caps.uses_matching)
        tp, th = ttrain.presample_inputs(scfg, g, np.random.default_rng(5),
                                         7, caps.uses_matching)
        np.testing.assert_array_equal(tp, jp, err_msg=algo)
        np.testing.assert_array_equal(th, jh, err_msg=algo)
        if caps.local_H:
            assert len(set(th.ravel())) > 1


DRIVER = ["--arch", "transformer-wmt", "--reduced", "--layers", "1",
          "--d-model", "32", "--nodes", "4", "--steps", "3", "--seq", "16",
          "--log-every", "1"]
DRIVER_CASES = {
    "allreduce": ["--algo", "allreduce"],
    "localsgd": ["--algo", "localsgd", "--H", "2"],
    "dpsgd-ring": ["--algo", "dpsgd", "--graph", "ring"],
    "adpsgd-nonblocking": ["--algo", "adpsgd", "--nonblocking"],
    "sgp-eval-mean": ["--algo", "sgp", "--eval-mean"],
    "swarm-hypercube": ["--algo", "swarm", "--graph", "hypercube"],
    "adpsgd-q8-nonblocking": ["--algo", "adpsgd", "--quantize",
                              "--nonblocking"],
    "sgp-q8-eval-mean": ["--algo", "sgp", "--quantize", "--eval-mean"],
}


@pytest.mark.parametrize("case", list(DRIVER_CASES))
def test_drivers_agree(case, capsys, monkeypatch):
    """Both drivers with the same flags: the same record keys; in exact
    mode, from the JAX driver's initial weights, losses within rtol 1e-5
    (q8 draws its uniforms from each package's own generator)."""
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.launch.train import build_trainer, main as jmain
    for var in ("REPRO_AVAIL_PROFILE", "REPRO_RATE_PROFILE", "REPRO_CODEC",
                "REPRO_SCAN_CHUNK", "REPRO_TOPOLOGY",
                "REPRO_DEFAULT_GOSSIP_IMPL"):
        monkeypatch.delenv(var, raising=False)
    flags = DRIVER + DRIVER_CASES[case]
    monkeypatch.setattr(sys, "argv", ["train"] + flags)
    jmain()
    jrecs = [r for r in map(__import__("json").loads,
                            [ln for ln in capsys.readouterr().out
                             .splitlines() if ln.startswith("{")])]
    args = ttrain.build_parser().parse_args(flags + ["--device", "cpu"])
    tr = ttrain.build(args)
    quantize = "--quantize" in flags
    if not quantize:
        jcfg = jreduced(jget_config("transformer-wmt"), n_layers=1,
                        d_model=32)
        _, jstate, _, _ = build_trainer(
            jcfg, args.algo, 4, args.H, args.lr, False, args.nonblocking,
            args.graph, 0)
        st = jax.device_get(jstate)
        tr.state = SwarmState(_to_port(st.params), _to_port(st.opt),
                              _to_port(st.prev), 0)
    trecs = ttrain.run(args, tr)
    assert [set(r) for r in trecs] == [set(r) for r in jrecs]
    assert [r["step"] for r in trecs] == [0, 1, 2]
    for r in trecs:
        assert all(np.isfinite(v) for v in r.values())
    if not quantize:
        np.testing.assert_allclose([r["loss"] for r in trecs],
                                   [r["loss"] for r in jrecs], rtol=1e-5)
        if args.algo == "sgp":
            np.testing.assert_allclose(
                [r["loss_mean_model"] for r in trecs],
                [r["loss_mean_model"] for r in jrecs], rtol=1e-5)


def test_driver_checkpoint_metadata_names_the_algo(tmp_path):
    from repro_torch.checkpoint import load_metadata
    ttrain.main(DRIVER + ["--algo", "sgp", "--quantize", "--device", "cpu",
                          "--steps", "1", "--ckpt", str(tmp_path / "ck")])
    meta = load_metadata(str(tmp_path / "ck"))
    assert meta["algo"] == "sgp" and meta["codec"]["state"] == ["params",
                                                               "prev"]


def test_driver_refuses_unported_flags():
    """Unknown choices do not parse; --compress-state, --codec,
    --scan-chunk, --gossip-impl and --pool-size are ported and do."""
    for argv in (["--gossip-impl", "allgather"],
                 ["--rate-profile", "explicit"],
                 ["--graph", "petersen"], ["--algo", "sgd"]):
        with pytest.raises(SystemExit) as e:
            ttrain.build_parser().parse_args(argv)
        assert e.value.code == 2
    args = ttrain.build_parser().parse_args(
        ["--compress-state", "--codec", "bf16", "--scan-chunk", "2",
         "--gossip-impl", "ppermute_pool", "--pool-size", "4"])
    assert (args.compress_state, args.codec, args.scan_chunk,
            args.gossip_impl, args.pool_size) == \
        (True, "bf16", 2, "ppermute_pool", 4)
    for argv in (["--algo", "localsgd", "--quantize"],
                 ["--algo", "sgp", "--nonblocking"],
                 ["--algo", "adpsgd", "--overlap"]):
        with pytest.raises(ValueError, match="does not support"):
            ttrain.build(ttrain.build_parser().parse_args(
                DRIVER + argv + ["--device", "cpu"]))


def test_driver_sgp_state_and_eval_read_the_debiased_model():
    tr = ttrain.build(ttrain.build_parser().parse_args(
        DRIVER + ["--algo", "sgp", "--quantize", "--eval-mean", "--device",
                  "cpu"]))
    assert set(tr.state.params) == {"model", "w"}
    assert set(tr.state.prev) == {"model", "w"}
    assert tr.h_max == 1 and tr.scfg.H == 1
    nb = tr.node_batches(0)
    tr.superstep(0, nb)
    ev = tr.eval_mean(nb)
    assert np.isfinite(list(ev.values())).all()
    np.testing.assert_allclose(float(tr.state.params["w"].sum()), 4.0,
                               atol=1e-5)

