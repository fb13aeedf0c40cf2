"""The port's whole slice against the JAX package, on the CPU: three
blocking supersteps of a reduced transformer-wmt swarm from carried-over
weights, identical batches and matchings, and JAX's own uniforms ``u``
injected into the port's q8 encode.

* Exact gossip: parameters within atol 2e-5 after each superstep (jitted
  XLA vs eager torch differ by a few ulp per step; three supersteps of
  SGD carry that).
* q8 gossip: every superstep restarts from JAX's state before it, and
  after each every coordinate is within one lattice step (the scale of
  its row in the payload the node decoded, its partner's) and at least
  99.9% within 2e-5. A code flips where x/s + u lies within an ulp of an
  integer, which moves that coordinate by about s/2.
  Two planted decode faults (every code one step off; the average
  dropped) must fail that bound.

The same q8 harness holds the non-blocking superstep (Algorithm 2) and the
overlapped pipeline, each restarted from JAX's state before every
superstep (the in-flight payload included); the overlapped step's decode
reads the wire JAX encoded, so its rows' steps are that wire's scales.
The port's pipeline prologue reproduces JAX's first payload bitwise. All
three modes are also held to it with heterogeneous local steps: per-node
h_i from JAX's geometric sampler, batch depth h_max.

The same harness holds the engine under participation masks (a matched
pair lands only where both ends take part), and an all-True mask leaves
every mode bitwise unmasked.

Also: the driver's matchings, geometric local-step counts and non-iid
batches equal the JAX driver's for the same seed, the CLI runs on the CPU
and refuses to run without a card unless asked, and no module of the port
(nor chip_smoke.py) imports jax or the JAX package.
"""
import ast
import functools
import gc
import json
import os
import subprocess
import sys
import weakref
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, reduced as jreduced
from repro.core import bucket as JB
from repro.core.graph import complete as jcomplete
from repro.core.graph import sample_matching as jsample_matching
from repro.core.potential import gamma_potential as jgamma
from repro.core.swarm import SwarmConfig as JSwarmConfig
from repro.core.swarm import make_swarm_step as jmake_swarm_step
from repro.core.swarm import sample_h_counts as jsample_h_counts
from repro.core.swarm import swarm_init as jswarm_init
from repro.data import DataConfig, SyntheticLMDataset, make_node_batches
from repro.data import SyntheticLMDataset as JSyntheticLMDataset
from repro.data import make_node_batches as jmake_node_batches
from repro.launch.train import presample_inputs as jpresample
from repro.models import init_params as jinit_params
from repro.models import loss_fn as jloss_fn
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch.configs import get_config, reduced
from repro_torch.core import bucket as TB
from repro_torch.data import DataConfig as TDataConfig
from repro_torch.data import SyntheticLMDataset as TSyntheticLMDataset
from repro_torch.data import make_node_batches as tmake_node_batches
from repro_torch.core.exchange import GossipTransport
from repro_torch.core.graph import complete, sample_matching
from repro_torch.core.potential import gamma_potential
from repro_torch.core.swarm import SwarmConfig, SwarmState, make_swarm_step
from repro_torch.core.swarm import pipeline_prologue
from repro_torch.launch import train as ttrain
from repro_torch.models import TransformerLM
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import make_optimizer
from repro_torch.quant.codecs import LatticeCodec
from repro_torch.quant.schemes import ModularQuantConfig
from repro_torch.tree import tree_map

ROOT = Path(__file__).resolve().parents[1]
N, H, STEPS, SEQ, BATCH, LR = 4, 2, 3, 16, 2, 0.05
H_MAX = 4            # loop bound and batch depth of the geometric h mode


class RecordingCodec(LatticeCodec):
    """The q8 lattice codec, remembering the scales of every encode."""

    def __init__(self):
        super().__init__(ModularQuantConfig())
        self.scales = []

    def encode(self, buf, prev_buf, rng, *, u=None, tile_rows: int = 8):
        q, s = super().encode(buf, prev_buf, rng, u=u, tile_rows=tile_rows)
        self.scales.append(s.reshape(-1).clone())
        return q, s


class OneStepOffCodec(RecordingCodec):
    """A planted fault: every received code one lattice step up."""

    def decode_avg(self, wire, ybuf, matched_rows=None, *, tile_rows=8):
        q, s = wire
        q = ((q.to(torch.int32) + 1) % 256).to(torch.uint8)
        return super().decode_avg((q, s), ybuf, matched_rows,
                                  tile_rows=tile_rows)


class AverageDroppedCodec(RecordingCodec):
    """A planted fault: the receiver takes the decoded partner model."""

    def decode_avg(self, wire, ybuf, matched_rows=None, *, tile_rows=8):
        return self.decode(wire, ybuf, tile_rows=tile_rows)


MODES = {"blocking": (False, False), "nonblocking": (True, False),
         "overlap": (True, True)}


def _np_state(jstate):
    """(params, opt, prev, inflight) of a JAX state, in numpy."""
    return jax.device_get((jstate.params, jstate.opt, jstate.prev,
                           jstate.inflight))


def _masks(masked: bool):
    """The participation masks of a masked run (None per step if not)."""
    if not masked:
        return [None] * STEPS
    r = np.random.default_rng(7)
    return [r.random(N) < 0.6 for _ in range(STEPS)]


@functools.lru_cache(maxsize=None)
def _jax_run(quantize: bool, mode: str = "blocking", h_mode: str = "fixed",
             masked: bool = False):
    """STEPS JAX supersteps (under `_masks(masked)`); -> (states, batches,
    perms, us, losses, hs),
    with states[t] = (params, opt, prev, inflight) in numpy before
    superstep t (states[0]'s payload is the prologue's, whose uniforms are
    us[-1]). Geometric h counts are drawn as the JAX driver draws them
    (perm, then h, step by step), at the batch depth H_MAX."""
    nonblocking, overlap = MODES[mode]
    jcfg = jreduced(jget_config("transformer-wmt"), n_layers=1, d_model=32)
    jscfg = JSwarmConfig(n_nodes=N, H=H, quantize=quantize, codec=None,
                         gossip_impl="gather", nonblocking=nonblocking,
                         overlap=overlap, h_mode=h_mode, h_max=H_MAX)
    depth = jscfg.h_loop_bound
    jopt = jmake_optimizer("sgd", lr=LR, momentum=0.9)
    jstep = jax.jit(jmake_swarm_step(jscfg, lambda p, mb: jloss_fn(jcfg, p, mb),
                                     jopt.update, lambda s: LR))
    jstate = jswarm_init(jax.random.PRNGKey(0), jscfg,
                         lambda k: jinit_params(k, jcfg), jopt.init)
    ds = SyntheticLMDataset(DataConfig(vocab_size=jcfg.vocab_size,
                                       seq_len=SEQ, seed=0), N)
    graph = jcomplete(N)
    rng_np = np.random.default_rng(0)
    key = jax.random.PRNGKey(1)
    n_padded = JB.build_layout(jstate.params).n_padded
    states, batches, perms, us, losses, hs = [], [], [], [], [], []
    for t in range(STEPS):
        states.append(_np_state(jstate))
        nb = make_node_batches(ds, t, BATCH * depth)
        batch = {k: v.reshape(N, depth, BATCH, SEQ) for k, v in nb.items()}
        perm = jsample_matching(graph, rng_np)
        h = jsample_h_counts(jscfg, rng_np)
        key, sub = jax.random.split(key)
        mask = _masks(masked)[t]
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch),
                           jnp.asarray(perm), jnp.asarray(h), sub,
                           *(() if mask is None else (jnp.asarray(mask),)))
        us.append(np.asarray(jax.random.uniform(sub, (N, n_padded),
                                                jnp.float32)))
        batches.append(batch)
        perms.append(perm)
        hs.append(h)
        losses.append(float(jm["loss"]))
    states.append(_np_state(jstate))
    us.append(np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.PRNGKey(0), 0x1F), (N, n_padded),
        jnp.float32)))
    return states, batches, perms, us, losses, hs


def _inflight_from_numpy(infl):
    if infl is None:
        return None
    out = {k: torch.from_numpy(np.array(v)) for k, v in infl.items()
           if k != "wire"}
    if "wire" in infl:
        out["wire"] = tuple(torch.from_numpy(np.array(w))
                            for w in infl["wire"])
    return out


def _port(quantize: bool, codec=None, mode: str = "blocking",
          h_mode: str = "fixed"):
    """The port's superstep and a state maker from a JAX numpy state."""
    nonblocking, overlap = MODES[mode]
    tcfg = reduced(get_config("transformer-wmt"), n_layers=1, d_model=32)
    topt = make_optimizer("sgd", lr=LR, momentum=0.9)
    step = make_swarm_step(SwarmConfig(n_nodes=N, H=H, quantize=quantize,
                                       nonblocking=nonblocking,
                                       overlap=overlap, h_mode=h_mode,
                                       h_max=H_MAX),
                           TransformerLM(tcfg).functional_loss, topt.update,
                           lambda s: LR,
                           transport=GossipTransport(N, codec=codec))

    def state(np_state, t):
        params, opt, prev = (params_from_numpy(x, "cpu") if x is not None
                             else None for x in np_state[:3])
        return SwarmState(params, opt, prev, t,
                          _inflight_from_numpy(np_state[3]))

    return step, state


def _port_superstep(step, tstate, t, quantize, mode="blocking",
                    h_mode="fixed", masked=False, mask=None):
    _, batches, perms, us, _, hs = _jax_run(quantize, mode, h_mode, masked)
    mask = _masks(masked)[t] if mask is None else mask
    return step(tstate, {k: torch.from_numpy(v)
                         for k, v in batches[t].items()},
                perms[t], hs[t], None, mask,
                u=torch.from_numpy(us[t].copy()))


def _flat(params):
    """A port parameter tree, or a JAX numpy one, packed flat."""
    if not isinstance(jax.tree.leaves(params)[0], torch.Tensor):
        params = params_from_numpy(params, "cpu")
    return TB.pack(TB.build_layout(params), params).numpy()


def test_slice_exact_matches_jax():
    """Three supersteps run on from JAX's initial state: parameters
    within atol 2e-5 of JAX's after each."""
    states, _, _, _, jl, _ = _jax_run(False)
    step, make = _port(False)
    tstate, tl = make(states[0], 0), []
    for t in range(STEPS):
        tstate, m = _port_superstep(step, tstate, t, False)
        tl.append(float(m["loss"]))
        np.testing.assert_allclose(_flat(tstate.params),
                                   _flat(states[t + 1][0]),
                                   atol=2e-5, rtol=0)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    np.testing.assert_allclose(
        float(gamma_potential(tstate.params)),
        float(jgamma(jax.tree.map(jnp.asarray, states[-1][0]))),
        rtol=1e-4, atol=1e-9)


def _q8_readings(tparams, jparams, scales, perm):
    """Port vs JAX after one q8 superstep: the max abs difference, the
    share within 2e-5, the max difference in units of its row's lattice
    step s, and the count of coordinates beyond s + 2e-5. A node's row
    takes the step of the payload it decoded, its partner perm[i]'s: a
    flipped code of the sender moves the receiver's average by s/2."""
    d = np.abs(_flat(tparams) - _flat(jparams)).reshape(N, -1, 256)
    s = scales.numpy().reshape(N, -1, 1)[np.asarray(perm)]
    return {"max_abs": float(d.max()),
            "share_within_2e-5": float((d <= 2e-5).mean()),
            "max_in_steps": float((d / s).max()),
            "beyond_one_step": int((d > s + 2e-5).sum())}


def _q8_ok(r):
    """The slice's q8 bound: every coordinate within one lattice step of
    its row (beyond the 2e-5 that exact gossip allows) and >= 99.9%
    within 2e-5."""
    return r["beyond_one_step"] == 0 and r["share_within_2e-5"] >= 0.999


def test_slice_q8_matches_jax():
    """Each of the three supersteps restarts from JAX's state before it
    (params, momentum, comm copy), so every one is held to the full bound:
    a code flips only where x/s + u lies within an ulp of an integer."""
    states, _, perms, _, jl, _ = _jax_run(True)
    codec = RecordingCodec()
    step, make = _port(True, codec)
    for t in range(STEPS):
        tstate, m = _port_superstep(step, make(states[t], t), t, True)
        np.testing.assert_allclose(float(m["loss"]), jl[t], rtol=1e-5)
        r = _q8_readings(tstate.params, states[t + 1][0], codec.scales[-1],
                         perms[t])
        assert _q8_ok(r), (t, r)
        # the comm copy refreshed to the post-interaction model (all matched)
        assert all(torch.equal(a, b) for a, b in
                   zip(jax.tree.leaves(tstate.prev),
                       jax.tree.leaves(tstate.params)))
    assert len(codec.scales) == STEPS


@pytest.mark.parametrize("fault", [OneStepOffCodec, AverageDroppedCodec],
                         ids=["one_step_off", "average_dropped"])
def test_slice_q8_bound_rejects_a_planted_decode_fault(fault):
    states, _, perms, _, _, _ = _jax_run(True)
    codec = fault()
    step, make = _port(True, codec)
    tstate, _ = _port_superstep(step, make(states[0], 0), 0, True)
    r = _q8_readings(tstate.params, states[1][0], codec.scales[-1], perms[0])
    assert not _q8_ok(r), r


def _async_q8_step(mode, t, codec, h_mode="fixed", masked=False):
    """Superstep t of the q8 port restarted from JAX's state before it;
    -> (port state, metrics, the decoded rows' lattice steps)."""
    states, _, _, _, _, _ = _jax_run(True, mode, h_mode, masked)
    step, make = _port(True, codec, mode, h_mode)
    start = make(states[t], t)
    scales = start.inflight["wire"][1].reshape(-1).clone() \
        if mode == "overlap" else None
    tstate, m = _port_superstep(step, start, t, True, mode, h_mode, masked)
    return tstate, m, scales if scales is not None else codec.scales[-1]


@pytest.mark.parametrize("mode", ["nonblocking", "overlap"])
def test_slice_q8_async_matches_jax(mode):
    """Non-blocking and overlapped q8 supersteps, each restarted from
    JAX's state (comm copy or in-flight payload included), held to the
    blocking slice's bound."""
    states, _, perms, _, jl, _ = _jax_run(True, mode)
    for t in range(STEPS):
        tstate, m, scales = _async_q8_step(mode, t, RecordingCodec())
        np.testing.assert_allclose(float(m["loss"]), jl[t], rtol=1e-5)
        r = _q8_readings(tstate.params, states[t + 1][0], scales, perms[t])
        assert _q8_ok(r), (t, r)
        if mode == "nonblocking":
            # the comm copy refreshed to S, the value sent (all matched)
            S = params_from_numpy(states[t][0], "cpu")
            assert all(torch.equal(a, b) for a, b in
                       zip(jax.tree.leaves(tstate.prev),
                           jax.tree.leaves(S)))
        else:
            assert tstate.prev is None
            # the packed comm copy refreshed to sbuf, the value sent
            np.testing.assert_array_equal(tstate.inflight["prev"].numpy(),
                                          states[t][3]["sbuf"])


@pytest.mark.parametrize("mode", ["blocking", "nonblocking", "overlap"])
def test_slice_q8_geometric_h_matches_jax(mode):
    """Heterogeneous local steps: per-node h_i from JAX's geometric
    sampler (clipped to [1, H_MAX], batch depth H_MAX), so nodes below
    max_i h_i take masked partial steps and the loss averages each node's
    own count. Each q8 superstep restarts from JAX's state before it and
    is held to the slice's bound, the loss at rtol 1e-5."""
    states, _, perms, _, jl, hs = _jax_run(True, mode, "geometric")
    # the draw is heterogeneous: some node stops short of the loop bound
    assert any(len(set(h.tolist())) > 1 for h in hs), hs
    for t in range(STEPS):
        tstate, m, scales = _async_q8_step(mode, t, RecordingCodec(),
                                           "geometric")
        np.testing.assert_allclose(float(m["loss"]), jl[t], rtol=1e-5)
        r = _q8_readings(tstate.params, states[t + 1][0], scales, perms[t])
        assert _q8_ok(r), (t, hs[t], r)


@pytest.mark.parametrize("mode", ["blocking", "nonblocking", "overlap"])
def test_slice_masked_matches_jax(mode):
    """Under participation masks (a matched pair lands only where both
    ends take part; the loss averages the participants) each q8 superstep,
    restarted from JAX's state before it, is held to the slice's bound;
    and the exact blocking run, chained from JAX's initial state, stays
    within 2e-5."""
    states, _, perms, _, jl, _ = _jax_run(True, mode, masked=True)
    masks = _masks(True)
    dropped = [bool(((np.asarray(p) != np.arange(N)) & ~m).any())
               for p, m in zip(perms, masks)]
    assert any(dropped), (perms, masks)
    for t in range(STEPS):
        tstate, m, scales = _async_q8_step(mode, t, RecordingCodec(),
                                           masked=True)
        np.testing.assert_allclose(float(m["loss"]), jl[t], rtol=1e-5)
        r = _q8_readings(tstate.params, states[t + 1][0], scales, perms[t])
        assert _q8_ok(r), (t, r)
    if mode == "blocking":
        states, _, _, _, jl, _ = _jax_run(False, masked=True)
        step, make = _port(False)
        tstate = make(states[0], 0)
        for t in range(STEPS):
            tstate, m = _port_superstep(step, tstate, t, False, masked=True)
            np.testing.assert_allclose(_flat(tstate.params),
                                       _flat(states[t + 1][0]),
                                       atol=2e-5, rtol=0)
            np.testing.assert_allclose(float(m["loss"]), jl[t], rtol=1e-5)


@pytest.mark.parametrize("mode", ["blocking", "nonblocking", "overlap"])
def test_all_true_mask_is_bitwise_unmasked(mode):
    """An all-True participation mask leaves every q8 superstep bitwise
    what it is without a mask."""
    states, _, _, _, _, _ = _jax_run(True, mode)
    step, make = _port(True, None, mode)
    for t in range(STEPS):
        a, ma = _port_superstep(step, make(states[t], t), t, True, mode)
        b, mb = _port_superstep(step, make(states[t], t), t, True, mode,
                                mask=np.ones(N, bool))
        assert all(torch.equal(x, y) for x, y in
                   zip(jax.tree.leaves(a.params), jax.tree.leaves(b.params)))
        assert float(ma["loss"]) == float(mb["loss"])


def test_pipeline_prologue_matches_jax():
    """The port's prologue from JAX's initial models and JAX's uniforms
    gives JAX's first payload bitwise: sbuf, a distinct prev, codes and
    scales."""
    states, _, _, us, _, _ = _jax_run(True, "overlap")
    params = params_from_numpy(states[0][0], "cpu")
    scfg = SwarmConfig(n_nodes=N, H=H, quantize=True, nonblocking=True,
                       overlap=True)
    infl = pipeline_prologue(scfg, SwarmState(params, None, None, 0), None,
                             u=torch.from_numpy(us[-1].copy())).inflight
    jinfl = states[0][3]
    for k in ("sbuf", "prev"):
        np.testing.assert_array_equal(infl[k].numpy(), jinfl[k])
    assert infl["prev"].data_ptr() != infl["sbuf"].data_ptr()
    for w, jw in zip(infl["wire"], jinfl["wire"]):
        np.testing.assert_array_equal(w.numpy(), jw)


@pytest.mark.parametrize("fault", [OneStepOffCodec, AverageDroppedCodec],
                         ids=["one_step_off", "average_dropped"])
@pytest.mark.parametrize("mode", ["nonblocking", "overlap"])
def test_slice_q8_async_bound_rejects_a_planted_decode_fault(mode, fault):
    """Superstep 1: at superstep 0 every node still holds the one initial
    model and its comm copy equals it, so the exchange moves nothing and
    the scale is min_scale; a decode fault shows once the models differ."""
    states, _, perms, _, _, _ = _jax_run(True, mode)
    tstate, _, scales = _async_q8_step(mode, 1, fault())
    r = _q8_readings(tstate.params, states[2][0], scales, perms[1])
    assert not _q8_ok(r), r


def test_matchings_equal_jax_driver():
    jscfg = JSwarmConfig(n_nodes=8, H=2, gossip_impl="gather", codec=None)
    jperms, jhs = jpresample(jscfg, jcomplete(8), np.random.default_rng(5),
                             5, 6)
    tperms, ths = ttrain.presample_inputs(SwarmConfig(n_nodes=8, H=2),
                                          complete(8),
                                          np.random.default_rng(5), 6)
    np.testing.assert_array_equal(tperms, jperms)
    np.testing.assert_array_equal(ths, jhs)
    g, jg = complete(6), jcomplete(6)
    np.testing.assert_array_equal(g.edges, jg.edges)
    assert g.lambda2 == jg.lambda2
    r1, r2 = np.random.default_rng(9), np.random.default_rng(9)
    for frac in (1.0, 0.5):
        np.testing.assert_array_equal(sample_matching(g, r1, fraction=frac),
                                      jsample_matching(jg, r2, fraction=frac))


def test_driver_streams_equal_jax_driver():
    """Seed 0: the driver's geometric local-step counts (perm then h, step
    by step) and its non-iid batches, at the h_max batch depth, are
    bitwise the JAX driver's."""
    steps, nodes, h_max, batch, seq = 6, 8, 8, 2, 16
    jscfg = JSwarmConfig(n_nodes=nodes, H=2, h_mode="geometric",
                         h_max=h_max, gossip_impl="gather", codec=None)
    jperms, jhs = jpresample(jscfg, jcomplete(nodes),
                             np.random.default_rng(0), 0, steps)
    tr = ttrain.build(ttrain.build_parser().parse_args(
        ["--device", "cpu", "--reduced", "--layers", "1", "--d-model", "32",
         "--nodes", str(nodes), "--steps", str(steps), "--h-mode",
         "geometric", "--h-max", str(h_max), "--non-iid", "0.5",
         "--batch", str(batch), "--seq", str(seq), "--overlap"]))
    assert tr.h_max == h_max == tr.scfg.h_loop_bound
    np.testing.assert_array_equal(tr.perms, jperms)
    np.testing.assert_array_equal(tr.hs, jhs)
    assert jhs.min() >= 1 and jhs.max() <= h_max and len(set(jhs.ravel())) > 2
    jds = JSyntheticLMDataset(DataConfig(
        vocab_size=tr.cfg.vocab_size, seq_len=seq, seed=0,
        non_iid_alpha=0.5), nodes)
    np.testing.assert_array_equal(tr.ds.mix, jds.mix)
    np.testing.assert_array_equal(tr.ds.succ, jds.succ)
    assert not np.allclose(jds.mix, 1.0 / jds.cfg.n_chains)
    for t in (0, 3):
        jnb = jmake_node_batches(jds, t, batch * h_max)
        tnb = tr.node_batches(t)
        for k in ("tokens", "targets"):
            np.testing.assert_array_equal(tnb[k], jnb[k])
        assert tuple(tr.batch(t)["tokens"].shape) == (nodes, h_max, batch,
                                                      seq)
    # the iid stream is unchanged by the new field
    iid = TSyntheticLMDataset(TDataConfig(64, seq, seed=0), nodes)
    np.testing.assert_array_equal(
        tmake_node_batches(iid, 2, 3)["tokens"],
        jmake_node_batches(JSyntheticLMDataset(
            DataConfig(64, seq, seed=0), nodes), 2, 3)["tokens"])


@pytest.mark.parametrize("flags", [["--quantize"],
                                   ["--quantize", "--overlap", "--h-mode",
                                    "geometric", "--h-max", "4"]],
                         ids=["blocking_q8", "overlap_q8_geometric"])
def test_superstep_frees_the_old_state_without_a_gc_pass(flags):
    """Once the trainer replaces its state, the old state's tensors are
    freed by reference counting alone: no garbage cycle keeps a model copy
    alive into the next superstep, where at full width each copy costs a
    whole model of device memory. (Superstep 0 runs first: torch's lazy
    imports inside the first vmap call leave one-off cyclic garbage.)"""
    tr = ttrain.build(ttrain.build_parser().parse_args(
        ["--device", "cpu", "--reduced", "--layers", "1", "--d-model", "32",
         "--nodes", "4", "--steps", "2", "--seq", "16", "--batch", "1"] +
        flags))
    tr.superstep(0)
    gc.collect()
    gc.disable()
    try:
        old = [weakref.ref(x) for x in jax.tree.leaves(
            (tr.state.params, tr.state.opt, tr.state.prev,
             tr.state.inflight))]
        tr.superstep(1)
        assert sum(r() is not None for r in old) == 0
    finally:
        gc.enable()


def test_local_steps_respect_h_counts():
    """A node with h_i = 0 keeps its model and momentum bitwise; the
    others take their steps in the same optimizer sweep."""
    tcfg = reduced(get_config("transformer-wmt"), n_layers=1, d_model=32)
    opt = make_optimizer("sgd", lr=LR, momentum=0.9)
    step = make_swarm_step(SwarmConfig(n_nodes=2, H=2),
                           TransformerLM(tcfg).functional_loss, opt.update,
                           lambda s: LR)
    from repro_torch.models import init_params
    g = torch.Generator()
    g.manual_seed(0)
    one = init_params(g, tcfg, "cpu")
    params = tree_map(lambda x: torch.stack([x, x]), one)
    state = SwarmState(params, opt.init(params), None, 0)
    ds = SyntheticLMDataset(DataConfig(tcfg.vocab_size, SEQ, seed=0), 2)
    nb = make_node_batches(ds, 0, BATCH * 2)
    batch = {k: torch.from_numpy(v.reshape(2, 2, BATCH, SEQ))
             for k, v in nb.items()}
    new, m = step(state, batch, np.array([0, 1]), np.array([2, 0]), None)
    assert all(torch.equal(a[1], b[1]) for a, b in
               zip(jax.tree.leaves(new.params), jax.tree.leaves(params)))
    assert not torch.equal(new.params["embed"][0], params["embed"][0])
    assert all(torch.equal(a[1], torch.zeros_like(a[1]))
               for a in jax.tree.leaves(new.opt))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_cli_smoke_cpu(tmp_path):
    out = tmp_path / "m.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--reduced", "--layers", "1", "--d-model", "32", "--nodes", "4",
         "--steps", "2", "--quantize", "--log-every", "1", "--seq", "16",
         "--out", str(out)],
        capture_output=True, text=True, env=_env(), timeout=120)
    assert proc.returncode == 0, proc.stderr
    recs = [json.loads(line) for line in proc.stdout.splitlines()]
    assert [r["step"] for r in recs] == [0, 1]
    for r in recs:
        assert set(r) == {"step", "loss", "gamma", "wall_s"}
        assert np.isfinite(r["loss"]) and np.isfinite(r["gamma"])
    assert json.loads(out.read_text())["history"] == recs


def test_cli_refuses_other_algos_and_flags():
    """An unknown rate profile or algorithm does not parse; --scan-chunk
    and --codec are ported and do."""
    for argv in (["--rate-profile", "explicit"], ["--algo", "sgd"]):
        with pytest.raises(SystemExit) as e:
            ttrain.build_parser().parse_args(argv)
        assert e.value.code == 2
    args = ttrain.build_parser().parse_args(["--scan-chunk", "2",
                                             "--codec", "q4"])
    assert (args.scan_chunk, args.codec) == (2, "q4")


def test_cli_without_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(SystemExit) as e:
        ttrain.main(["--reduced", "--layers", "1", "--d-model", "32",
                     "--steps", "1"])
    assert e.value.code not in (0, None)
    assert "--device cpu" in str(e.value.code)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax", "optax",
                               "networkx"), \
                f"{f.relative_to(ROOT)} imports {mod}"


def test_profile_summary_counts_device_busy_and_spans():
    """The profiler summary: busy time is the union of device intervals,
    and a span's device time is the busy time inside it."""
    from repro_torch.launch.profile import summarize
    ev = [
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 500, "dur": 1000},
        {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 3000,
         "dur": 500},
        {"ph": "X", "cat": "user_annotation", "name": "swarm.sgd", "ts": 0,
         "dur": 200},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "swarm.sgd",
         "ts": 1000, "dur": 2200},
    ]
    s = summarize({"traceEvents": ev}, wall_ms=4.0)
    assert s["device_busy_ms"] == pytest.approx(2.0)
    assert s["idle_share"] == pytest.approx(0.5)
    sp = s["spans"]["swarm.sgd"]
    assert sp["count"] == 1 and sp["host_ms"] == pytest.approx(0.2)
    assert sp["device_busy_ms"] == pytest.approx(0.7)
    assert [k["name"] for k in s["top_kernels"]] == ["k1", "k2"]


def test_profile_attributes_streams_and_permute_overlap():
    """A device event belongs to the spans whose host range holds its
    launch (by correlation id, on the launching thread); the in-flight
    permute's overlap counts device work on other streams only."""
    from repro_torch.launch.profile import summarize

    def launch(ts, corr):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "tid": 1, "ts": ts, "dur": 1, "args": {"correlation": corr}}

    def kernel(ts, dur, stream, corr):
        return {"ph": "X", "cat": "kernel", "name": f"k{corr}", "tid": stream,
                "ts": ts, "dur": dur,
                "args": {"stream": stream, "correlation": corr}}
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "gossip.permute",
         "tid": 1, "ts": 0, "dur": 10},
        {"ph": "X", "cat": "user_annotation", "name": "swarm.grad",
         "tid": 1, "ts": 20, "dur": 100},
        launch(5, 1), launch(30, 2), launch(40, 3),
        kernel(100, 1000, 20, 1),       # the permute, side stream
        kernel(500, 1000, 7, 2),        # a forward kernel
        kernel(1600, 100, 7, 3),
        kernel(0, 200, 7, 99),          # launched outside every span
    ]
    s = summarize({"traceEvents": ev}, wall_ms=2.0)
    assert s["spans"]["gossip.permute"]["streams"] == [20]
    assert s["spans"]["swarm.grad"]["streams"] == [7]
    po = s["permute_overlap"]
    assert po["streams"] == [20]
    assert po["device_ms"] == pytest.approx(1.0)
    assert po["with_local_steps_ms"] == pytest.approx(0.6)
    assert po["with_any_other_stream_ms"] == pytest.approx(0.7)
