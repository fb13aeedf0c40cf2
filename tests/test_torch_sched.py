"""The port's scheduler (``repro_torch.sched``) against the JAX package's
(``repro.sched``), on the CPU.

* The numpy modules, bitwise: for several seeds, the rate profiles
  uniform (asynchronous and synchronous) and lognormal (sigma 0.5 and
  0.8), with and without straggler and failure injection, on complete,
  ring and irregular graphs and in every local-step accrual mode, the
  traces (times, pairs, h, rates, meta), their statistics, the binned
  schedules (perms, h, mask, event_bin) and the clocks' state are
  ``np.array_equal`` to the reference's; clock state and traces resume
  bit-exactly across the two packages; the weighted matching sampler
  draws the reference's matchings.
* The cost model: ``cost_params_from_model`` counts the reference's FLOPs,
  HBM bytes, payload bytes and padded width from meta tensors, and every
  ``predict_*`` function returns the reference's dict for a shared
  ``CostParams``; the port's defaults are the H100's.
* The engine on a heterogeneous lognormal trace with stragglers (the fp32
  linear engine of ``tests/test_torch_async.py``), blocking, non-blocking
  and overlapped, within 2e-5 of the reference's superstep and event
  oracles; overlapped equals non-blocking bitwise.
* ``--rate-profile uniform`` equals ``none`` bitwise, engine and drivers.
* The reduced transformer slice per bin under the trace, restarted from
  JAX's state: exact within 2e-5, q8 within one lattice step of the
  partner's row and >= 99.98% of coordinates within 2e-5.
* Both drivers print the same ``sched`` line; checkpoint metadata written
  by either driver restores the other's event stream; the registry refuses
  where the reference refuses, over every algorithm and scheduler flag.
"""
import argparse
import functools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sched as J
import repro_torch.sched as T
from repro.algorithms import validate_run_config as jvalidate
from repro.configs import get_config as jget_config, reduced as jreduced
from repro.core import SwarmConfig as JSwarmConfig
from repro.core import make_swarm_step as jmake_swarm_step
from repro.core import swarm_init as jswarm_init
from repro.core.graph import irregular_graph as jirregular
from repro.core.graph import make_graph as jmake_graph
from repro.core.graph import sample_weighted_matching as jweighted
from repro.core.simulator import run_events_oracle, run_superstep_oracle
from repro_torch.core import simulator as TSIM
from repro.data import DataConfig, SyntheticLMDataset, make_node_batches
from repro.launch import train as jtrain
from repro.models import init_params as jinit_params
from repro.models import loss_fn as jloss_fn
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch import hardware as HW
from repro_torch.algorithms import CAPABILITIES, validate_run_config
from repro_torch.configs import get_config, reduced
from repro_torch.core import bucket as TB
from repro_torch.core import (
    SwarmConfig, SwarmState, make_swarm_step, pipeline_prologue,
)
from repro_torch.core.exchange import GossipTransport
from repro_torch.core.graph import irregular_graph, make_graph
from repro_torch.core.graph import sample_weighted_matching
from repro_torch.launch import train as ttrain
from repro_torch.models import TransformerLM
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import make_optimizer
from repro_torch.quant.codecs import LatticeCodec
from repro_torch.quant.schemes import ModularQuantConfig

N, D, H_MEAN, H_MAX, B = 8, 12, 2, 4, 4
LR = 0.05
IRREGULAR = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 6), (6, 7),
             (7, 0), (0, 4), (1, 5), (2, 6), (0, 2)]
STRAGGLERS = {"none": (0.0, 10.0, 0.0, 0.0), "slow": (0.25, 4.0, 0.0, 0.0),
              "failing": (0.25, 4.0, 0.1, 1.0)}
PROFILES = {"uniform": ("uniform", 0.5), "lognormal0.5": ("lognormal", 0.5),
            "lognormal0.8": ("lognormal", 0.8)}
SEEDS = (0, 7, 13)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Small tensors: more intra-op threads than this only contend with
    the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _graphs(kind):
    if kind == "irregular":
        return (irregular_graph("irr", N, IRREGULAR),
                jirregular("irr", N, IRREGULAR))
    return make_graph(kind, N), jmake_graph(kind, N)


def _pkg(mod):
    return T if mod == "port" else J


def _clocks(mod, g, profile, straggler, seed, **kw):
    S = _pkg(mod)
    kind, sigma = PROFILES[profile]
    prof = S.RateProfile(kind, sigma=sigma)
    strag = S.StragglerConfig(*STRAGGLERS[straggler])
    return prof, S.PoissonClocks(g, prof.make_rates(N, seed), seed, strag,
                                 **kw)


def assert_trace_equal(a, b):
    for f in ("times", "pairs", "h", "rates"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    for f in ("kinds", "alive"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            np.testing.assert_array_equal(x, y, f)
    assert a.h_max == b.h_max and a.n_nodes == b.n_nodes
    assert json.dumps(a.meta, default=np.ndarray.tolist) == \
        json.dumps(b.meta, default=np.ndarray.tolist)


def assert_schedule_equal(a, b):
    for f in ("perms", "h", "mask", "event_bin", "pool_idx", "kinds",
              "alive", "retire", "tiers"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, f)
    assert a.density() == b.density()


# ---------------------------------------------------------------------------
# the numpy modules, bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("graph", ["complete", "ring", "irregular"])
@pytest.mark.parametrize("straggler", list(STRAGGLERS))
@pytest.mark.parametrize("profile", list(PROFILES))
def test_traces_and_bins_equal_the_reference(profile, straggler, graph):
    g, jg = _graphs(graph)
    for seed in SEEDS:
        for h_mode in ("rate", "fixed", "geometric"):
            tprof, tc = _clocks("port", g, profile, straggler, seed)
            jprof, jc = _clocks("jax", jg, profile, straggler, seed)
            np.testing.assert_array_equal(tc.rates, jc.rates)
            np.testing.assert_array_equal(tc.straggler_mask,
                                          jc.straggler_mask)
            tt = T.generate_trace(g, tprof, 60, H=H_MEAN, h_max=H_MAX,
                                  h_mode=h_mode, seed=seed, clocks=tc)
            jt = J.generate_trace(jg, jprof, 60, H=H_MEAN, h_max=H_MAX,
                                  h_mode=h_mode, seed=seed, clocks=jc)
            assert_trace_equal(tt, jt)
            assert tc.state_dict() == jc.state_dict()
            assert T.trace_stats(tt) == J.trace_stats(jt)
            assert_schedule_equal(T.bin_trace(tt), J.bin_trace(jt))
            np.testing.assert_array_equal(T.participation_rates(tc),
                                          J.participation_rates(jc))


@pytest.mark.parametrize("graph", ["complete", "ring", "irregular"])
def test_synchronous_trace_equals_the_reference(graph):
    g, jg = _graphs(graph)
    for seed in SEEDS:
        tt = T.synchronous_trace(g, 7, H=3, rng=np.random.default_rng(seed))
        jt = J.synchronous_trace(jg, 7, H=3, rng=np.random.default_rng(seed))
        assert_trace_equal(tt, jt)
        assert_schedule_equal(T.bin_trace(tt), J.bin_trace(jt))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_clock_state_resumes_across_packages(direction):
    """The port of the reference's clock round trip (tests/test_sched.py):
    a clock's state, through JSON, resumes the exact event stream in the
    other package — also mid-failure-injection."""
    src, dst = ("jax", "port") if direction == "jax_to_port" \
        else ("port", "jax")
    g = {p: _graphs("complete")[i] for i, p in enumerate(("port", "jax"))}
    for profile in PROFILES:
        _, full = _clocks(src, g[src], profile, "failing", 7)
        evs_full = [full.next_event() for _ in range(80)]
        _, c1 = _clocks(src, g[src], profile, "failing", 7)
        head = [c1.next_event() for _ in range(40)]
        state = json.loads(json.dumps(c1.state_dict()))
        S = _pkg(dst)
        kind, sigma = PROFILES[profile]
        c2 = S.PoissonClocks.from_state(
            state, g[dst], S.RateProfile(kind, sigma=sigma).make_rates(N, 7),
            7, S.StragglerConfig(*STRAGGLERS["failing"]))
        tail = [c2.next_event() for _ in range(40)]
        assert evs_full == head + tail
        assert c2.state_dict() == full.state_dict()


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_trace_resumes_across_packages(direction):
    """The port of the reference's trace resume (tests/test_sched.py):
    clock state plus per-node accrual times continue the trace bitwise in
    the other package."""
    src, dst = ("jax", "port") if direction == "jax_to_port" \
        else ("port", "jax")
    g = {p: _graphs("ring")[i] for i, p in enumerate(("port", "jax"))}
    prof = {p: _clocks(p, g[p], "lognormal0.8", "slow", 9)[0]
            for p in ("port", "jax")}
    _, cf = _clocks(src, g[src], "lognormal0.8", "slow", 9)
    full = _pkg(src).generate_trace(g[src], prof[src], 60, H=2, h_max=8,
                                    seed=9, clocks=cf)
    _, c = _clocks(src, g[src], "lognormal0.8", "slow", 9)
    head = _pkg(src).generate_trace(g[src], prof[src], 30, H=2, h_max=8,
                                    seed=9, clocks=c)
    state = json.loads(json.dumps(c.state_dict()))
    S = _pkg(dst)
    c2 = S.PoissonClocks.from_state(
        state, g[dst], prof[dst].make_rates(N, 9), 9,
        S.StragglerConfig(*STRAGGLERS["slow"]))
    tail = S.generate_trace(g[dst], prof[dst], 30, H=2, h_max=8, seed=9,
                            clocks=c2, last_t=np.asarray(head.meta["last_t"]))
    for f in ("times", "pairs", "h"):
        np.testing.assert_array_equal(
            getattr(full, f),
            np.concatenate([getattr(head, f), getattr(tail, f)]))


def test_weighted_matching_equals_the_reference():
    for kind in ("complete", "ring", "irregular"):
        g, jg = _graphs(kind)
        for seed in SEEDS:
            w = np.random.default_rng(seed).random(g.m)
            w[::5] = 0.0
            dead = np.zeros(N, bool)
            dead[seed % N] = True
            for weights, dd in ((np.ones(g.m), None), (w, None), (w, dead)):
                r1 = np.random.default_rng(seed)
                r2 = np.random.default_rng(seed)
                for _ in range(5):
                    np.testing.assert_array_equal(
                        sample_weighted_matching(g, r1, weights, dd),
                        jweighted(jg, r2, weights, dd))
    g, _ = _graphs("complete")
    for bad, msg in ((np.ones(3), "shape"), (-np.ones(g.m), ">= 0"),
                     (np.zeros(g.m), "sum to 0")):
        with pytest.raises(ValueError, match=msg):
            sample_weighted_matching(g, np.random.default_rng(0), bad)


def test_binning_refusals_equal_the_reference():
    g, jg = _graphs("complete")
    tt = T.generate_trace(g, T.RateProfile(), 20, seed=1)
    jt = J.generate_trace(jg, J.RateProfile(), 20, seed=1)
    for kw in (dict(static_pairs=[(0, 1)]), dict(tiers=np.zeros(3)),
               dict(pool=[np.arange(N)], static_pairs=[(0, 1)])):
        with pytest.raises(ValueError) as e1:
            T.bin_trace(tt, **kw)
        with pytest.raises(ValueError) as e2:
            J.bin_trace(jt, **kw)
        assert str(e1.value) == str(e2.value)
    pool = [np.asarray([1, 0, 3, 2, 5, 4, 7, 6], np.int32),
            np.asarray([2, 3, 0, 1, 6, 7, 4, 5], np.int32)]
    np.testing.assert_array_equal(T.pool_edges(pool), J.pool_edges(pool))
    tp = T.generate_trace(g, T.RateProfile(), 30, seed=2,
                          edges=T.pool_edges(pool))
    jp = J.generate_trace(jg, J.RateProfile(), 30, seed=2,
                          edges=J.pool_edges(pool))
    assert_schedule_equal(T.bin_trace(tp, pool=pool),
                          J.bin_trace(jp, pool=pool))
    ts, js = T.bin_trace(tp, pool=pool), J.bin_trace(jp, pool=pool)
    for s in range(ts.n_supersteps):
        for impl in ("gather", "ppermute_pool"):
            for a, b in zip(T.engine_inputs(ts, s, impl),
                            J.engine_inputs(js, s, impl)):
                np.testing.assert_array_equal(a, b)
    for a, b in zip(T.stacked_engine_inputs(ts, 1, 4),
                    J.stacked_engine_inputs(js, 1, 4)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the cost model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["transformer-wmt", "olmo-1b"])
def test_cost_params_count_the_reference(arch):
    """FLOPs, HBM bytes, payload bytes and the padded width of one local
    step equal the reference's, full size and reduced, exact and q8, flat
    and two-tier; the port reads the shapes from meta tensors."""
    for red in (False, True):
        cfg, jcfg = get_config(arch), jget_config(arch)
        if red:
            cfg = reduced(cfg, n_layers=2, d_model=64)
            jcfg = jreduced(jcfg, n_layers=2, d_model=64)
        for quantize in (False, True):
            for topo in (None, "hier:4"):
                kw = dict(seq_len=128, local_batch=4, quantize=quantize,
                          topology=topo)
                a = T.cost_params_from_model(cfg, **kw)
                b = J.cost_params_from_model(jcfg, **kw)
                assert a.flops_per_step == b.flops_per_step
                assert a.hbm_bytes_per_step == b.hbm_bytes_per_step
                assert a.payload_bytes == b.payload_bytes
                assert a.meta == b.meta
                # the port prices on the H100's datasheet figures
                assert (a.peak_flops, a.hbm_bw, a.link_bw) == \
                    (HW.PEAK_FLOPS_BF16, HW.HBM_BW, HW.NVLINK_BW)
                assert a.inter_link_bw == (HW.IB_NDR_BW if topo else None)


def _shared_cost(quantize=True, inter=False):
    kw = dict(flops_per_step=3.1e9, hbm_bytes_per_step=2.7e8,
              payload_bytes=135200 if quantize else 532480,
              peak_flops=1e12, hbm_bw=1e11, link_bw=2e9,
              link_latency_s=7e-6)
    if inter:
        kw.update(inter_link_bw=2e8, inter_link_latency_s=3e-5)
    return T.CostParams(**kw), J.CostParams(**kw)


def _assert_same_dict(a, b):
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def test_predictions_equal_the_reference():
    """For a shared CostParams every predict_* function returns the
    reference's dict exactly: flat and two-tier, with churn, pairwise and
    bulk-synchronous."""
    from repro.core.hier import parse_topology as jparse
    from repro_torch.core.hier import parse_topology as tparse
    g, jg = _graphs("complete")
    for seed in SEEDS:
        tprof, tc = _clocks("port", g, "lognormal0.8", "failing", seed)
        jprof, jc = _clocks("jax", jg, "lognormal0.8", "failing", seed)
        tt = T.generate_trace(g, tprof, 80, seed=seed, clocks=tc)
        jt = J.generate_trace(jg, jprof, 80, seed=seed, clocks=jc)
        tiers = tparse("hier:4", N).tier_of_pairs(tt.pairs)
        np.testing.assert_array_equal(
            tiers, jparse("hier:4", N).tier_of_pairs(jt.pairs))
        for inter in (False, True):
            tcp, jcp = _shared_cost(inter=inter)
            for tr_tiers in (None, tiers):
                _assert_same_dict(
                    T.predict_all_modes(tt, tcp, tiers=tr_tiers),
                    J.predict_all_modes(jt, jcp, tiers=tr_tiers))
                for mode in ("blocking", "nonblocking", "overlap"):
                    _assert_same_dict(
                        T.predict_walltime(tt, tcp, mode=mode,
                                           tiers=tr_tiers),
                        J.predict_walltime(jt, jcp, mode=mode,
                                           tiers=tr_tiers))
                    assert T.analytic_walltime(tt, tcp, mode=mode,
                                               tiers=tr_tiers) == \
                        J.analytic_walltime(jt, jcp, mode=mode,
                                            tiers=tr_tiers)
            for algo in ("allreduce", "localsgd", "dpsgd"):
                for graph in ("complete", "ring"):
                    tg, jgg = _graphs(graph)
                    pf = T.bsp_payload_factor(algo, tg)
                    assert pf == J.bsp_payload_factor(algo, jgg)
                    _assert_same_dict(
                        T.predict_bsp_walltime(tt, T.bin_trace(tt), tcp,
                                               payload_factor=pf),
                        J.predict_bsp_walltime(jt, J.bin_trace(jt), jcp,
                                               payload_factor=pf))
    with pytest.raises(ValueError):
        T.predict_walltime(tt, tcp, mode="sideways")


# ---------------------------------------------------------------------------
# the engine on a heterogeneous trace, against the reference's oracles
# ---------------------------------------------------------------------------

MODES = {"blocking": (False, False), "nonblocking": (True, False),
         "overlap": (True, True)}


@functools.lru_cache(maxsize=None)
def _lin_trace(n_events=40, seed=13):
    """A lognormal (sigma 0.8) trace with a quarter of the nodes 4x slower,
    on the complete graph, binned; and its data."""
    g = make_graph("complete", N)
    tr = T.generate_trace(g, T.RateProfile("lognormal", sigma=0.8),
                          n_events, H=H_MEAN, h_max=H_MAX, seed=seed,
                          straggler=T.StragglerConfig(0.25, 4.0))
    sched = T.bin_trace(tr)
    r = np.random.default_rng(21)
    S = sched.n_supersteps
    X = r.normal(size=(S, N, H_MAX, B, D)).astype(np.float32)
    Y = r.normal(size=(S, N, H_MAX, B)).astype(np.float32)
    return tr, sched, X, Y


def _grad_fn(X, Y):
    def grad(w, i, t, q):
        x, y = X[t, i, q], Y[t, i, q]
        return x.T @ ((x @ w - y) / np.float32(B))
    return grad


def _tlin_loss(p, mb):
    return 0.5 * torch.mean((mb["x"] @ p["w"] - mb["y"]) ** 2)


def _lin_port_run(mode, sched, X, Y, x0, lr=LR):
    nonblocking, overlap = MODES[mode]
    scfg = SwarmConfig(n_nodes=N, H=H_MEAN, h_mode="trace", h_max=H_MAX,
                       nonblocking=nonblocking, overlap=overlap,
                       track_potential=False)
    opt = make_optimizer("sgd", lr=lr, momentum=0.0)
    step = make_swarm_step(scfg, _tlin_loss, opt.update, lambda s: lr)
    params = {"w": torch.from_numpy(np.array(x0, np.float32))}
    state = SwarmState(params, opt.init(params),
                       {"w": params["w"].clone()}
                       if nonblocking and not overlap else None, 0)
    gen = torch.Generator()
    gen.manual_seed(11)
    if overlap:
        state = pipeline_prologue(scfg, state, gen)
    traj, metrics = [], []
    for s in range(sched.n_supersteps):
        perm, h, mask = T.engine_inputs(sched, s)
        state, m = step(state, {"x": torch.from_numpy(X[s]),
                                "y": torch.from_numpy(Y[s])},
                        perm, h, gen, mask)
        traj.append(state.params["w"].numpy().copy())
        metrics.append(m)
    return np.stack(traj), metrics


def test_lin_trace_is_heterogeneous():
    """Guard: the trace has partial bins and unequal local-step counts."""
    tr, sched, _, _ = _lin_trace()
    assert sched.density() < 1.0
    assert len(set(sched.h[sched.mask].tolist())) > 1
    assert any(tr.meta["straggler_mask"])


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_matches_the_oracles_on_a_trace(mode):
    """The port of the reference's bridged-engine parity
    (tests/test_sched_parity.py): every bin's models within 2e-5 of the
    binned superstep oracle, and at each bin's last event of the
    one-event-at-a-time replay; the engine reports the bin's matched
    share."""
    tr, sched, X, Y = _lin_trace()
    x0 = (np.random.default_rng(3).normal(size=(N, D)) * 0.3
          ).astype(np.float32)
    nonblocking = MODES[mode][0]
    traj, metrics = _lin_port_run(mode, sched, X, Y, x0)
    ref = run_superstep_oracle(x0, _grad_fn(X, Y), sched.perms, H_MEAN, LR,
                               nonblocking=nonblocking, h_schedule=sched.h,
                               masks=sched.mask)
    np.testing.assert_allclose(traj, ref, rtol=0, atol=2e-5)
    seq = run_events_oracle(x0, _grad_fn(X, Y), tr.pairs, tr.h,
                            sched.event_bin, LR, nonblocking=nonblocking)
    # the port's own copy of the oracles is the reference's, bitwise
    np.testing.assert_array_equal(TSIM.run_superstep_oracle(
        x0, _grad_fn(X, Y), sched.perms, H_MEAN, LR, nonblocking=nonblocking,
        h_schedule=sched.h, masks=sched.mask), ref)
    np.testing.assert_array_equal(TSIM.run_events_oracle(
        x0, _grad_fn(X, Y), tr.pairs, tr.h, sched.event_bin, LR,
        nonblocking=nonblocking), seq)
    for s in range(sched.n_supersteps):
        last_e = int(np.nonzero(sched.event_bin == s)[0][-1])
        np.testing.assert_allclose(traj[s], seq[last_e], rtol=0, atol=2e-5)
    for s, m in enumerate(metrics):
        assert float(m["matched_frac"]) == pytest.approx(
            sched.mask[s].mean(), abs=1e-6)


def test_overlap_equals_nonblocking_bitwise_on_a_trace():
    _, sched, X, Y = _lin_trace()
    x0 = np.random.default_rng(4).normal(size=(N, D)).astype(np.float32)
    a, _ = _lin_port_run("nonblocking", sched, X, Y, x0)
    b, _ = _lin_port_run("overlap", sched, X, Y, x0)
    np.testing.assert_array_equal(a, b)


def test_uniform_trace_equals_the_plain_engine_bitwise():
    """The synchronous uniform trace drives the port's engine to the plain
    (unscheduled, unmasked) trajectory bit-exactly."""
    from repro_torch.core.graph import sample_matching
    g = make_graph("complete", N)
    steps = 6
    r = np.random.default_rng(21)
    X = r.normal(size=(steps, N, H_MEAN, B, D)).astype(np.float32)
    Y = r.normal(size=(steps, N, H_MEAN, B)).astype(np.float32)
    sched = T.bin_trace(T.synchronous_trace(g, steps, H=H_MEAN,
                                            rng=np.random.default_rng(5)))
    assert sched.n_supersteps == steps and sched.density() == 1.0
    x0 = np.random.default_rng(3).normal(size=(N, D)).astype(np.float32)
    for mode in MODES:
        nonblocking, overlap = MODES[mode]
        out = {}
        for bridged in (False, True):
            scfg = SwarmConfig(n_nodes=N, H=H_MEAN, nonblocking=nonblocking,
                               overlap=overlap, quantize=True)
            opt = make_optimizer("sgd", lr=LR, momentum=0.9)
            step = make_swarm_step(scfg, _tlin_loss, opt.update,
                                   lambda s: LR)
            params = {"w": torch.from_numpy(x0.copy())}
            state = SwarmState(params, opt.init(params),
                               {"w": params["w"].clone()}, 0)
            gen = torch.Generator()
            gen.manual_seed(11)
            if overlap:
                state = pipeline_prologue(scfg, state, gen)
            rng = np.random.default_rng(5)
            traj, losses = [], []
            for t in range(steps):
                batch = {"x": torch.from_numpy(X[t]),
                         "y": torch.from_numpy(Y[t])}
                if bridged:
                    perm, h, mask = T.engine_inputs(sched, t)
                    state, m = step(state, batch, perm, h, gen, mask)
                else:
                    state, m = step(state, batch, sample_matching(g, rng),
                                    np.full(N, H_MEAN, np.int32), gen)
                traj.append(state.params["w"].numpy().copy())
                losses.append(float(m["loss"]))
            out[bridged] = (np.stack(traj), losses)
        np.testing.assert_array_equal(out[True][0], out[False][0])
        assert out[True][1] == out[False][1], mode


# ---------------------------------------------------------------------------
# the reduced transformer slice per bin, against JAX
# ---------------------------------------------------------------------------

MN, SEQ, MB = 8, 16, 2     # nodes, sequence, per-node batch of the slice


class RecordingCodec(LatticeCodec):
    """The q8 lattice codec, remembering the scales of every encode."""

    def __init__(self):
        super().__init__(ModularQuantConfig())
        self.scales = []

    def encode(self, buf, prev_buf, rng, *, u=None, tile_rows: int = 8):
        q, s = super().encode(buf, prev_buf, rng, u=u, tile_rows=tile_rows)
        self.scales.append(s.reshape(-1).clone())
        return q, s


@functools.lru_cache(maxsize=None)
def _model_trace():
    g = make_graph("complete", MN)
    tr = T.generate_trace(g, T.RateProfile("lognormal", sigma=0.8), 8,
                          H=H_MEAN, h_max=H_MAX, seed=3,
                          straggler=T.StragglerConfig(0.25, 8.0))
    return T.bin_trace(tr)


def _np_state(jstate):
    return jax.device_get((jstate.params, jstate.opt, jstate.prev,
                           jstate.inflight))


@functools.lru_cache(maxsize=None)
def _jax_model_run(quantize: bool, mode: str):
    """JAX's reduced transformer (2 layers, d_model 64) over the trace's
    bins; -> (states before each bin and after the last, batches, us,
    losses)."""
    sched = _model_trace()
    nonblocking, overlap = MODES[mode]
    jcfg = jreduced(jget_config("transformer-wmt"), n_layers=2, d_model=64)
    jscfg = JSwarmConfig(n_nodes=MN, H=H_MEAN, quantize=quantize, codec=None,
                         gossip_impl="gather", nonblocking=nonblocking,
                         overlap=overlap, h_mode="trace", h_max=H_MAX)
    jopt = jmake_optimizer("sgd", lr=LR, momentum=0.9)
    jstep = jax.jit(jmake_swarm_step(
        jscfg, lambda p, mb: jloss_fn(jcfg, p, mb), jopt.update,
        lambda s: LR))
    jstate = jswarm_init(jax.random.PRNGKey(0), jscfg,
                         lambda k: jinit_params(k, jcfg), jopt.init)
    ds = SyntheticLMDataset(DataConfig(vocab_size=jcfg.vocab_size,
                                       seq_len=SEQ, seed=0), MN)
    from repro.core import bucket as JB
    n_padded = JB.build_layout(jstate.params).n_padded
    key = jax.random.PRNGKey(1)
    states, batches, us, losses = [], [], [], []
    for s in range(sched.n_supersteps):
        states.append(_np_state(jstate))
        nb = make_node_batches(ds, s, MB * H_MAX)
        batch = {k: v.reshape(MN, H_MAX, MB, SEQ) for k, v in nb.items()}
        perm, h, mask = T.engine_inputs(sched, s)
        key, sub = jax.random.split(key)
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, batch),
                           jnp.asarray(perm), jnp.asarray(h), sub,
                           jnp.asarray(mask))
        us.append(np.asarray(jax.random.uniform(sub, (MN, n_padded),
                                                jnp.float32)))
        batches.append(batch)
        losses.append(float(jm["loss"]))
    states.append(_np_state(jstate))
    return states, batches, us, losses


def _port_model_step(quantize, mode, codec):
    nonblocking, overlap = MODES[mode]
    tcfg = reduced(get_config("transformer-wmt"), n_layers=2, d_model=64)
    topt = make_optimizer("sgd", lr=LR, momentum=0.9)
    return make_swarm_step(
        SwarmConfig(n_nodes=MN, H=H_MEAN, quantize=quantize,
                    nonblocking=nonblocking, overlap=overlap,
                    h_mode="trace", h_max=H_MAX),
        TransformerLM(tcfg).functional_loss, topt.update, lambda s: LR,
        transport=GossipTransport(MN, codec=codec))


def _port_state(np_state, t):
    params, opt, prev = (params_from_numpy(x, "cpu") if x is not None
                         else None for x in np_state[:3])
    infl = np_state[3]
    if infl is not None:
        infl = {k: (tuple(torch.from_numpy(np.array(w)) for w in v)
                    if k == "wire" else torch.from_numpy(np.array(v)))
                for k, v in infl.items()}
    return SwarmState(params, opt, prev, t, infl)


def _flat(params):
    if not isinstance(jax.tree.leaves(params)[0], torch.Tensor):
        params = params_from_numpy(params, "cpu")
    return TB.pack(TB.build_layout(params), params).numpy()


@pytest.mark.parametrize("quantize,mode", [
    (False, "blocking"), (True, "blocking"), (True, "nonblocking"),
    (True, "overlap")], ids=["exact", "q8", "q8-nonblocking", "q8-overlap"])
def test_model_slice_per_bin_matches_jax(quantize, mode):
    """Every bin restarts from JAX's state before it (parameters,
    momentum, comm copy, in-flight payload), with JAX's batches, bins and
    uniforms: exact within 2e-5; q8 every coordinate within one lattice
    step of the partner's row beyond 2e-5 and >= 99.98% within 2e-5."""
    sched = _model_trace()
    assert sched.density() < 1.0 and sched.n_supersteps >= 4
    states, batches, us, jl = _jax_model_run(quantize, mode)
    for s in range(sched.n_supersteps):
        codec = RecordingCodec()
        step = _port_model_step(quantize, mode, codec)
        start = _port_state(states[s], s)
        scales = start.inflight["wire"][1].reshape(-1).clone() \
            if mode == "overlap" and quantize else None
        perm, h, mask = T.engine_inputs(sched, s)
        tstate, m = step(start, {k: torch.from_numpy(v)
                                 for k, v in batches[s].items()},
                         perm, h, None, mask,
                         u=torch.from_numpy(us[s].copy()))
        np.testing.assert_allclose(float(m["loss"]), jl[s], rtol=1e-5)
        d = np.abs(_flat(tstate.params) - _flat(states[s + 1][0]))
        if not quantize:
            assert float(d.max()) <= 2e-5, (s, float(d.max()))
            continue
        if scales is None:
            scales = codec.scales[-1]
        d = d.reshape(MN, -1, 256)
        step_rows = scales.numpy().reshape(MN, -1, 1)[np.asarray(perm)]
        assert int((d > step_rows + 2e-5).sum()) == 0, s
        assert float((d <= 2e-5).mean()) >= 0.9998, s
        # non-participants keep their models exactly (they took h = 0)
        idle = ~mask
        np.testing.assert_array_equal(
            _flat(tstate.params)[idle], _flat(states[s][0])[idle])


# ---------------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------------

DRIVER = ["--arch", "transformer-wmt", "--reduced", "--layers", "1",
          "--d-model", "32", "--nodes", "8", "--steps", "4", "--seq", "16",
          "--log-every", "1"]
SCHED_FLAGS = {
    "lognormal-straggler": ["--rate-profile", "lognormal", "--rate-sigma",
                            "0.8", "--straggler", "0.25:8"],
    "failing-ring": ["--rate-profile", "uniform_async", "--straggler",
                     "0.25:4:0.1:1", "--graph", "ring", "--steps", "2"],
    "uniform-ring": ["--rate-profile", "uniform", "--graph", "ring",
                     "--steps", "2"],
    "adpsgd": ["--rate-profile", "lognormal", "--algo", "adpsgd",
               "--steps", "2"],
    "localsgd": ["--rate-profile", "lognormal", "--algo", "localsgd",
                 "--steps", "2"],
}


def _lines(out: str) -> list:
    return [json.loads(x) for x in out.splitlines() if x.startswith("{")]


def _jax_main(argv, capsys, monkeypatch):
    for var in ("REPRO_AVAIL_PROFILE", "REPRO_RATE_PROFILE", "REPRO_CODEC",
                "REPRO_SCAN_CHUNK", "REPRO_TOPOLOGY",
                "REPRO_DEFAULT_GOSSIP_IMPL"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    capsys.readouterr()
    jtrain.main()
    return _lines(capsys.readouterr().out)


def _port_main(argv, capsys):
    capsys.readouterr()
    ttrain.main(argv + ["--device", "cpu"])
    return _lines(capsys.readouterr().out)


@pytest.mark.parametrize("case", list(SCHED_FLAGS))
def test_drivers_print_the_same_sched_line(case, capsys, monkeypatch):
    """Both drivers, the same flags: the same sched (and sched_warning)
    lines, records with the same keys at the same steps, and a sched_cost
    line of the same shape (its numbers are priced on different cards)."""
    argv = DRIVER + SCHED_FLAGS[case]
    jl = _jax_main(argv, capsys, monkeypatch)
    tl = _port_main(argv, capsys)
    for key in ("sched", "sched_warning"):
        assert [x for x in tl if key in x] == [x for x in jl if key in x]
    recs = [[x for x in lines if "step" in x] for lines in (tl, jl)]
    assert [set(r) for r in recs[0]] == [set(r) for r in recs[1]]
    assert [r["step"] for r in recs[0]] == [r["step"] for r in recs[1]]
    costs = [[x["sched_cost"] for x in lines if "sched_cost" in x]
             for lines in (tl, jl)]
    assert len(costs[0]) == len(costs[1]) == 1

    def keys(d):
        return {k: keys(v) if isinstance(v, dict) else None
                for k, v in d.items()}
    assert keys(costs[0][0]) == keys(costs[1][0])


def _losses(recs):
    return [(r["step"], r["loss"], r["gamma"]) for r in recs if "loss" in r]


@pytest.mark.parametrize("extra", [[], ["--quantize"],
                                   ["--quantize", "--overlap"]],
                         ids=["exact", "q8", "q8-overlap"])
def test_uniform_equals_none_bitwise_in_both_drivers(extra, capsys,
                                                     monkeypatch):
    """On a complete graph with even n, --rate-profile uniform logs the
    --rate-profile none run's losses and Γ exactly, in each driver; the
    port's final models are bitwise equal."""
    argv = DRIVER + extra + ["--steps", "3"]
    runs = []
    for flags in ([], ["--rate-profile", "uniform"]):
        args = ttrain.build_parser().parse_args(argv + flags +
                                                ["--device", "cpu"])
        tr = ttrain.build(args)
        runs.append((_losses(ttrain.run(args, tr)), _flat(tr.state.params)))
    assert runs[0][0] == runs[1][0]
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    if "--overlap" not in extra:
        base = _jax_main(argv, capsys, monkeypatch)
        uni = _jax_main(argv + ["--rate-profile", "uniform"], capsys,
                        monkeypatch)
        assert _losses(base) == _losses(uni)


def test_rate_profile_none_keeps_the_plain_streams():
    """--rate-profile none builds no schedule: the (perm, h) rows are the
    plain presample's and no mask is passed."""
    args = ttrain.build_parser().parse_args(DRIVER + ["--device", "cpu"])
    tr = ttrain.build(args)
    assert tr.schedule is None and tr.masks is None and tr.n_steps == 4
    perms, hs = ttrain.presample_inputs(tr.scfg, make_graph("complete", 8),
                                        np.random.default_rng(0), 4)
    np.testing.assert_array_equal(tr.perms, perms)
    np.testing.assert_array_equal(tr.hs, hs)


def test_driver_schedule_equals_the_reference():
    """build_schedule of both drivers: the same trace, schedule and clock
    state, per algorithm (the per-step ones accrue h = 1)."""
    for algo, flags in (("swarm", SCHED_FLAGS["lognormal-straggler"]),
                        ("adpsgd", ["--rate-profile", "uniform_async"]),
                        ("localsgd", ["--rate-profile", "lognormal"])):
        args = ttrain.build_parser().parse_args(DRIVER + flags)
        args.algo = algo
        caps = CAPABILITIES[algo]
        scfg = SwarmConfig(n_nodes=8, H=2, h_mode="trace", h_max=8)
        jscfg = JSwarmConfig(n_nodes=8, H=2, h_mode="trace", h_max=8,
                             gossip_impl="gather")
        g, jg = _graphs("complete")
        ts, tt, tc = ttrain.build_schedule(args, g, scfg, caps)
        js, jt, jc = jtrain.build_schedule(args, jg, jscfg, caps)
        assert_trace_equal(tt, jt)
        assert_schedule_equal(ts, js)
        assert tc.state_dict() == jc.state_dict()
        if not caps.local_H:
            assert ts.h.max() == 1


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_sched_checkpoint_meta_restores_across_drivers(writer, tmp_path):
    """The port of the reference's driver checkpoint round trip
    (tests/test_sched.py): sched_checkpoint_meta of one driver, through a
    checkpoint file of that package, restores the other driver's clocks,
    which continue the uninterrupted event stream bitwise."""
    from repro.checkpoint import save_checkpoint as jsave
    from repro_torch.checkpoint import load_metadata, save_checkpoint
    args = argparse.Namespace(rate_profile="lognormal", rate_sigma=0.8,
                              trace_seed=None, seed=3, straggler="0.25:4",
                              nodes=N, steps=10, H=2, avail=None,
                              topology=None)
    g, jg = _graphs("complete")
    scfg = SwarmConfig(n_nodes=N, H=2, h_mode="trace", h_max=8)
    jscfg = JSwarmConfig(n_nodes=N, H=2, h_mode="trace", h_max=8,
                         gossip_impl="gather")
    path = str(tmp_path / "ck")
    if writer == "jax":
        _, trace1, clocks = jtrain.build_schedule(args, jg, jscfg)
        jsave(path, {"w": np.zeros(2, np.float32)},
              {"sched": jtrain.sched_checkpoint_meta(args, trace1, clocks)})
        restore, S, graph = ttrain.restore_sched_clocks, T, g
    else:
        _, trace1, clocks = ttrain.build_schedule(args, g, scfg)
        save_checkpoint(path, {"w": torch.zeros(2)},
                        {"sched": ttrain.sched_checkpoint_meta(
                            args, trace1, clocks)})
        restore, S, graph = jtrain.restore_sched_clocks, J, jg
    meta = load_metadata(path)["sched"]
    assert meta == json.loads(json.dumps(
        jtrain.sched_checkpoint_meta(args, trace1, clocks)))
    c2, last_t, rng = restore(meta, graph)
    assert rng is None
    prof = S.RateProfile("lognormal", sigma=0.8)
    tail = S.generate_trace(graph, prof, 20, H=2, h_max=8, h_mode="rate",
                            seed=3, clocks=c2, last_t=last_t)
    ref_clock = J.PoissonClocks(jg, J.RateProfile("lognormal", sigma=0.8)
                                .make_rates(N, 3), 3,
                                jtrain.parse_straggler("0.25:4"))
    full = J.generate_trace(jg, J.RateProfile("lognormal", sigma=0.8),
                            trace1.n_events + 20, H=2, h_max=8,
                            h_mode="rate", seed=3, clocks=ref_clock)
    for f in ("times", "pairs", "h"):
        np.testing.assert_array_equal(getattr(full, f)[trace1.n_events:],
                                      getattr(tail, f))


def test_uniform_matching_rng_resumes_across_drivers(tmp_path):
    """The port of the reference's uniform-profile resume
    (tests/test_sched.py): the matching stream's rng state the port
    writes continues the JAX driver's synchronous matchings."""
    from repro_torch.checkpoint import load_metadata, save_checkpoint
    args = argparse.Namespace(rate_profile="uniform", rate_sigma=0.5,
                              trace_seed=None, seed=11, straggler=None,
                              nodes=N, steps=5, H=2, avail=None,
                              topology=None)
    g, jg = _graphs("complete")
    _, trace1, clocks = ttrain.build_schedule(args, g,
                                              SwarmConfig(n_nodes=N, H=2))
    assert clocks is None
    path = str(tmp_path / "ck")
    save_checkpoint(path, {"w": torch.zeros(2)},
                    {"sched": ttrain.sched_checkpoint_meta(args, trace1,
                                                           clocks)})
    _, _, rng = jtrain.restore_sched_clocks(load_metadata(path)["sched"], jg)
    tail = J.synchronous_trace(jg, 5, H=2, rng=rng)
    full = J.synchronous_trace(jg, 10, H=2, rng=np.random.default_rng(11))
    np.testing.assert_array_equal(full.pairs[trace1.n_events:], tail.pairs)


def test_driver_checkpoint_carries_the_sched_meta(tmp_path):
    from repro_torch.checkpoint import load_metadata
    ttrain.main(DRIVER + SCHED_FLAGS["lognormal-straggler"] +
                ["--quantize", "--device", "cpu", "--ckpt",
                 str(tmp_path / "ck"), "--steps", "2"])
    meta = load_metadata(str(tmp_path / "ck"))
    s = meta["sched"]
    assert s["profile"] == "lognormal" and s["straggler"] == "0.25:8"
    assert s["clocks"] is not None and s["avail"] is None
    assert meta["step"] >= 2 and meta["algo"] == "swarm"


def test_parse_straggler_equals_the_reference():
    for spec in (None, "", "0.25:8", "0.25:10:0.01:5"):
        assert ttrain.parse_straggler(spec).__dict__ == \
            jtrain.parse_straggler(spec).__dict__
    for spec in ("0.25", "0.25:4:1"):
        with pytest.raises(ValueError) as e1:
            ttrain.parse_straggler(spec)
        with pytest.raises(ValueError) as e2:
            jtrain.parse_straggler(spec)
        assert str(e1.value) == str(e2.value)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

GRID_PROFILES = ("none", "uniform", "uniform_async", "lognormal")
GRID_AVAIL = (None, "day_night:period=4,duty=0.5,join=0.25:1:2")
GRID_TOPO = (None, "flat", "hier:4", "hier:8", "hier:3", "ring:2")


def _accepts(fn, algo, **kw):
    try:
        fn(algo, **kw)
    except (ValueError, NotImplementedError):
        return False
    return True


@pytest.mark.parametrize("algo", sorted(CAPABILITIES))
def test_validate_refuses_where_the_reference_refuses(algo, monkeypatch):
    """Over mode x quantize x --rate-profile x --avail x --topology (with
    and without a node count) on the gather transport and the q8 codec,
    the port accepts exactly what the reference accepts."""
    for var in ("REPRO_DEFAULT_GOSSIP_IMPL", "REPRO_CODEC", "REPRO_TOPOLOGY",
                "REPRO_AVAIL_PROFILE"):
        monkeypatch.delenv(var, raising=False)
    n_accept = n_refuse = 0
    for mode in ({}, {"nonblocking": True}, {"overlap": True}):
        for quantize in (False, True):
            for profile in GRID_PROFILES:
                for avail in GRID_AVAIL:
                    for topo in GRID_TOPO:
                        for n_nodes in (None, 8):
                            kw = dict(quantize=quantize, rate_profile=profile,
                                      avail=avail, topology=topo,
                                      n_nodes=n_nodes, **mode)
                            j = _accepts(jvalidate, algo, gossip_impl="gather",
                                         **kw)
                            assert _accepts(validate_run_config, algo,
                                            **kw) == j, (algo, kw)
                            n_accept += j
                            n_refuse += not j
    assert n_accept and n_refuse
