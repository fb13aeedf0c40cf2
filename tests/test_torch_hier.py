"""Two-tier hierarchical gossip in the port (``--topology hier:G``) against
the JAX package, on the CPU.

* ``HierTopology`` bitwise the reference's: the grammar and its errors,
  intra and union graphs, edge weights, tier labels, inter-group perms,
  the tier coin's event stream, matching pools and pool indices, for
  ``hier:2`` and ``hier:4`` on 8 nodes (and a 16-node case).
* The degenerate contract: ``hier:n`` (one group) is bitwise the flat
  path — the same perms from the same seed, and the same trajectory
  through the port's driver, exact and q8 (the port of the reference's
  ``tests/test_hier.py`` degenerate tests).
* Two-tier traces bitwise: clocks on the union graph with the tier edge
  weights, per-event tiers, tier-pure bins (``BinnedSchedule.tiers``),
  and the two-tier prices of the cost model for a shared ``CostParams``.
* The engine on a two-tier trace within 2e-5 of the reference's oracle,
  and the drivers: the same ``sched`` line, ``link_util`` tiers priced
  on NVLink and InfiniBand, the plain driver's ``sample_event`` draws,
  and the reference's refusals.
"""
import argparse
import json
import sys

import numpy as np
import pytest
import torch

import repro.sched as J
import repro_torch.sched as T
from repro.core.graph import complete as jcomplete
from repro.core.hier import parse_topology as jparse
from repro.core.simulator import run_superstep_oracle
from repro_torch.core import simulator as TSIM
from repro.core.swarm import SwarmConfig as JSwarmConfig
from repro.launch import train as jtrain
from repro_torch import hardware as HW
from repro_torch.core import SwarmConfig, SwarmState, make_swarm_step
from repro_torch.core.graph import complete
from repro_torch.core.hier import (
    DEFAULT_INTER_FRAC, INTER, INTRA, HierTopology, parse_topology,
)
from repro_torch.launch import train as ttrain
from repro_torch.optim import make_optimizer
from repro_torch.tree import tree_leaves

N, D, H_MEAN, H_MAX, B = 8, 12, 2, 4, 4
LR = 0.05
TOPOS = (("hier:2", 8), ("hier:4", 8), ("hier:4:0.1", 8), ("hier:8", 8),
         ("hier:4", 16))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Small tensors: more intra-op threads than this only contend with
    the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _edges_equal(a, b):
    assert a.name == b.name and a.n == b.n and a.r == b.r
    np.testing.assert_array_equal(a.edges, b.edges)
    assert a.lambda2 == b.lambda2


@pytest.mark.parametrize("spec,n", TOPOS, ids=[f"{s}-n{n}" for s, n in TOPOS])
def test_topology_equals_the_reference(spec, n):
    t, j = parse_topology(spec, n), jparse(spec, n)
    assert (t.n_nodes, t.group_size, t.inter_frac, t.n_groups, t.spec) == \
        (j.n_nodes, j.group_size, j.inter_frac, j.n_groups, j.spec)
    _edges_equal(t.intra_graph(), j.intra_graph())
    _edges_equal(t.union_graph(), j.union_graph())
    np.testing.assert_array_equal(t.edge_weights(), j.edge_weights())
    pairs = np.random.default_rng(0).integers(0, n, size=(40, 2))
    np.testing.assert_array_equal(t.tier_of_pairs(pairs),
                                  j.tier_of_pairs(pairs))
    assert t.tier_of_pairs(np.zeros((0, 2), np.int32)).shape == (0,)
    for seed in range(4):
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(30):
            p1, tier1 = t.sample_event(r1)
            p2, tier2 = j.sample_event(r2)
            np.testing.assert_array_equal(p1, p2)
            assert tier1 == tier2
        if t.n_groups > 1:
            np.testing.assert_array_equal(
                t.inter_group_perm(np.random.default_rng(seed)),
                j.inter_group_perm(np.random.default_rng(seed)))
        pool, tiers = t.matching_pool(6, seed)
        jpool, jtiers = j.matching_pool(6, seed)
        np.testing.assert_array_equal(tiers, jtiers)
        for a, b in zip(pool, jpool):
            np.testing.assert_array_equal(a, b)
        assert t.inter_pool_size(6) == j.inter_pool_size(6)
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(20):
            assert t.sample_pool_index(r1, 6) == j.sample_pool_index(r2, 6)


def test_grammar_and_errors_equal_the_reference():
    for spec in (None, "", "flat", "none"):
        assert parse_topology(spec, 8) is None and jparse(spec, 8) is None
    t = parse_topology("hier:4", 16)
    assert (t.group_size, t.n_groups, t.inter_frac) == \
        (4, 4, DEFAULT_INTER_FRAC)
    for spec in ("ring:4", "hier:3", "hier:1", "hier:4:1.5", "hier",
                 "hier:4:0.1:2", "hier:16"):
        with pytest.raises(ValueError) as e1:
            parse_topology(spec, 8)
        with pytest.raises(ValueError) as e2:
            jparse(spec, 8)
        assert str(e1.value) == str(e2.value)
    with pytest.raises(ValueError, match="inter_frac"):
        HierTopology(8, 4, 0.0)
    assert INTRA == 0 and INTER == 1


def test_degenerate_sampling_is_the_flat_draw():
    """hier:n with one group draws exactly the flat matchings from the
    same rng stream, and the driver's presample is the flat one."""
    t = parse_topology(f"hier:{N}", N)
    g = complete(N)
    scfg = SwarmConfig(n_nodes=N, H=2, h_mode="geometric", h_max=4)
    a = ttrain.presample_inputs(scfg, g, np.random.default_rng(4), 8)
    b = ttrain.presample_inputs(scfg, g, np.random.default_rng(4), 8,
                                topo=t)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("spec", ["hier:2", "hier:4", "hier:8"])
def test_plain_driver_draws_the_reference_events(spec):
    """--rate-profile none --topology hier:G: the driver's (perm, h) rows
    are the JAX driver's, drawn through sample_event."""
    jscfg = JSwarmConfig(n_nodes=N, H=2, h_mode="geometric", h_max=4,
                         gossip_impl="gather", topology=spec)
    scfg = SwarmConfig(n_nodes=N, H=2, h_mode="geometric", h_max=4)
    jp, jh = jtrain.presample_inputs(jscfg, jcomplete(N),
                                     np.random.default_rng(5), 5, 9,
                                     topo=jparse(spec, N))
    tp, th = ttrain.presample_inputs(scfg, complete(N),
                                     np.random.default_rng(5), 9,
                                     topo=parse_topology(spec, N))
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(th, jh)


DRIVER = ["--arch", "transformer-wmt", "--reduced", "--layers", "1",
          "--d-model", "32", "--nodes", "8", "--steps", "3", "--seq", "16",
          "--log-every", "1", "--device", "cpu"]


def _run(argv):
    args = ttrain.build_parser().parse_args(argv)
    tr = ttrain.build(args)
    recs = ttrain.run(args, tr)
    return recs, tr


@pytest.mark.parametrize("extra", [[], ["--quantize"],
                                   ["--rate-profile", "lognormal"]],
                         ids=["exact", "q8", "lognormal"])
def test_degenerate_driver_run_is_flat_bitwise(extra, capsys):
    """hier:8 on 8 nodes through the port's driver: the same records
    (wall clock aside) and the same final models, bitwise, as the flat
    run — the plain driver and the scheduled one."""
    flat, tf = _run(DRIVER + extra)
    hier, th = _run(DRIVER + extra + ["--topology", "hier:8"])
    capsys.readouterr()
    strip = [{k: v for k, v in r.items() if k != "wall_s"}
             for r in flat]
    assert strip == [{k: v for k, v in r.items() if k != "wall_s"}
                     for r in hier]
    a, b = tree_leaves(tf.state.params), tree_leaves(th.state.params)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# two-tier traces, bins and prices
# ---------------------------------------------------------------------------


def _hier_trace(pkg, spec, seed, n_events=60, straggler=(0.25, 4.0)):
    S = T if pkg == "port" else J
    topo = (parse_topology if pkg == "port" else jparse)(spec, N)
    g, w = topo.union_graph(), topo.edge_weights()
    prof = S.RateProfile("lognormal", sigma=0.8)
    clocks = S.PoissonClocks(g, prof.make_rates(N, seed), seed,
                             S.StragglerConfig(*straggler), edge_weights=w)
    tr = S.generate_trace(g, prof, n_events, H=H_MEAN, h_max=H_MAX,
                          h_mode="rate", seed=seed, clocks=clocks)
    tiers = topo.tier_of_pairs(tr.pairs)
    return tr, S.bin_trace(tr, tiers=tiers), tiers


@pytest.mark.parametrize("spec", ["hier:2", "hier:4", "hier:4:0.1"])
def test_two_tier_traces_bins_and_prices_equal_the_reference(spec):
    kw = dict(flops_per_step=2e9, hbm_bytes_per_step=3e8,
              payload_bytes=135200, peak_flops=1e12, hbm_bw=1e11,
              link_bw=4e10, inter_link_bw=5e9, inter_link_latency_s=2e-5)
    tcp, jcp = T.CostParams(**kw), J.CostParams(**kw)
    for seed in (0, 3, 13):
        ta, sa, tia = _hier_trace("port", spec, seed)
        tb, sb, tib = _hier_trace("jax", spec, seed)
        for f in ("times", "pairs", "h", "rates"):
            np.testing.assert_array_equal(getattr(ta, f), getattr(tb, f))
        np.testing.assert_array_equal(tia, tib)
        assert (tia == INTER).any() and (tia == INTRA).any()
        for f in ("perms", "h", "mask", "event_bin", "tiers"):
            np.testing.assert_array_equal(getattr(sa, f), getattr(sb, f))
        assert sa.tiers.dtype == sb.tiers.dtype == np.int8
        # tier-pure bins: every pair of a bin rides the bin's tier
        topo = parse_topology(spec, N)
        for s in range(sa.n_supersteps):
            m = sa.mask[s]
            pairs = np.stack([np.arange(N)[m], sa.perms[s][m]], 1)
            assert (topo.tier_of_pairs(pairs) == sa.tiers[s]).all()
        assert json.dumps(T.predict_all_modes(ta, tcp, tiers=tia)) == \
            json.dumps(J.predict_all_modes(tb, jcp, tiers=tib))


def _tlin_loss(p, mb):
    return 0.5 * torch.mean((mb["x"] @ p["w"] - mb["y"]) ** 2)


@pytest.mark.parametrize("mode", ["blocking", "nonblocking", "overlap"])
def test_engine_on_a_two_tier_trace_matches_the_oracle(mode):
    from repro_torch.core import pipeline_prologue
    _, sched, _ = _hier_trace("port", "hier:4", 13, n_events=40)
    S = sched.n_supersteps
    r = np.random.default_rng(21)
    X = r.normal(size=(S, N, H_MAX, B, D)).astype(np.float32)
    Y = r.normal(size=(S, N, H_MAX, B)).astype(np.float32)
    x0 = (np.random.default_rng(3).normal(size=(N, D)) * 0.3).astype(
        np.float32)
    nonblocking, overlap = mode != "blocking", mode == "overlap"
    scfg = SwarmConfig(n_nodes=N, H=H_MEAN, h_mode="trace", h_max=H_MAX,
                       nonblocking=nonblocking, overlap=overlap,
                       track_potential=False)
    opt = make_optimizer("sgd", lr=LR, momentum=0.0)
    step = make_swarm_step(scfg, _tlin_loss, opt.update, lambda s: LR)
    params = {"w": torch.from_numpy(x0.copy())}
    state = SwarmState(params, opt.init(params),
                       {"w": params["w"].clone()}
                       if nonblocking and not overlap else None, 0)
    if overlap:
        state = pipeline_prologue(scfg, state, None)
    traj = []
    for s in range(S):
        perm, h, mask = T.engine_inputs(sched, s)
        state, _ = step(state, {"x": torch.from_numpy(X[s]),
                                "y": torch.from_numpy(Y[s])},
                        perm, h, None, mask)
        traj.append(state.params["w"].numpy().copy())

    def grad(w, i, t, q):
        x, y = X[t, i, q], Y[t, i, q]
        return x.T @ ((x @ w - y) / np.float32(B))
    ref = run_superstep_oracle(x0, grad, sched.perms, H_MEAN, LR,
                               nonblocking=nonblocking, h_schedule=sched.h,
                               masks=sched.mask)
    # the port's own copy of the oracle is the reference's, bitwise
    np.testing.assert_array_equal(TSIM.run_superstep_oracle(
        x0, grad, sched.perms, H_MEAN, LR, nonblocking=nonblocking,
        h_schedule=sched.h, masks=sched.mask), ref)
    np.testing.assert_allclose(np.stack(traj), ref, rtol=0, atol=2e-5)


def test_driver_prices_two_tiers_on_nvlink_and_infiniband(capsys,
                                                          monkeypatch):
    """Both drivers with --topology hier:4: the same sched line and tier
    event counts; the port's link_util prices tier 0 on NVLink and tier 1
    on one NDR InfiniBand port (datasheet figures)."""
    argv = [a for a in DRIVER if a not in ("--device", "cpu")] + [
        "--rate-profile", "lognormal", "--topology", "hier:4", "--quantize"]
    for var in ("REPRO_AVAIL_PROFILE", "REPRO_RATE_PROFILE", "REPRO_CODEC",
                "REPRO_SCAN_CHUNK", "REPRO_TOPOLOGY",
                "REPRO_DEFAULT_GOSSIP_IMPL"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    capsys.readouterr()
    jtrain.main()
    jl = [json.loads(x) for x in capsys.readouterr().out.splitlines()
          if x.startswith("{")]
    ttrain.main(argv + ["--device", "cpu"])
    tl = [json.loads(x) for x in capsys.readouterr().out.splitlines()
          if x.startswith("{")]
    assert [x for x in tl if "sched" in x] == [x for x in jl if "sched" in x]
    tu = next(x["link_util"] for x in tl if "link_util" in x)
    ju = next(x["link_util"] for x in jl if "link_util" in x)
    for tier in ("intra", "inter"):
        assert tu[tier]["events"] == ju[tier]["events"]
        assert tu[tier]["bytes"] == ju[tier]["bytes"]
    payload = tu["intra"]["bytes"] / (2 * tu["intra"]["events"])
    assert tu["intra"]["comm_time_s"] == pytest.approx(
        5e-6 + payload / HW.NVLINK_BW, rel=1e-12)
    assert tu["inter"]["comm_time_s"] == pytest.approx(
        5e-6 + payload / HW.IB_NDR_BW, rel=1e-12)
    assert tu["topology"] == "hier:4"


def test_driver_refuses_hier_as_the_reference():
    """hier with the synchronous uniform profile (build_schedule) and the
    capability matrix's refusals (algorithms without the hier row,
    --avail), with the reference's messages."""
    args = argparse.Namespace(rate_profile="uniform", rate_sigma=0.5,
                              trace_seed=None, seed=0, straggler=None,
                              nodes=N, steps=3, H=2, avail=None,
                              topology="hier:4")
    with pytest.raises(ValueError) as e1:
        ttrain.build_schedule(args, complete(N), SwarmConfig(n_nodes=N))
    with pytest.raises(ValueError) as e2:
        jtrain.build_schedule(args, jcomplete(N),
                              JSwarmConfig(n_nodes=N, gossip_impl="gather",
                                           topology="hier:4"))
    assert str(e1.value) == str(e2.value)
    from repro.algorithms import validate_run_config as jvalidate
    from repro_torch.algorithms import validate_run_config
    for algo, kw in (("sgp", {}), ("localsgd", {}),
                     ("swarm", {"avail": "day_night:period=4",
                                "rate_profile": "lognormal"})):
        with pytest.raises(ValueError) as e1:
            validate_run_config(algo, topology="hier:4", n_nodes=N, **kw)
        with pytest.raises(ValueError) as e2:
            jvalidate(algo, topology="hier:4", n_nodes=N,
                      gossip_impl="gather", **kw)
        # the reference adds a pointer to its design notes
        assert str(e2.value) == \
            str(e1.value) + ". See DESIGN.md §Baselines / §Codec."
    with pytest.raises(ValueError, match="not divisible"):
        validate_run_config("swarm", topology="hier:3", n_nodes=N)
