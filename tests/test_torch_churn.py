"""Elastic membership in the port (``--avail``) against the JAX package,
on the CPU.

* Availability models: ``parse_avail`` (day_night and trace-file kinds)
  gives the reference's model — state, window and up-time answers — and
  the reference's error message for every malformed spec or row.
* Churn traces and schedules bitwise: ``kinds``/``alive`` of the trace,
  ``kinds``/``alive``/``retire`` of the bins, the clock state with its
  membership, and a mid-churn resume across the two packages (the port of
  the reference's ``tests/test_churn.py`` resume and driver round trips).
* The join step: bitwise ``repro.core.make_join_step`` on a reduced
  transformer's state, exact and q8 (comm copy re-based), and on a
  residual; it takes no batch and no generator and calls no codec kernel;
  it refuses the overlap pipeline and a wire-tuple comm copy with the
  reference's messages. ``retire_nodes`` matches the reference's.
* The engine under churn (the fp32 linear engine): at lr = 0 bitwise the
  reference's superstep and event oracles (every remaining operation is
  the exchange layer), at lr > 0 within 2e-5, join copies bitwise and the
  other nodes of a join bin untouched.
* The cost model prices a churn trace as the reference does, and both
  drivers log the same join records and sched line.
"""
import argparse
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sched as J
import repro_torch.sched as T
from repro.configs import get_config as jget_config, reduced as jreduced
from repro.core import SwarmConfig as JSwarmConfig
from repro.core import SwarmState as JSwarmState
from repro.core import make_join_step as jmake_join_step
from repro.core import retire_nodes as jretire_nodes
from repro.core import swarm_init as jswarm_init
from repro.core.graph import make_graph as jmake_graph
from repro.core.simulator import run_events_oracle, run_superstep_oracle
from repro_torch.core import simulator as TSIM
from repro.launch import train as jtrain
from repro.models import init_params as jinit_params
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch.core import (
    SwarmConfig, SwarmState, make_join_step, make_swarm_step, retire_nodes,
)
from repro_torch.core.graph import make_graph
from repro_torch.kernels import ops
from repro_torch.launch import train as ttrain
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import make_optimizer
from repro_torch.tree import tree_leaves

N, D, H_MEAN, H_MAX, B = 8, 12, 2, 4, 4
LR = 0.05
AVAIL_SPEC = "day_night:period=8,duty=0.6,join=0.25:2:6,leave=0.25:10:20,seed=3"
SPECS = (AVAIL_SPEC,
         "day_night:period=4,duty=0.75,join=0.25:0.1:0.5,leave=0.25:0.6:1.2",
         "day_night:period=7.3,duty=0.5",
         "day_night:duty=1,join=0.5:0:3,leave=0.125:1:2,seed=9",
         "day_night:period=2,duty=0.9,leave=0.5:1:4")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Small tensors: more intra-op threads than this only contend with
    the other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# availability models
# ---------------------------------------------------------------------------


def _assert_avail_equal(a, b, probe):
    assert a.state_dict() == b.state_dict()
    for i in range(a.n):
        assert a.duty_cycle(i) == b.duty_cycle(i)
        for t in probe:
            assert a.window_up(i, t) == b.window_up(i, t), (i, t)
        for t0, t1 in zip(probe[:-3], probe[3:]):
            assert a.uptime(i, t0, t1) == b.uptime(i, t0, t1), (i, t0, t1)


def test_day_night_models_equal_the_reference():
    probe = np.linspace(0.0, 40.0, 53)
    for spec in SPECS:
        for n, seed in ((8, 0), (8, 5), (17, 3)):
            a = T.parse_avail(spec, n, seed)
            b = J.parse_avail(spec, n, seed)
            _assert_avail_equal(a, b, probe)
            # a state either package writes rebuilds in the other
            _assert_avail_equal(
                T.AvailabilityModel.from_state(
                    json.loads(json.dumps(b.state_dict()))), b, probe)
            _assert_avail_equal(
                J.AvailabilityModel.from_state(
                    json.loads(json.dumps(a.state_dict()))), a, probe)


def test_trace_file_model_equals_the_reference(tmp_path):
    p = tmp_path / "avail.txt"
    p.write_text("# device uptime windows\n"
                 "0 0 inf\n1 0 inf\n"
                 "2 0 5.25\n2 7.5 inf\n"
                 "3 2.75 9.0\n3 12.0 20.5\n")
    a = T.parse_avail(f"trace:{p}", 4, seed=0)
    b = J.parse_avail(f"trace:{p}", 4, seed=0)
    _assert_avail_equal(a, b, np.linspace(0.0, 30.0, 61))
    p.unlink()        # a resume reads the state, never the file
    _assert_avail_equal(T.AvailabilityModel.from_state(b.state_dict()), a,
                        np.linspace(0.0, 30.0, 61))


MALFORMED = [
    "0 0\n", "x 0 5\n", "9 0 5\n", "0 five 6\n", "0 5 5\n", "0 -1 5\n",
    "0 0 10\n0 5 15\n1 0 inf\n2 0 inf\n3 0 inf\n", "0 0 inf\n1 0 inf\n"]
BAD_SPECS = ["day_night", "tide:period=3", "day_night:duty=0",
             "day_night:period=-1", "day_night:frobnicate=1",
             "day_night:join=0.5:9:3", "day_night:join=2:0:1",
             "day_night:join=0.5:1", "day_night:leave=a:1:2",
             "day_night:period=8,duty=0.5,leave=0.99:1:2,seed=0",
             "day_night:period", "trace:/nonexistent/avail.txt"]


def test_bad_specs_raise_the_reference_messages(tmp_path):
    cases = list(BAD_SPECS)
    for k, content in enumerate(MALFORMED):
        p = tmp_path / f"bad{k}.txt"
        p.write_text(content)
        cases.append(f"trace:{p}")
    for spec in cases:
        with pytest.raises(ValueError) as e1:
            T.parse_avail(spec, 4 if spec.startswith("trace") else 8, 0)
        with pytest.raises(ValueError) as e2:
            J.parse_avail(spec, 4 if spec.startswith("trace") else 8, 0)
        assert str(e1.value) == str(e2.value), spec


# ---------------------------------------------------------------------------
# churn traces and schedules
# ---------------------------------------------------------------------------


def _churn(pkg, spec=AVAIL_SPEC, n_events=60, seed=13, profile="lognormal",
           straggler=(0.0, 10.0, 0.0, 0.0), avail_seed=0):
    S = T if pkg == "port" else J
    g = (make_graph if pkg == "port" else jmake_graph)("complete", N)
    av = S.parse_avail(spec, N, seed=avail_seed)
    prof = S.RateProfile(profile, sigma=0.8)
    clocks = S.PoissonClocks(g, prof.make_rates(N, seed), seed,
                             S.StragglerConfig(*straggler), avail=av)
    tr = S.generate_trace(g, prof, n_events, H=H_MEAN, h_max=H_MAX,
                          h_mode="rate", seed=seed, clocks=clocks)
    return tr, S.bin_trace(tr), clocks


def _assert_trace_equal(a, b):
    for f in ("times", "pairs", "h", "rates", "kinds", "alive"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    assert json.dumps(a.meta) == json.dumps(b.meta)


def _assert_bins_equal(a, b):
    for f in ("perms", "h", "mask", "event_bin", "kinds", "alive", "retire"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, f)


@pytest.mark.parametrize("spec", SPECS)
def test_churn_traces_and_bins_equal_the_reference(spec):
    for seed in (0, 13):
        for profile in ("uniform", "lognormal"):
            for straggler in ((0.0, 10.0, 0.0, 0.0), (0.25, 4.0, 0.1, 1.0)):
                kw = dict(spec=spec, seed=seed, profile=profile,
                          straggler=straggler)
                ta, sa, ca = _churn("port", **kw)
                tb, sb, cb = _churn("jax", **kw)
                _assert_trace_equal(ta, tb)
                _assert_bins_equal(sa, sb)
                assert ca.state_dict() == cb.state_dict()
                np.testing.assert_array_equal(ca.member_mask(),
                                              cb.member_mask())
                assert T.trace_stats(ta) == J.trace_stats(tb)


def test_fixture_exercises_churn():
    """Guard: the canonical spec produces joins and leaves, so the engine
    tests below are not fixed-membership runs."""
    tr, sched, _ = _churn("port")
    assert tr.meta["n_joins"] > 0 and tr.meta["n_leaves"] > 0
    assert int(np.sum(sched.kinds == T.EVENT_JOIN)) == tr.meta["n_joins"]
    assert sched.retire.sum() == tr.meta["n_leaves"]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_mid_churn_resume_across_packages(direction):
    """The port of the reference's mid-churn resume: 30 events, the clock
    state (membership, pending joins, queued events) and the availability
    state through JSON into the other package, 30 more events — equal to
    the unbroken 60-event trace, kinds and alive sets included."""
    src, dst = ("jax", "port") if direction == "jax_to_port" \
        else ("port", "jax")
    full, _, _ = _churn(src)
    head, _, c1 = _churn(src, n_events=30)
    S = T if dst == "port" else J
    g = (make_graph if dst == "port" else jmake_graph)("complete", N)
    state = json.loads(json.dumps(c1.state_dict()))
    av = S.AvailabilityModel.from_state(
        json.loads(json.dumps(c1.avail.state_dict())))
    prof = S.RateProfile("lognormal", sigma=0.8)
    c2 = S.PoissonClocks.from_state(state, g, prof.make_rates(N, 13), 13,
                                    avail=av)
    tail = S.generate_trace(g, prof, 30, H=H_MEAN, h_max=H_MAX,
                            h_mode="rate", seed=13, clocks=c2,
                            last_t=np.asarray(head.meta["last_t"]))
    for f in ("times", "pairs", "h", "kinds", "alive"):
        np.testing.assert_array_equal(
            getattr(full, f),
            np.concatenate([getattr(head, f), getattr(tail, f)]), f)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_driver_sched_meta_carries_avail_across_drivers(writer):
    """The port of the reference's driver round trip with churn:
    sched_checkpoint_meta embeds the availability state, and the other
    driver's restore_sched_clocks continues the exact event sequence."""
    args = argparse.Namespace(rate_profile="lognormal", rate_sigma=0.8,
                              trace_seed=None, seed=13, straggler=None,
                              nodes=N, avail=AVAIL_SPEC)
    tr1, _, clocks = _churn(writer, avail_seed=13, n_events=25)
    meta = json.loads(json.dumps(
        (jtrain if writer == "jax" else ttrain).sched_checkpoint_meta(
            args, tr1, clocks)))
    other = "port" if writer == "jax" else "jax"
    assert meta == json.loads(json.dumps(
        (ttrain if writer == "jax" else jtrain).sched_checkpoint_meta(
            args, tr1, clocks)))
    assert meta["avail"] is not None
    g = (make_graph if other == "port" else jmake_graph)("complete", N)
    clocks2, last_t, rng = (ttrain if other == "port" else jtrain
                            ).restore_sched_clocks(meta, g)
    assert rng is None and clocks2.avail is not None
    S = T if other == "port" else J
    cont = S.generate_trace(g, S.RateProfile("lognormal", sigma=0.8), 25,
                            H=H_MEAN, h_max=H_MAX, h_mode="rate", seed=13,
                            clocks=clocks2, last_t=last_t)
    full, _, _ = _churn(writer, avail_seed=13, n_events=50)
    for f in ("times", "pairs", "h", "kinds", "alive"):
        np.testing.assert_array_equal(getattr(full, f)[25:],
                                      getattr(cont, f), f)


def test_cost_model_prices_churn_as_the_reference():
    ta, _, _ = _churn("port")
    tb, _, _ = _churn("jax")
    kw = dict(flops_per_step=1e9, hbm_bytes_per_step=1e7,
              payload_bytes=10**6, peak_flops=1e12, hbm_bw=1e11,
              link_bw=4e10)
    tcp, jcp = T.CostParams(**kw), J.CostParams(**kw)
    for mode in ("blocking", "nonblocking", "overlap"):
        a = T.predict_walltime(ta, tcp, mode=mode)
        assert json.dumps(a) == json.dumps(J.predict_walltime(tb, jcp,
                                                              mode=mode))
        assert a["n_joins"] > 0 and a["n_leaves"] > 0
        assert T.analytic_walltime(ta, tcp, mode=mode) == \
            J.analytic_walltime(tb, jcp, mode=mode)
    assert json.dumps(T.predict_all_modes(ta, tcp)) == \
        json.dumps(J.predict_all_modes(tb, jcp))


# ---------------------------------------------------------------------------
# the join step and retirement
# ---------------------------------------------------------------------------


def _jax_model_state(quantize, n=N):
    jcfg = jreduced(jget_config("transformer-wmt"), n_layers=2, d_model=64)
    jscfg = JSwarmConfig(n_nodes=n, H=2, quantize=quantize, codec=None,
                         gossip_impl="gather", track_potential=False)
    jopt = jmake_optimizer("sgd", lr=LR, momentum=0.9)
    st = jswarm_init(jax.random.PRNGKey(0), jscfg,
                     lambda k: jinit_params(k, jcfg), jopt.init,
                     same_init=False)
    if quantize:
        # a comm copy that differs from the model, as after local steps
        st = JSwarmState(st.params, st.opt,
                         jax.tree.map(lambda x: x * 0.5, st.params),
                         st.step)
    return jscfg, st


def _to_port(jstate, residual=None):
    params, opt, prev = (params_from_numpy(jax.device_get(x), "cpu")
                         if x is not None else None
                         for x in (jstate.params, jstate.opt, jstate.prev))
    return SwarmState(params, opt, prev, int(jstate.step), None, residual)


def _same(port_tree, jax_tree):
    a = tree_leaves(port_tree)
    b = jax.tree.leaves(jax.device_get(jax_tree))
    return len(a) == len(b) and all(
        np.array_equal(x.numpy(), np.asarray(y)) for x, y in zip(a, b))


@pytest.mark.parametrize("quantize", [False, True], ids=["exact", "q8"])
def test_join_step_is_the_reference_bitwise(quantize):
    """Node 2 joins from donor 5 (and, in a second bin, node 6 from 1):
    params bitwise JAX's make_join_step, the joiner's comm copy re-based
    to its new model and every other node untouched, bitwise."""
    jscfg, jst = _jax_model_state(quantize)
    scfg = SwarmConfig(n_nodes=N, H=2, quantize=quantize)
    join, jjoin = make_join_step(scfg), jax.jit(jmake_join_step(jscfg))
    tst = _to_port(jst)
    for joiner, donor in ((2, 5), (6, 1)):
        perm = np.arange(N, dtype=np.int32)
        perm[joiner], perm[donor] = donor, joiner
        mask = np.zeros(N, bool)
        mask[joiner] = True
        before = tst
        tst = join(tst, perm, mask)
        jst = jjoin(jst, jnp.asarray(perm), jnp.asarray(mask))
        assert _same(tst.params, jst.params)
        assert _same(tst.opt, jst.opt)
        assert (tst.prev is None) == (jst.prev is None)
        if tst.prev is not None:
            assert _same(tst.prev, jst.prev)
        assert tst.step == int(jst.step) == before.step + 1
        for a, b in zip(tree_leaves(tst.params), tree_leaves(before.params)):
            assert torch.equal(a[joiner], b[donor])
            keep = np.ones(N, bool)
            keep[joiner] = False
            assert torch.equal(a[keep], b[keep])


def test_join_step_zeroes_the_joiners_residual_as_the_reference():
    jscfg, jst = _jax_model_state(False)
    from repro.core import bucket as JB
    n_padded = JB.build_layout(jst.params).n_padded
    res = np.random.default_rng(1).normal(size=(N, n_padded)).astype(
        np.float32)
    jst = JSwarmState(jst.params, jst.opt, jst.prev, jst.step, None,
                      jnp.asarray(res))
    tst = _to_port(jst, torch.from_numpy(res.copy()))
    perm = np.arange(N, dtype=np.int32)
    perm[3], perm[0] = 0, 3
    mask = np.zeros(N, bool)
    mask[3] = True
    out = make_join_step(SwarmConfig(n_nodes=N))(tst, perm, mask)
    jout = jmake_join_step(jscfg)(jst, jnp.asarray(perm), jnp.asarray(mask))
    np.testing.assert_array_equal(out.residual.numpy(),
                                  np.asarray(jout.residual))
    left = np.zeros(N, bool)
    left[[1, 6]] = True
    np.testing.assert_array_equal(
        retire_nodes(out, left).residual.numpy(),
        np.asarray(jretire_nodes(jout, jnp.asarray(left)).residual))


def test_join_step_takes_no_batch_and_runs_no_codec(monkeypatch):
    """A join bin is not a gossip superstep: no encode, no decode, no
    optimizer sweep (each plain kernel entry point raises if reached),
    and no generator."""
    def boom(*a, **kw):
        raise AssertionError("a kernel ran in the join step")
    import repro_torch.kernels as kernels
    for name in ("quantize_mod", "decode_avg", "sgd_fused_update"):
        monkeypatch.setattr(ops, name, boom)
        monkeypatch.setattr(kernels, name, boom)
    _, jst = _jax_model_state(True)
    tst = _to_port(jst)
    perm = np.asarray([1, 0, 2, 3, 4, 5, 6, 7], np.int32)
    mask = np.asarray([True] + [False] * 7)
    launches = dict(ops.LAUNCHES)
    out = make_join_step(SwarmConfig(n_nodes=N, quantize=True))(tst, perm,
                                                                mask)
    assert dict(ops.LAUNCHES) == launches
    assert out.step == tst.step + 1


def test_join_step_and_retire_refuse_as_the_reference():
    cfg = SwarmConfig(n_nodes=N, nonblocking=True, overlap=True)
    jcfg = JSwarmConfig(n_nodes=N, nonblocking=True, overlap=True,
                        gossip_impl="gather")
    with pytest.raises(AssertionError) as e1:
        make_join_step(cfg)
    with pytest.raises(AssertionError) as e2:
        jmake_join_step(jcfg)
    assert str(e1.value) == str(e2.value)
    jcs = JSwarmConfig(n_nodes=N, quantize=True, compress_state=True,
                       gossip_impl="gather")
    with pytest.raises(AssertionError) as e3:
        jmake_join_step(jcs)
    _, jst = _jax_model_state(True)
    tst = _to_port(jst)
    wire = SwarmState(tst.params, tst.opt, (torch.zeros(1), torch.zeros(1)),
                      0)
    with pytest.raises(AssertionError) as e4:
        make_join_step(SwarmConfig(n_nodes=N, quantize=True))(
            wire, np.arange(N), np.zeros(N, bool))
    assert str(e3.value) == str(e4.value)
    # retiring without a residual leaves the state as it is
    assert retire_nodes(tst, np.ones(N, bool)) is tst


# ---------------------------------------------------------------------------
# the engine under churn, against the reference's oracles
# ---------------------------------------------------------------------------


def _data(S, seed=21):
    r = np.random.default_rng(seed)
    X = r.normal(size=(S, N, H_MAX, B, D)).astype(np.float32)
    Y = r.normal(size=(S, N, H_MAX, B)).astype(np.float32)
    return X, Y


def _grad_fn(X, Y):
    def grad(w, i, t, q):
        x, y = X[t, i, q], Y[t, i, q]
        return x.T @ ((x @ w - y) / np.float32(B))
    return grad


def _tlin_loss(p, mb):
    return 0.5 * torch.mean((mb["x"] @ p["w"] - mb["y"]) ** 2)


def _run_port_churn(sched, X, Y, x0, nonblocking, lr):
    """The driver's churn loop on the linear engine: retire before the
    bin, the join bootstrap on a join bin, else a masked superstep."""
    scfg = SwarmConfig(n_nodes=N, H=H_MEAN, h_mode="trace", h_max=H_MAX,
                       nonblocking=nonblocking, track_potential=False)
    opt = make_optimizer("sgd", lr=lr, momentum=0.0)
    step = make_swarm_step(scfg, _tlin_loss, opt.update, lambda s: lr)
    join = make_join_step(scfg)
    params = {"w": torch.from_numpy(x0.copy())}
    state = SwarmState(params, opt.init(params),
                       {"w": params["w"].clone()} if nonblocking else None,
                       0)
    traj = []
    for s in range(sched.n_supersteps):
        if sched.retire[s].any():
            state = retire_nodes(state, sched.retire[s])
        if sched.kinds[s] == T.EVENT_JOIN:
            state = join(state, sched.perms[s], sched.mask[s])
        else:
            state, _ = step(state, {"x": torch.from_numpy(X[s]),
                                    "y": torch.from_numpy(Y[s])},
                            sched.perms[s], sched.h[s], None, sched.mask[s])
        traj.append(state.params["w"].numpy().copy())
    return np.stack(traj)


def _x0():
    return (np.random.default_rng(3).normal(size=(N, D)) * 0.3).astype(
        np.float32)


@pytest.mark.parametrize("nonblocking", [False, True],
                         ids=["blocking", "nonblocking"])
def test_churn_exchange_layer_bitwise_at_lr0(nonblocking):
    """The port of the reference's lr = 0 proof: local steps are exact
    no-ops, so every remaining operation is the churn exchange layer —
    averaging chains, the packed join bootstrap, masking, retirement —
    and it equals the binned and the sequential oracle bit for bit."""
    tr, sched, _ = _churn("port")
    X, Y = _data(sched.n_supersteps)
    traj = _run_port_churn(sched, X, Y, _x0(), nonblocking, 0.0)
    binned = run_superstep_oracle(
        _x0(), _grad_fn(X, Y), sched.perms, H_MEAN, 0.0,
        nonblocking=nonblocking, h_schedule=sched.h, masks=sched.mask,
        kinds=sched.kinds)
    seq = run_events_oracle(_x0(), _grad_fn(X, Y), tr.pairs, tr.h,
                            sched.event_bin, 0.0, nonblocking=nonblocking,
                            kinds=tr.kinds)
    # the port's own copy of the oracles is the reference's, bitwise
    np.testing.assert_array_equal(TSIM.run_superstep_oracle(
        _x0(), _grad_fn(X, Y), sched.perms, H_MEAN, 0.0,
        nonblocking=nonblocking, h_schedule=sched.h, masks=sched.mask,
        kinds=sched.kinds), binned)
    np.testing.assert_array_equal(TSIM.run_events_oracle(
        _x0(), _grad_fn(X, Y), tr.pairs, tr.h, sched.event_bin, 0.0,
        nonblocking=nonblocking, kinds=tr.kinds), seq)
    np.testing.assert_array_equal(traj, binned)
    np.testing.assert_array_equal(traj[-1], seq[-1])


@pytest.mark.parametrize("nonblocking", [False, True],
                         ids=["blocking", "nonblocking"])
def test_churn_engine_matches_the_oracle(nonblocking):
    """Live gradients: within 2e-5 of the binned oracle over the whole
    churn run; each join bin's joiner equals its donor's model before the
    bin and every other node is untouched, bitwise; a retired node's
    model stays frozen."""
    _, sched, _ = _churn("port")
    X, Y = _data(sched.n_supersteps)
    x0 = _x0()
    traj = _run_port_churn(sched, X, Y, x0, nonblocking, LR)
    ref = run_superstep_oracle(
        x0, _grad_fn(X, Y), sched.perms, H_MEAN, LR, nonblocking=nonblocking,
        h_schedule=sched.h, masks=sched.mask, kinds=sched.kinds)
    np.testing.assert_allclose(traj, ref, rtol=0, atol=2e-5)
    joins = np.nonzero(sched.kinds == T.EVENT_JOIN)[0]
    assert len(joins)
    for s in joins:
        joiner = int(np.nonzero(sched.mask[s])[0][0])
        donor = int(sched.perms[s][joiner])
        before = traj[s - 1] if s > 0 else x0
        np.testing.assert_array_equal(traj[s][joiner], before[donor])
        others = np.arange(N) != joiner
        np.testing.assert_array_equal(traj[s][others], before[others])
    S = sched.n_supersteps
    for s_eff in range(1, S):
        for i in np.nonzero(sched.retire[s_eff])[0]:
            for s in range(s_eff, S):
                np.testing.assert_array_equal(traj[s][i], traj[s_eff - 1][i])


# ---------------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------------

CHURN_ARGV = ["--arch", "transformer-wmt", "--reduced", "--layers", "1",
              "--d-model", "32", "--nodes", "8", "--steps", "3", "--seq",
              "16", "--log-every", "1", "--rate-profile", "uniform_async",
              "--avail", SPECS[1]]


@pytest.mark.parametrize("quantize", [False, True], ids=["exact", "q8"])
def test_drivers_log_the_same_churn_run(quantize, capsys, monkeypatch,
                                        tmp_path):
    """Both drivers with --avail: the same sched line, the same join
    records (bin, joiner, donor) and logged steps; the port's checkpoint
    carries the availability state in the reference's format."""
    from repro_torch.checkpoint import load_metadata
    argv = CHURN_ARGV + (["--quantize"] if quantize else [])
    for var in ("REPRO_AVAIL_PROFILE", "REPRO_RATE_PROFILE", "REPRO_CODEC",
                "REPRO_SCAN_CHUNK", "REPRO_TOPOLOGY",
                "REPRO_DEFAULT_GOSSIP_IMPL"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    capsys.readouterr()
    jtrain.main()
    jl = [json.loads(x) for x in capsys.readouterr().out.splitlines()
          if x.startswith("{")]
    ttrain.main(argv + ["--device", "cpu", "--ckpt", str(tmp_path / "ck")])
    tl = [json.loads(x) for x in capsys.readouterr().out.splitlines()
          if x.startswith("{")]
    assert [x for x in tl if "sched" in x] == [x for x in jl if "sched" in x]

    def joins(lines):
        return [(x["step"], x["joiner"], x["donor"]) for x in lines
                if x.get("event") == "join"]
    assert joins(tl) == joins(jl) and joins(tl)
    assert [x["step"] for x in tl if "loss" in x] == \
        [x["step"] for x in jl if "loss" in x]
    assert all(np.isfinite(x["loss"]) for x in tl if "loss" in x)
    meta = load_metadata(str(tmp_path / "ck"))["sched"]
    assert meta["avail"]["spec"] == SPECS[1]
    assert meta["avail"] == json.loads(json.dumps(
        J.parse_avail(SPECS[1], N, 0).state_dict()))


def test_driver_refuses_avail_without_async_clocks(capsys):
    for profile in ("none", "uniform"):
        with pytest.raises(SystemExit) as e:
            ttrain.main(CHURN_ARGV[:-4] + ["--rate-profile", profile,
                                           "--avail", SPECS[1], "--device",
                                           "cpu"])
        assert e.value.code == 2
        assert "asynchronous Poisson clocks" in capsys.readouterr().err
    args = ttrain.build_parser().parse_args(CHURN_ARGV)
    args.rate_profile = "uniform"
    with pytest.raises(ValueError, match="asynchronous Poisson clocks"):
        ttrain.build_schedule(args, make_graph("complete", 8),
                              SwarmConfig(n_nodes=8))
