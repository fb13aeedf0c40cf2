"""The port's chunked superstep driver (``repro_torch/core/scan.py``,
``--scan-chunk``) on the CPU, where each chunk runs the graph-safe body
eagerly (on the card the same body is captured as CUDA graphs;
``chip_smoke.py`` phase ``scan_bitwise`` holds replay to the eager driver
there).

* Chunked == per-step, bitwise, on the final state (params, momentum, comm
  copy, residual, in-flight payload) and on every superstep's metrics,
  chunked unevenly (4 + 2), over JAX's ``COMBOS``
  (``tests/test_scan_driver.py``) minus the ppermute transports —
  blocking / non-blocking fp32, blocking q8, non-blocking q4, non-blocking
  top-k 0.25, overlapped q8 — plus compress_state q8, a masked
  lognormal + straggler schedule with per-node h, and each of the five
  baselines.
* A chunk boundary is an exact resume point, and a checkpoint written
  there (with the encode generator's state) restores it bit-exactly.
* One exact blocking run of the port's chunk is within 2e-5 of JAX's
  ``make_superstep_scan``.
* The driver: ``--scan-chunk 4`` logs the per-step driver's records and
  writes its checkpoints at the chunk boundaries, bitwise the per-step
  driver's at the same step; ``--avail`` with ``--scan-chunk`` exits 2.
* The graph keys (the host values a captured superstep depends on) and the
  launch bookkeeping of graph replays.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SwarmConfig as JSwarmConfig
from repro.core import make_superstep_scan as jmake_superstep_scan
from repro.core import make_swarm_step as jmake_swarm_step
from repro.core import swarm_init as jswarm_init
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch.algorithms import make_algorithm
from repro_torch.algorithms.sgp import sgp_init_state
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.core import (SwarmConfig, SwarmState, make_graph,
                              make_superstep_scan, make_swarm_step,
                              sample_matching, swarm_init)
from repro_torch.core.exchange import (GossipTransport, local_signature,
                                       transport_from_config)
from repro_torch.core.scan import _state_leaves, _write_back
from repro_torch.core.swarm import codec_checkpoint_tree, restore_codec_state
from repro_torch.kernels import ops
from repro_torch.launch import train as ttrain
from repro_torch.optim import make_optimizer
from repro_torch.quant.schemes import ModularQuantConfig

N, D, H, B, T = 8, 12, 2, 4, 6
LR = 0.05
QCFG = ModularQuantConfig(safety=16.0)


def _data(S, seed=42, h_slots=H):
    r = np.random.default_rng(seed)
    X = r.normal(size=(S, N, h_slots, B, D)).astype(np.float32)
    Y = r.normal(size=(S, N, h_slots, B)).astype(np.float32)
    return X, Y


def _loss(p, mb):
    return 0.5 * torch.mean((mb["x"] @ p["w"] - mb["y"]) ** 2)


def _init(gen):
    return {"w": torch.randn((D,), generator=gen) * 0.3}


def _inputs(S, seed=123, h=H):
    g = make_graph("complete", N)
    r = np.random.default_rng(seed)
    perms = np.stack([sample_matching(g, r) for _ in range(S)])
    return perms, np.full((S, N), h, np.int32)


def _engine(algo="swarm", momentum=0.9, **kw):
    """(step, state, h_slots): a fresh engine from seed 0."""
    opt = make_optimizer("sgd", lr=LR, momentum=momentum)
    quantize = kw.get("quantize", False)
    if algo == "swarm":
        scfg = SwarmConfig(n_nodes=N, H=kw.pop("H", H), quant=QCFG, **kw)
        step = make_swarm_step(scfg, _loss, opt.update, lambda s: LR)
    else:
        h_slots = H if algo == "localsgd" else 1
        scfg = SwarmConfig(n_nodes=N, H=h_slots, quantize=quantize,
                           quant=QCFG)
        akw = dict(loss_fn=_loss, opt_update=opt.update,
                   lr_fn=lambda s: LR, n_nodes=N,
                   transport=transport_from_config(scfg))
        if algo == "localsgd":
            akw["H"] = H
        if algo == "dpsgd":
            akw["graph"] = make_graph("ring", N)
        if algo in ("adpsgd", "sgp"):
            akw["quantize"] = quantize
        if algo == "adpsgd":
            akw["nonblocking"] = kw.get("nonblocking", False)
        step = make_algorithm(algo, **akw)
    gen = torch.Generator()
    gen.manual_seed(0)
    state = swarm_init(gen, scfg, _init, opt.init)
    if algo == "sgp":
        state = sgp_init_state(state, N, quantize)
    return step, state, scfg.h_loop_bound


def _per_step(step, state, X, Y, perms, hs, masks=None, seed=7):
    gen = torch.Generator()
    gen.manual_seed(seed)
    ms = []
    for t in range(len(perms)):
        state, m = step(state, {"x": torch.from_numpy(X[t]),
                                "y": torch.from_numpy(Y[t])},
                        perms[t], hs[t], gen,
                        None if masks is None else masks[t])
        ms.append({k: v.clone() for k, v in m.items()})
    return state, {k: torch.stack([m[k] for m in ms]) for k in ms[0]}, gen


def _chunked(step, state, X, Y, perms, hs, masks=None, chunks=(4, 2),
             seed=7, gen=None):
    if gen is None:
        gen = torch.Generator()
        gen.manual_seed(seed)
    chunk = make_superstep_scan(step, with_mask=masks is not None)
    t, out = 0, []
    for k in chunks:
        state, ms = chunk(state, gen, {"x": torch.from_numpy(X[t:t + k]),
                                       "y": torch.from_numpy(Y[t:t + k])},
                          perms[t:t + k], hs[t:t + k],
                          None if masks is None else masks[t:t + k])
        out.append(ms)
        t += k
    assert t == len(perms)
    return state, {k: torch.cat([m[k] for m in out]) for k in out[0]}, gen


def _bitwise(a, b):
    la, lb = _state_leaves(a), _state_leaves(b)
    assert len(la) == len(lb) > 0
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(
            x.view(torch.int16) if x.dtype == torch.uint16 else x,
            y.view(torch.int16) if y.dtype == torch.uint16 else y)
    assert a.step == b.step


COMBOS = [
    ("blocking_fp32", "swarm", dict()),
    ("nonblocking_fp32", "swarm", dict(nonblocking=True)),
    ("blocking_q8", "swarm", dict(quantize=True)),
    ("nonblocking_q4", "swarm", dict(nonblocking=True, quantize=True,
                                     codec="q4")),
    ("nonblocking_topk", "swarm", dict(nonblocking=True, quantize=True,
                                       codec="topk:0.25")),
    ("overlap_q8", "swarm", dict(nonblocking=True, overlap=True,
                                 quantize=True)),
    ("compress_state_q8", "swarm", dict(quantize=True, compress_state=True)),
    ("geometric_q8", "swarm", dict(quantize=True, h_mode="geometric",
                                   h_max=4)),
    ("allreduce", "allreduce", dict()),
    ("localsgd", "localsgd", dict()),
    ("dpsgd", "dpsgd", dict()),
    ("adpsgd_q8_nonblocking", "adpsgd", dict(quantize=True,
                                             nonblocking=True)),
    ("sgp_q8", "sgp", dict(quantize=True)),
]


@pytest.mark.parametrize("name,algo,kw", COMBOS, ids=[c[0] for c in COMBOS])
def test_chunked_bitwise_per_step(name, algo, kw):
    step, state, h_slots = _engine(algo, **dict(kw))
    X, Y = _data(T, h_slots=h_slots)
    perms, hs = _inputs(T, h=h_slots)
    if name == "geometric_q8":
        hs = np.random.default_rng(4).integers(1, 5, (T, N)).astype(np.int32)
    ref, ref_ms, _ = _per_step(step, state, X, Y, perms, hs)
    step2, state2, _ = _engine(algo, **dict(kw))
    got, got_ms, _ = _chunked(step2, state2, X, Y, perms, hs)
    _bitwise(ref, got)
    assert set(ref_ms) == set(got_ms)
    for k in ref_ms:
        assert torch.equal(ref_ms[k], got_ms[k]), k


def test_chunked_bitwise_masked_schedule():
    """A lognormal + straggler trace binned into masked supersteps with
    per-node h (the bridge's counts, 0 at idle nodes): non-blocking q8,
    chunked 4 + rest, bitwise the per-step driver."""
    from repro_torch.sched import (RateProfile, StragglerConfig, bin_trace,
                                   generate_trace)
    g = make_graph("complete", N)
    h_max = 4
    tr = generate_trace(g, RateProfile("lognormal", sigma=0.8), 40, H=H,
                        h_max=h_max, h_mode="rate", seed=13,
                        straggler=StragglerConfig(fraction=0.25,
                                                  slowdown=8.0))
    sched = bin_trace(tr)
    S = sched.n_supersteps
    assert S >= 6 and not sched.mask.all()
    X, Y = _data(S, seed=21, h_slots=h_max)
    kw = dict(h_mode="trace", h_max=h_max, nonblocking=True, quantize=True)
    step, state, _ = _engine("swarm", **kw)
    ref, ref_ms, _ = _per_step(step, state, X, Y, sched.perms, sched.h,
                               masks=sched.mask)
    step2, state2, _ = _engine("swarm", **kw)
    got, got_ms, _ = _chunked(step2, state2, X, Y, sched.perms, sched.h,
                              masks=sched.mask, chunks=(4, S - 4))
    _bitwise(ref, got)
    for k in ref_ms:
        assert torch.equal(ref_ms[k], got_ms[k]), k


@pytest.mark.parametrize("kw", [dict(quantize=True),
                                dict(quantize=True, nonblocking=True,
                                     codec="topk:0.25"),
                                dict(quantize=True, compress_state=True)],
                         ids=["q8", "topk", "compress_state"])
def test_chunk_boundary_resume_and_checkpoint(kw, tmp_path):
    """Chunk 4, checkpoint the codec state and the encode generator at
    the boundary, restore into a fresh engine and run the last 2: the
    uninterrupted per-step run's state, bitwise."""
    X, Y = _data(T)
    perms, hs = _inputs(T)
    step, state, _ = _engine(**dict(kw))
    ref, _, _ = _per_step(step, state, X, Y, perms, hs)
    step1, state1, _ = _engine(**dict(kw))
    gen = torch.Generator()
    gen.manual_seed(7)
    mid, _, gen = _chunked(step1, state1, X[:4], Y[:4], perms[:4], hs[:4],
                           chunks=(4,), gen=gen)
    save_checkpoint(str(tmp_path / "ck"), {
        **codec_checkpoint_tree(mid), "opt": mid.opt}, {"step": mid.step})
    gen_state = gen.get_state()
    step2, fresh, _ = _engine(**dict(kw))
    like = {**codec_checkpoint_tree(fresh), "opt": fresh.opt}
    back = load_checkpoint(str(tmp_path / "ck"), like)
    resumed = restore_codec_state(fresh, back)
    resumed = SwarmState(resumed.params, back["opt"], resumed.prev, 4,
                         resumed.inflight, resumed.residual)
    gen2 = torch.Generator()
    gen2.set_state(gen_state)
    got, _, _ = _chunked(step2, resumed, X[4:], Y[4:], perms[4:], hs[4:],
                         chunks=(2,), gen=gen2)
    _bitwise(ref, got)


def test_exact_chunk_matches_jax_scan():
    """Blocking exact: the port's chunks (4 + 2) within 2e-5 of JAX's
    make_superstep_scan from JAX's initial models."""
    X, Y = _data(T)
    perms, hs = _inputs(T)
    jscfg = JSwarmConfig(n_nodes=N, H=H, gossip_impl="gather",
                         track_potential=False)
    jopt = jmake_optimizer("sgd", lr=LR, momentum=0.9)
    jstate = jswarm_init(jax.random.PRNGKey(0), jscfg,
                         lambda k: {"w": jax.random.normal(k, (D,)) * 0.3},
                         jopt.init, same_init=False)
    w0 = np.asarray(jstate.params["w"])

    def jloss(p, mb):
        x, y = mb
        return 0.5 * jnp.mean((x @ p["w"] - y) ** 2)
    chunk = jmake_superstep_scan(
        jmake_swarm_step(jscfg, jloss, jopt.update, lambda s: LR),
        donate=False)
    key, t, jl = jax.random.PRNGKey(7), 0, []
    for k in (4, 2):
        jstate, key, ms = chunk(jstate, key, (jnp.asarray(X[t:t + k]),
                                              jnp.asarray(Y[t:t + k])),
                                jnp.asarray(perms[t:t + k]),
                                jnp.asarray(hs[t:t + k]))
        jl += list(np.asarray(ms["loss"]))
        t += k
    opt = make_optimizer("sgd", lr=LR, momentum=0.9)
    step = make_swarm_step(SwarmConfig(n_nodes=N, H=H,
                                       track_potential=False),
                           _loss, opt.update, lambda s: LR)
    params = {"w": torch.from_numpy(np.array(w0))}
    state = SwarmState(params, opt.init(params), None, 0)
    got, ms, _ = _chunked(step, state, X, Y, perms, hs)
    np.testing.assert_allclose(got.params["w"].numpy(),
                               np.asarray(jstate.params["w"]), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(ms["loss"].numpy(), jl, rtol=1e-5)


DRIVER = ["--device", "cpu", "--reduced", "--layers", "1", "--d-model", "32",
          "--nodes", "4", "--steps", "6", "--seq", "16", "--log-every", "1"]


@pytest.mark.parametrize("flags", [
    ["--quantize"],
    ["--quantize", "--codec", "topk:0.25", "--nonblocking"],
    ["--quantize", "--compress-state", "--eval-mean"],
    ["--quantize", "--rate-profile", "lognormal", "--straggler", "0.25:8"]],
    ids=["q8", "topk", "compress-eval", "sched"])
def test_driver_scan_chunk_records_equal_per_step(flags, tmp_path, capsys):
    """--scan-chunk 4 logs the per-step driver's records (wall time
    aside; --eval-mean at chunk boundaries, equal to the per-step value
    at the same step) and its checkpoints at the boundaries hold the
    per-step run's state at that step, bitwise."""
    runs = {}
    for k in (0, 4):
        ck = tmp_path / f"ck{k}"
        recs = ttrain.main(DRIVER + flags + ["--scan-chunk", str(k),
                                             "--ckpt", str(ck),
                                             "--ckpt-every", "2"])
        runs[k] = ({r["step"]: r for r in recs if "loss" in r}, ck)
    per, ck0 = runs[0]
    chunked, ck4 = runs[4]
    assert sorted(chunked) == sorted(per)
    for s, r in chunked.items():
        for key, v in r.items():
            if key != "wall_s":
                assert v == per[s][key], (s, key)
    from repro_torch.checkpoint import load_metadata
    n = max(per) + 1
    names = sorted(p.stem for p in ck4.glob("*.npz"))
    want = sorted({f"step_{s:06d}" for s in range(4, n + 1, 4)}
                  | {f"step_{n:06d}"})
    assert names == want, names
    for name in names:
        meta = load_metadata(str(ck4 / name))
        assert meta == load_metadata(str(ck0 / name))
        a = np.load(str(ck4 / name) + ".npz")
        b = np.load(str(ck0 / name) + ".npz")
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            np.testing.assert_array_equal(a[f], b[f])


def test_driver_refuses_avail_with_scan_chunk():
    with pytest.raises(SystemExit) as e:
        ttrain.main(DRIVER + ["--quantize", "--rate-profile", "uniform_async",
                              "--avail", "day_night:period=4,duty=0.75",
                              "--scan-chunk", "2"])
    assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        ttrain.main(DRIVER + ["--scan-chunk", "-1"])
    assert e.value.code == 2


def test_graph_keys_name_the_host_control_flow():
    """One captured graph serves every superstep with the same key: the
    local-step loop's (min h, max h) bounded by h_max, nothing for the H=1
    baselines, and SGP's t mod log2 n."""
    assert local_signature((2, 2, 2), 2) == (2, 2)
    assert local_signature((0, 3, 9), 4) == (0, 4)
    step, state, _ = _engine(quantize=True, h_mode="geometric", h_max=4)
    assert step.graph_key(state, (1, 4, 2)) == (1, 4)
    ad, st, _ = _engine("adpsgd", quantize=True)
    assert ad.graph_key(st, (1,) * N) == ()
    sgp, st, _ = _engine("sgp", quantize=True)
    assert [sgp.graph_key(SwarmState(st.params, st.opt, st.prev, t), ())
            for t in range(4)] == [(0,), (1,), (2,), (0,)]


def test_write_back_and_replay_launch_bookkeeping():
    """The write-back copies the new state into the static tensors in
    place (a tensor the step passed through is left as it is) and refuses
    a changed structure; a chunk refuses a state other than the one it
    returned; a replay's launches add to the counters."""
    a, b = torch.zeros(3), torch.ones(3)
    static = SwarmState({"w": a}, {"m": b}, None, 0)
    new = SwarmState({"w": torch.full((3,), 2.0)}, {"m": b}, None, 1)
    _write_back(static, new)
    assert static.params["w"] is a and torch.equal(a, torch.full((3,), 2.0))
    assert static.opt["m"] is b
    with pytest.raises(ValueError, match="structure"):
        _write_back(static, SwarmState({"w": a}, {}, None, 1))
    step, state, _ = _engine()
    X, Y = _data(2)
    perms, hs = _inputs(2)
    chunk = make_superstep_scan(step)
    batch = {"x": torch.from_numpy(X), "y": torch.from_numpy(Y)}
    out, _ = chunk(state, None, batch, perms, hs)
    assert out.step == 2 and out.params["w"] is state.params["w"]
    _, other, _ = _engine()
    with pytest.raises(ValueError, match="returned"):
        chunk(other, None, batch, perms, hs)
    before = dict(ops.LAUNCHES)
    ops.add_launches({"sgd_update": 2, "quantize_mod": 1, "decode_avg": 1})
    assert ops.LAUNCHES["sgd_update"] == before["sgd_update"] + 2
    ops.LAUNCHES.update(before)


def test_chunk_refuses_a_plain_function_and_a_missing_mask():
    with pytest.raises(TypeError, match="EngineStep"):
        make_superstep_scan(lambda *a: None)
    step, state, _ = _engine()
    chunk = make_superstep_scan(step, with_mask=True)
    X, Y = _data(2)
    perms, hs = _inputs(2)
    with pytest.raises(ValueError, match="with_mask"):
        chunk(state, None, {"x": torch.from_numpy(X),
                            "y": torch.from_numpy(Y)}, perms, hs)
    GossipTransport(N)        # the chunk built nothing global
