"""The port's non-blocking superstep (Algorithm 2) and its overlapped
pipeline against the JAX package, on the fp32 linear engine of
``tests/test_async_pipeline.py``: 8 nodes, a least-squares loss, momentum
0, per-node initial models, seeded matchings and data.

* The port's trajectory (every node's weights after each superstep) is
  within 2e-5 of the jitted JAX engine's, blocking, non-blocking and
  overlapped, from JAX's initial models.
* Exact mode: the port's overlapped run equals its non-blocking run
  bitwise, and draining the pipeline after 3 supersteps then re-priming
  it continues the uninterrupted run bitwise.
* Quantized: the drained pipeline keeps a live comm copy, and re-priming
  restores it bitwise.
* A config with overlap and not nonblocking is refused when it is built.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import SwarmConfig as JSwarmConfig
from repro.core import make_graph, make_swarm_step as jmake_swarm_step
from repro.core import sample_matching as jsample_matching
from repro.core import swarm_init as jswarm_init
from repro.optim import make_optimizer as jmake_optimizer
from repro_torch.core import (
    SwarmConfig, SwarmState, make_swarm_step, pipeline_epilogue,
    pipeline_prologue,
)
from repro_torch.optim import make_optimizer

N, D, H, B, T = 8, 12, 2, 4, 10
LR = 0.05
MODES = {"blocking": (False, False), "nonblocking": (True, False),
         "overlap": (True, True)}


def _data(T, seed=42):
    r = np.random.default_rng(seed)
    X = r.normal(size=(T, N, H, B, D)).astype(np.float32)
    Y = r.normal(size=(T, N, H, B)).astype(np.float32)
    return X, Y


def _perms(T, seed):
    g = make_graph("complete", N)
    return [jsample_matching(g, np.random.default_rng(seed))
            for _ in range(T)]


def _jlin_loss(p, mb):
    x, y = mb
    return 0.5 * jnp.mean((x @ p["w"] - y) ** 2)


def _tlin_loss(p, mb):
    return 0.5 * torch.mean((mb["x"] @ p["w"] - mb["y"]) ** 2)


def _jax_traj(mode, X, Y, perms):
    """JAX engine trajectory [T, N, D] and its initial models [N, D]."""
    nonblocking, overlap = MODES[mode]
    scfg = JSwarmConfig(n_nodes=N, H=H, nonblocking=nonblocking,
                        overlap=overlap, gossip_impl="gather",
                        track_potential=False)
    opt = jmake_optimizer("sgd", lr=LR, momentum=0.0)
    state = jswarm_init(jax.random.PRNGKey(0), scfg,
                        lambda k: {"w": jax.random.normal(k, (D,)) * 0.3},
                        opt.init, same_init=False)
    w0 = np.asarray(state.params["w"])
    step = jax.jit(jmake_swarm_step(scfg, _jlin_loss, opt.update,
                                    lambda s: LR))
    key = jax.random.PRNGKey(7)
    h = jnp.full((N,), H, jnp.int32)
    traj = []
    for t, perm in enumerate(perms):
        key, sub = jax.random.split(key)
        state, _ = step(state, (jnp.asarray(X[t]), jnp.asarray(Y[t])),
                        jnp.asarray(perm), h, sub)
        traj.append(np.asarray(state.params["w"], np.float32))
    return np.stack(traj), w0


def _port_engine(mode, w0, quantize=False, lr=LR):
    """The port's superstep and initial state from the models `w0`."""
    nonblocking, overlap = MODES[mode]
    scfg = SwarmConfig(n_nodes=N, H=H, nonblocking=nonblocking,
                       overlap=overlap, quantize=quantize)
    opt = make_optimizer("sgd", lr=lr, momentum=0.0)
    step = make_swarm_step(scfg, _tlin_loss, opt.update, lambda s: lr)
    params = {"w": torch.from_numpy(np.array(w0, np.float32))}
    keep_prev = (quantize or nonblocking) and not overlap
    state = SwarmState(params, opt.init(params),
                       {"w": params["w"].clone()} if keep_prev else None, 0)
    gen = torch.Generator()
    gen.manual_seed(11)
    if overlap:
        state = pipeline_prologue(scfg, state, gen)
    return scfg, step, state, gen


def _port_run(step, state, X, Y, perms, gen):
    traj = []
    h = np.full((N,), H, np.int32)
    for t, perm in enumerate(perms):
        batch = {"x": torch.from_numpy(X[t]), "y": torch.from_numpy(Y[t])}
        state, _ = step(state, batch, perm, h, gen)
        traj.append(state.params["w"].numpy().copy())
    return np.stack(traj), state


@pytest.mark.parametrize("mode", list(MODES))
def test_engine_matches_jax(mode):
    """Exact mode, fixed H, complete graph, seeded matchings: the port's
    trajectory within 2e-5 of the JAX engine's, superstep by superstep."""
    X, Y = _data(T)
    perms = _perms(T, 123)
    jtraj, w0 = _jax_traj(mode, X, Y, perms)
    _, step, state, gen = _port_engine(mode, w0)
    ttraj, _ = _port_run(step, state, X, Y, perms, gen)
    np.testing.assert_allclose(ttraj, jtraj, rtol=0, atol=2e-5)


def test_overlap_bitwise_equals_nonblocking():
    """In exact mode the pipeline only reschedules: bit-identical states
    to the plain non-blocking superstep."""
    X, Y = _data(T)
    perms = _perms(T, 9)
    w0 = np.random.default_rng(3).normal(size=(N, D)).astype(np.float32)
    runs = {}
    for mode in ("nonblocking", "overlap"):
        _, step, state, gen = _port_engine(mode, w0)
        runs[mode] = _port_run(step, state, X, Y, perms, gen)[0]
    np.testing.assert_array_equal(runs["overlap"], runs["nonblocking"])


def test_pipeline_prologue_steady_epilogue():
    """The primed state carries the payload and no tree prev; draining
    after 3 supersteps and re-priming continues the uninterrupted run
    bitwise (exact mode)."""
    X, Y = _data(6)
    perms = _perms(6, 17)
    w0 = np.random.default_rng(4).normal(size=(N, D)).astype(np.float32)
    scfg, step, state, gen = _port_engine("overlap", w0)
    assert state.inflight is not None and set(state.inflight) == {"sbuf"}
    assert state.prev is None
    full, _ = _port_run(step, state, X, Y, perms, gen)
    half, mid = _port_run(step, state, X[:3], Y[:3], perms[:3], gen)
    drained = pipeline_epilogue(scfg, mid)
    assert drained.inflight is None and mid.inflight is not None
    resumed = pipeline_prologue(scfg, drained, gen)
    rest, _ = _port_run(step, resumed, X[3:], Y[3:], perms[3:], gen)
    np.testing.assert_array_equal(full, np.concatenate([half, rest]))


def test_quantized_epilogue_preserves_comm_copy():
    """Draining a quantized pipeline carries the packed comm copy back
    into `prev`, and re-priming restores it bitwise: a live proxy, not
    the model itself (re-priming from the model would collapse the scale
    and wrap the first decode after the resume)."""
    X, Y = _data(5)
    perms = _perms(5, 23)
    w0 = np.broadcast_to(np.random.default_rng(5).normal(size=D) * 0.3,
                         (N, D)).astype(np.float32)
    scfg, step, state, gen = _port_engine("overlap", w0, quantize=True,
                                          lr=0.01)
    assert set(state.inflight) == {"sbuf", "prev", "wire"}
    assert state.inflight["prev"].data_ptr() != \
        state.inflight["sbuf"].data_ptr()
    _, mid = _port_run(step, state, X, Y, perms, gen)
    drained = pipeline_epilogue(scfg, mid)
    assert drained.prev is not None
    resumed = pipeline_prologue(scfg, drained, gen)
    assert torch.equal(resumed.inflight["prev"], mid.inflight["prev"])
    assert float(torch.max(torch.abs(resumed.inflight["prev"] -
                                     resumed.inflight["sbuf"]))) > 0
    # and the quantized run stays within the quantization envelope of the
    # exact one
    _, step_x, state_x, gen_x = _port_engine("overlap", w0, lr=0.01)
    exact, _ = _port_run(step_x, state_x, X, Y, perms, gen_x)
    quant, _ = _port_run(step, state, X, Y, perms, gen)
    assert float(np.max(np.abs(exact - quant))) < 0.05


def test_overlap_requires_nonblocking():
    with pytest.raises(ValueError, match="nonblocking"):
        SwarmConfig(n_nodes=N, overlap=True)
    with pytest.raises(ValueError, match="h_mode"):
        SwarmConfig(n_nodes=N, h_mode="poisson")
    SwarmConfig(n_nodes=N, overlap=True, nonblocking=True)
    assert SwarmConfig(n_nodes=N, h_mode="trace", h_max=4).h_loop_bound == 4
