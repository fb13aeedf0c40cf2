"""The port's AdamW, learning-rate schedules, numpy simulator, mean model,
Γ bound and serving roofline against the JAX package, on the CPU, from
the same numpy-seeded inputs.

* AdamW (``optim/adamw.py``, ``make_optimizer("adamw")``): five steps on
  a mixed fp32 / bf16 tree, with and without weight decay, fp32 and bf16
  accumulators: parameters and moments within 2e-6 relative of jitted
  JAX, the step counter equal. The bias corrections are ``b ** t`` in
  fp32, whose last bit may differ between XLA and PyTorch.
* The four schedules at every step of a run (and past its end): within
  1e-6 relative of JAX's or 1e-6 of the base rate (a cosine's last bit
  likewise).
* ``core/simulator.py`` (numpy): ``run_simulation`` in every mode,
  ``run_superstep_oracle`` and ``run_events_oracle`` (masks, h schedules,
  join bins) and ``quadratic_problem``, bitwise the reference's on the
  same seeds.
* ``core/potential.py`` ``mean_model`` / ``gamma_bound`` and
  ``roofline/analytic.py`` ``serve_flops`` / ``kv_cache_bytes`` /
  ``serve_bytes`` for all 11 archs and the serving shapes: equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, list_archs
from repro.configs.base import INPUT_SHAPES as JSHAPES
from repro.core import potential as JP
from repro.core import simulator as JSIM
from repro.core.graph import make_graph as jmake_graph
from repro.optim import make_optimizer as jmake_optimizer
from repro.optim import schedules as JSCH
from repro.roofline import analytic as JA
from repro_torch.configs import get_config
from repro_torch.configs.base import INPUT_SHAPES, InputShape
from repro_torch.core import potential as TP
from repro_torch.core import simulator as TSIM
from repro_torch.core.graph import make_graph
from repro_torch.optim import make_optimizer
from repro_torch.optim import schedules as TSCH
from repro_torch.roofline import analytic as TA


def _tree(rng):
    return {"a": rng.normal(size=(7, 5)).astype(np.float32),
            "b": {"c": rng.normal(size=(11,)).astype(np.float32)}}


def _to_jax(tree, bf16):
    out = jax.tree.map(jnp.asarray, tree)
    if bf16:
        out["b"]["c"] = out["b"]["c"].astype(jnp.bfloat16)
    return out


def _to_torch(tree, bf16):
    out = {"a": torch.from_numpy(tree["a"].copy()),
           "b": {"c": torch.from_numpy(tree["b"]["c"].copy())}}
    if bf16:
        out["b"]["c"] = out["b"]["c"].to(torch.bfloat16)
    return out


def _close(j, t, rtol=2e-6):
    j = np.asarray(jnp.asarray(j).astype(jnp.float32))
    t = t.to(torch.float32).numpy()
    np.testing.assert_allclose(t, j, rtol=rtol, atol=rtol * np.abs(j).max())


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wd", [0.0, 0.1], ids=["no-wd", "wd"])
@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "mixed"])
def test_adamw_matches_jax(wd, bf16, state_dtype):
    kw = dict(lr=1e-2, weight_decay=wd, state_dtype=state_dtype)
    jopt, topt = jmake_optimizer("adamw", **kw), make_optimizer("adamw", **kw)
    rng = np.random.default_rng(0)
    jp, tp = _to_jax(_tree(rng), bf16), _to_torch(_tree(
        np.random.default_rng(0)), bf16)
    js, ts = jopt.init(jp), topt.init(tp)
    assert ts["t"].dtype == torch.int32 and int(ts["t"]) == 0
    assert ts["m"]["a"].dtype == getattr(torch, state_dtype)
    jupd = jax.jit(jopt.update)
    for step in range(5):
        g = _tree(np.random.default_rng(10 + step))
        lr = 1e-2 if step % 2 else None         # cfg.lr, or passed in
        jp, js = jupd(jp, _to_jax(g, bf16), js, lr)
        tp, ts = topt.update(tp, _to_torch(g, bf16), ts, lr)
        assert int(ts["t"]) == int(js["t"]) == step + 1
        for path in (("a",), ("b", "c")):
            def get(t, p=path):
                for k in p:
                    t = t[k]
                return t
            tol = 2e-6 if not bf16 or path == ("a",) else 1e-2
            _close(get(jp), get(tp), tol)
            mtol = 2e-6 if state_dtype == "float32" else 1e-2
            _close(get(js["m"]), get(ts["m"]), mtol)
            _close(get(js["v"]), get(ts["v"]), mtol)
            assert get(tp).dtype == (torch.bfloat16 if bf16 and
                                     path == ("b", "c") else torch.float32)
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("lamb")


def _sched_pairs(total):
    return [(JSCH.constant_lr(0.1), TSCH.constant_lr(0.1)),
            (JSCH.step_decay_lr(0.1, total), TSCH.step_decay_lr(0.1, total)),
            (JSCH.step_decay_lr(0.2, total, (0.5,), 0.5),
             TSCH.step_decay_lr(0.2, total, (0.5,), 0.5)),
            (JSCH.cosine_lr(0.1, total), TSCH.cosine_lr(0.1, total)),
            (JSCH.cosine_lr(0.1, total, 0.1), TSCH.cosine_lr(0.1, total, 0.1)),
            (JSCH.warmup_cosine_lr(0.1, total, 20),
             TSCH.warmup_cosine_lr(0.1, total, 20)),
            (JSCH.warmup_cosine_lr(0.1, total, 0, 0.05),
             TSCH.warmup_cosine_lr(0.1, total, 0, 0.05))]


@pytest.mark.parametrize("total", [1, 90, 300])
def test_schedules_match_jax(total):
    for jf, tf in _sched_pairs(total):
        jfn = jax.jit(jf)
        for step in list(range(0, total + 25)) + [10 * total]:
            want = float(jfn(jnp.int32(step)))
            got = tf(torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32 and got.ndim == 0
            # 1e-6 of the base rate: near a cosine's end 1 + cos(πt)
            # cancels, so the last bit of cos shows there relatively
            assert got.item() == pytest.approx(want, rel=1e-6, abs=2e-7), \
                (total, step)
            assert float(tf(step)) == got.item()     # a plain int step


def _trace_bits(a, b):
    for f in ("gamma", "grad_norm_sq", "loss"):
        assert getattr(a, f) == getattr(b, f), f
    assert (a.quant_failures, a.bits_sent) == (b.quant_failures, b.bits_sent)


@pytest.mark.parametrize("h_mode", ["geometric", "fixed"])
@pytest.mark.parametrize("nonblocking", [False, True],
                         ids=["blocking", "nonblocking"])
@pytest.mark.parametrize("quantize", [False, True], ids=["fp64", "q8"])
def test_run_simulation_bitwise(h_mode, nonblocking, quantize):
    n, d = 8, 6
    jf = JSIM.quadratic_problem(d, n, noise=0.1, hetero=0.3, seed=2)
    tf = TSIM.quadratic_problem(d, n, noise=0.1, hetero=0.3, seed=2)
    np.testing.assert_array_equal(jf[3], tf[3])
    x0 = np.random.default_rng(1).normal(size=(n, d))
    kw = dict(H=3.0, h_mode=h_mode, eta=0.02, nonblocking=nonblocking,
              quantize=quantize, quant_bits=8, quant_resolution=1e-3, seed=4)
    for kind in ("complete", "ring"):
        ja = JSIM.run_simulation(jmake_graph(kind, n), x0, jf[0],
                                 JSIM.SimConfig(**kw), 120, loss_fn=jf[1],
                                 grad_of_mean_fn=jf[2], record_every=3)
        ta = TSIM.run_simulation(make_graph(kind, n), x0, tf[0],
                                 TSIM.SimConfig(**kw), 120, loss_fn=tf[1],
                                 grad_of_mean_fn=tf[2], record_every=3)
        _trace_bits(ja, ta)
        assert len(ta.gamma) == 40


def _lin_grad(n, d, T, hmax):
    r = np.random.default_rng(9)
    X = r.normal(size=(T, n, hmax, d)).astype(np.float32)

    def grad(x, node, t, q):
        return (X[t, node, q] * np.float32(0.1) + x * np.float32(0.05)
                ).astype(np.float32)
    return grad


@pytest.mark.parametrize("nonblocking", [False, True],
                         ids=["blocking", "nonblocking"])
def test_oracles_bitwise(nonblocking):
    n, d, T = 8, 5, 6
    g = jmake_graph("complete", n)
    rng = np.random.default_rng(0)
    from repro.core.graph import sample_matching
    perms = [sample_matching(g, rng) for _ in range(T)]
    hs = rng.integers(0, 4, (T, n))
    masks = rng.random((T, n)) < 0.7
    kinds = np.zeros(T, np.int8)
    kinds[3] = 1                                    # a join bin
    masks[3] = False
    masks[3][int(np.nonzero(perms[3] != np.arange(n))[0][0])] = True
    x0 = rng.normal(size=(n, d)).astype(np.float32)
    grad = _lin_grad(n, d, T, 4)
    for kw in ({}, {"h_schedule": hs}, {"h_schedule": hs, "masks": masks},
               {"h_schedule": hs, "masks": masks, "kinds": kinds}):
        np.testing.assert_array_equal(
            TSIM.run_superstep_oracle(x0, grad, perms, 2, 0.1,
                                      nonblocking=nonblocking, **kw),
            JSIM.run_superstep_oracle(x0, grad, perms, 2, 0.1,
                                      nonblocking=nonblocking, **kw))
    pairs = rng.integers(0, n, (12, 2))
    pairs[:, 1] = (pairs[:, 0] + 1 + rng.integers(0, n - 1, 12)) % n
    ehs = rng.integers(0, 3, (12, 2))
    ebin = np.repeat(np.arange(6), 2)
    ekinds = np.zeros(12, np.int8)
    ekinds[4], ekinds[7] = 1, 2                     # a join, a leave
    for kinds_ in (None, ekinds):
        np.testing.assert_array_equal(
            TSIM.run_events_oracle(x0, grad, pairs, ehs, ebin, 0.1,
                                   nonblocking=nonblocking, kinds=kinds_),
            JSIM.run_events_oracle(x0, grad, pairs, ehs, ebin, 0.1,
                                   nonblocking=nonblocking, kinds=kinds_))
    empty = TSIM.run_events_oracle(x0, grad, np.zeros((0, 2), int),
                                   np.zeros((0, 2), int), np.zeros(0, int),
                                   0.1)
    assert empty.shape == (0, n, d)


def test_quadratic_problem_bitwise():
    for seed in (0, 3):
        jg, jl, jm, jx = JSIM.quadratic_problem(7, 5, noise=0.2, hetero=0.5,
                                                seed=seed)
        tg, tl, tm, tx = TSIM.quadratic_problem(7, 5, noise=0.2, hetero=0.5,
                                                seed=seed)
        np.testing.assert_array_equal(jx, tx)
        x = np.random.default_rng(seed).normal(size=7)
        r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
        np.testing.assert_array_equal(jg(x, 2, r1), tg(x, 2, r2))
        assert jl(x) == tl(x)
        np.testing.assert_array_equal(jm(x), tm(x))


def test_mean_model_and_gamma_bound_match_jax():
    rng = np.random.default_rng(3)
    tree = {"w": rng.normal(size=(8, 4, 3)).astype(np.float32),
            "b": rng.normal(size=(8, 3)).astype(np.float32)}
    jt = jax.tree.map(jnp.asarray, tree)
    jt["b"] = jt["b"].astype(jnp.bfloat16)
    tt = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    tt["b"] = tt["b"].to(torch.bfloat16)
    jm, tm = JP.mean_model(jt), TP.mean_model(tt)
    for k in tree:
        assert tm[k].dtype == torch.float32
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                   rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(TP.gamma_potential(tt)),
                               float(JP.gamma_potential(jt)), rtol=1e-6)
    for args in ((8, 4, 0.5, 0.01, 2, 1.0), (64, 16, 0.02, 0.1, 5, 3.5)):
        assert TP.gamma_bound(*args) == JP.gamma_bound(*args)


@pytest.mark.parametrize("arch", list_archs())
def test_serve_roofline_matches_jax(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    shapes = [(INPUT_SHAPES[k], JSHAPES[k]) for k in INPUT_SHAPES] + [
        (InputShape("d8", 512, 8, "decode"),
         type(JSHAPES["decode_32k"])("d8", 512, 8, "decode")),
        (InputShape("d1", 64, 1, "decode"),
         type(JSHAPES["decode_32k"])("d1", 64, 1, "decode"))]
    for ts, js in shapes:
        if ts.kind == "train":
            continue
        assert TA.serve_flops(cfg, ts) == JA.serve_flops(jcfg, js)
        assert TA.kv_cache_bytes(cfg, ts) == JA.kv_cache_bytes(jcfg, js)
        assert TA.serve_bytes(cfg, ts) == JA.serve_bytes(jcfg, js)
