"""``cfg.remat`` in the port (the reference's ``jax.checkpoint`` of each
scanned block in training), on the CPU at reduced size:

* the node-stacked loss (``models/transformer.py`` ``node_losses``) with
  remat on is bitwise remat off and ``vmap(loss_fn)``, losses and
  gradients, for every family of the zoo, and through the engine's
  gradient (``core/exchange.py`` ``node_grads_fn``);
* it matches the reference's remat-on loss and gradients (jitted through
  ``jax.checkpoint``) within the model tests' bound: 1e-5, absolute or
  relative to the reference leaf's largest magnitude above 1 (jamba's
  gradients 2e-5), as ``tests/test_torch_zoo.py`` holds them;
* a blocking q8 superstep of the training driver and the five baselines
  are bitwise with remat on and off;
* the dry run sees the recompute: fewer live bytes, more counted FLOPs,
  the reference's analytic terms with ``remat=True``, and its fake peak
  equals a real CPU run's;
* a planted fault, a block recomputed from perturbed parameters, breaks
  the bitwise pair (so the backward pass does recompute);
* the dry run of a one-node ``big_model`` step builds the identity
  matching (the reference's ``static_pairs = [(0, 0)]``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config, reduced as jreduced
from repro.models import init_params as jinit_params
from repro.models import loss_fn as jloss_fn
from repro.roofline import analytic as r_analytic
from repro.configs.base import InputShape as RInputShape
from repro_torch.configs import get_config, list_archs, reduced
from repro_torch.core.exchange import node_grads_fn, node_losses_of
from repro_torch.core.scan import _state_leaves
from repro_torch.launch import dryrun as D
from repro_torch.launch import train
from repro_torch.models import TransformerLM, loss_fn, node_losses
from repro_torch.models import transformer as tf
from repro_torch.models.convert import params_from_numpy
from repro_torch.roofline import analysis
from repro_torch.tree import tree_flatten, tree_unflatten

FAMILIES = ("transformer-wmt", "granite-moe-3b-a800m", "mamba2-780m",
            "jamba-1.5-large-398b", "gemma3-4b", "paligemma-3b")
# jamba's 1:7 and gemma3's 5:1 patterns hold a global attention layer at
# 8 layers: one full block each, gemma3 with a tail of 2
LAYERS = {"gemma3-4b": 8, "jamba-1.5-large-398b": 8}
N_NODES, B, S = 3, 2, 16
ATOL = 1e-5
GRAD_ATOL = {"jamba-1.5-large-398b": 2e-5}


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(arch, remat=True):
    return dataclasses.replace(
        reduced(get_config(arch), n_layers=LAYERS.get(arch, 2), d_model=32),
        remat=remat)


def _np_params(arch):
    """Node-stacked weights of JAX's init (one seed a node), numpy."""
    jc = jreduced(jget_config(arch), n_layers=LAYERS.get(arch, 2),
                  d_model=32)
    nodes = [jax.device_get(jinit_params(jax.random.PRNGKey(s), jc))
             for s in range(N_NODES)]
    return jax.tree.map(lambda *xs: np.stack(xs), *nodes)


def _np_batch(cfg, prefix=True):
    rng = np.random.default_rng(0)
    out = {k: rng.integers(0, cfg.vocab_size, (N_NODES, B, S))
           .astype(np.int32) for k in ("tokens", "targets")}
    if prefix and cfg.frontend is not None:
        f = cfg.frontend
        out["prefix_embeds"] = (rng.standard_normal(
            (N_NODES, B, f.n_prefix, f.d_embed)) * 0.02).astype(np.float32)
    return out


def _grads(losses_fn, params, batch):
    """(losses, gradients) of the node-stacked `losses_fn`: one reverse
    pass of the losses' sum, as ``node_grads_fn`` takes it."""
    leaves, td = tree_flatten(params)
    xs = [x.detach().requires_grad_() for x in leaves]
    losses = losses_fn(tree_unflatten(td, xs), batch)
    gs = torch.autograd.grad(losses.sum(), xs, allow_unused=True)
    return losses.detach(), list(gs)


def _bitwise(a, b) -> bool:
    (la, ga), (lb, gb) = a, b
    return torch.equal(la, lb) and len(ga) == len(gb) and all(
        (x is None and y is None) or (x is not None and y is not None and
                                      torch.equal(x, y))
        for x, y in zip(ga, gb))


def _inputs(arch):
    cfg = _cfg(arch)
    params = params_from_numpy(_np_params(arch), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _np_batch(cfg).items()}
    return cfg, params, batch


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_on_is_bitwise_off_and_vmap(arch):
    """Losses and gradients: remat on == remat off == vmap(loss_fn), bit
    for bit, and the engine's gradient through the model's own
    node-stacked loss == through a plain vmap of its per-node loss."""
    on, params, batch = _inputs(arch)
    off = dataclasses.replace(on, remat=False)
    assert on.remat and on.n_full_blocks >= 1
    got_on = _grads(lambda p, b: node_losses(on, p, b), params, batch)
    got_off = _grads(lambda p, b: node_losses(off, p, b), params, batch)
    ref = _grads(torch.func.vmap(lambda p, b: loss_fn(on, p, b)), params,
                 batch)
    assert _bitwise(got_on, got_off)
    assert _bitwise(got_off, ref)
    assert torch.isfinite(got_on[0]).all()
    model = TransformerLM(on)
    tb = {k: batch[k] for k in ("tokens", "targets")}
    assert node_losses_of(model.functional_loss) == \
        model.functional_node_losses
    g_model, l_model = node_grads_fn(model.functional_loss)(params, tb)
    g_vmap, l_vmap = node_grads_fn(
        lambda p, b: model.functional_loss(p, b))(params, tb)
    assert torch.equal(l_model, l_vmap)
    assert all(torch.equal(x, y) for x, y in zip(
        tree_flatten(g_model)[0], tree_flatten(g_vmap)[0]))


@pytest.mark.parametrize("arch", ["transformer-wmt", "granite-moe-3b-a800m",
                                  "gemma3-4b", "paligemma-3b"])
def test_remat_matches_reference(arch):
    """The reference's reduced config with remat on: every node's loss
    and gradient of its jitted ``jax.checkpoint``-ed forward, against the
    port's remat-on node-stacked values, within the model tests' bound."""
    jc = dataclasses.replace(
        jreduced(jget_config(arch), n_layers=LAYERS.get(arch, 2),
                 d_model=32), remat=True)
    np_params = _np_params(arch)
    np_batch = _np_batch(jc)
    jl, jg = jax.jit(jax.vmap(jax.value_and_grad(
        lambda p, b: jloss_fn(jc, p, b))))(
        jax.tree.map(jnp.asarray, np_params),
        jax.tree.map(jnp.asarray, np_batch))
    cfg, params, batch = _inputs(arch)
    tl, tg = _grads(lambda p, b: node_losses(cfg, p, b), params, batch)

    def close(j, t, atol):
        j = np.asarray(j)
        scale = max(1.0, float(np.abs(j).max()))
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=atol * scale)
    close(jl, tl, ATOL)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(tg)
    for a, b in zip(jleaves, tg):
        close(a, b, GRAD_ATOL.get(arch, ATOL))


def test_planted_recompute_fault_breaks_the_pair(monkeypatch):
    """A block recomputed in the backward pass from perturbed parameters:
    the losses stay bitwise (the forward is untouched) and the gradients
    do not, so the backward pass does recompute each block."""
    cfg, params, batch = _inputs("transformer-wmt")
    off = dataclasses.replace(cfg, remat=False)
    want = _grads(lambda p, b: node_losses(off, p, b), params, batch)
    real = tf.checkpoint

    def perturbed(fn, bp, x, **kw):
        calls = []

        def run(bp_, x_):
            calls.append(1)
            if len(calls) > 1:         # the recompute
                bp_ = tf.tree_map(lambda v: v * 1.001, bp_)
            return fn(bp_, x_)
        return real(run, bp, x, **kw)
    monkeypatch.setattr(tf, "checkpoint", perturbed)
    got = _grads(lambda p, b: node_losses(cfg, p, b), params, batch)
    assert torch.equal(got[0], want[0])
    assert not _bitwise(got, want)
    monkeypatch.setattr(tf, "checkpoint", real)
    assert _bitwise(_grads(lambda p, b: node_losses(cfg, p, b), params,
                           batch), want)


def test_full_configs_remat_on_reduced_off():
    """The reference's defaults: on for every full config, off for
    ``reduced``."""
    for arch in list_archs():
        assert get_config(arch).remat
        assert not reduced(get_config(arch)).remat


def _driver_argv(algo_flags):
    return ["--arch", "transformer-wmt", "--nodes", "4", "--steps", "2",
            "--batch", "1", "--seq", "16", "--device", "cpu"] + algo_flags


@pytest.mark.parametrize("flags", [
    ["--quantize"],
    ["--algo", "allreduce"],
    ["--algo", "localsgd", "--H", "2"],
    ["--algo", "dpsgd", "--graph", "ring"],
    ["--algo", "adpsgd", "--quantize", "--nonblocking"],
    ["--algo", "sgp", "--quantize"],
], ids=["swarm_q8", "allreduce", "localsgd", "dpsgd", "adpsgd_q8",
        "sgp_q8"])
def test_driver_supersteps_remat_bitwise(flags):
    """Two supersteps of the training driver (``launch/train.py``
    ``build``): the blocking q8 swarm and the five baselines, remat on ==
    remat off on the whole state and every superstep's metrics."""
    base = dataclasses.replace(reduced(get_config("transformer-wmt"),
                                       n_layers=2, d_model=32), remat=True)
    args = train.build_parser().parse_args(_driver_argv(flags))
    runs = []
    for remat in (True, False):
        tr = train.build(args, dataclasses.replace(base, remat=remat))
        ms = [{k: float(v) for k, v in tr.superstep(t).items()}
              for t in range(2)]
        runs.append((ms, [x.clone() for x in _state_leaves(tr.state)]))
    (m_on, s_on), (m_off, s_off) = runs
    assert m_on == m_off and all(np.isfinite(m["loss"]) for m in m_on)
    assert len(s_on) == len(s_off) and all(
        torch.equal(a, b) for a, b in zip(s_on, s_off))


def _dry(remat, **kw):
    cfg = dataclasses.replace(reduced(get_config("transformer-wmt"),
                                      n_layers=4, d_model=64), remat=remat)
    return cfg, D.run_one("transformer-wmt", "train_4k", cfg=cfg,
                          nodes_per_gpu=2, batch=2, seq=64, device="cpu",
                          quantize=True, **kw)


def test_dry_run_sees_the_recompute():
    """With remat: fewer live bytes (each block's internals freed after
    its forward), more counted FLOPs (the re-forward), the same state,
    and the reference's analytic terms with ``remat=True``."""
    _, off = _dry(False)
    cfg, on = _dry(True)
    assert on["remat"] is True and off["remat"] is False
    assert on["temp_bytes"] < off["temp_bytes"]
    assert on["flops_per_dev"] > off["flops_per_dev"]
    assert on["argument_bytes"] == off["argument_bytes"]
    rcfg = dataclasses.replace(jreduced(jget_config("transformer-wmt"),
                                        n_layers=4, d_model=64), remat=True)
    g = RInputShape("train_4k", 64, 2 * 2 * 2, "train")
    assert on["flops_analytic_per_dev"] == \
        r_analytic.train_flops(rcfg, g, H=2, remat=True)
    assert on["bytes_analytic_per_dev"] == \
        r_analytic.train_bytes_full(rcfg, g, 2, H=2, remat=True)
    assert on["flops_analytic_per_dev"] > off["flops_analytic_per_dev"]


def test_remat_fake_peak_equals_real_cpu_run():
    """The fake trace's peak of live bytes with remat on equals a real
    CPU run's of the same superstep, byte for byte (the recompute's
    tensors freed as the real run frees them)."""
    cfg, rec = _dry(True)
    argv = D.train_argv("transformer-wmt", 2, 2, 2, 64, "cpu", "gather",
                        True, False, False, "fixed", 8)
    tr = train.build(train.build_parser().parse_args(argv), cfg)
    counter = analysis.TraceCounter()
    args = counter.hold(_state_leaves(tr.state))
    with counter:
        tr.superstep(0)
    assert (rec["argument_bytes"], rec["peak_bytes"]) == (args, counter.peak)


def test_lone_big_model_node_dry_run():
    """A ``big_model`` node is a whole pod, so its `single` mesh is one
    node (``n_nodes_for``): the trace builds the identity matching, as
    the reference's dry run does, and gives a record. No gossip partner:
    the gather keeps the node's own row, so nothing is sent."""
    cfg = dataclasses.replace(
        reduced(get_config("jamba-1.5-large-398b"), n_layers=2, d_model=32),
        big_model=True, remat=True)
    assert D.n_nodes_for(cfg, "single") == 1
    rec = D.run_one("jamba-1.5-large-398b", "train_4k", "single", cfg=cfg,
                    batch=1, seq=16, device="cpu", quantize=True)
    assert "error" not in rec and rec["remat"] is True
    assert rec["n_nodes"] == rec["n_devices"] == 1
    assert rec["h_traced"] == [2]
    assert "send" not in rec["coll_raw"] and rec["peak_bytes"] > 0
    g = D.lone_node_graph()
    assert (g.n, g.m) == (1, 0)
