"""One node split over K GPUs (the model axis, ``models/split.py``), its
loss and gradients, on the CPU: gloo ranks of ``launch/mesh.py``
``init_node_mesh(..., model_parallel=K)``, fp32, reduced widths (d_model
32, 4 heads, 2 layers).

One ``torch.multiprocessing.spawn`` of 4 ranks runs two meshes in turn:
one node of K = 4, then two nodes of K = 2 (both nodes compute the same
cases). Each rank takes its slices of the JAX package's initial weights
(``models/convert.py`` ``shard_params``) and computes its loss and
gradients through the engine's own path (``core/exchange.py``
``node_grads_fn`` of ``TransformerLM(cfg, tp=...).functional_loss``:
``node_losses``, one reverse pass). The tests hold, for transformer-wmt,
olmo-1b, gemma3-4b (sliding window, QK-norm) and chatglm3-6b (2 kv
heads: whole on every GPU at K = 4), and a vocabulary that does not
divide (whole on every GPU); gemma3-4b at K = 2 and chatglm3-6b at K = 4
also with ``cfg.remat`` on, each block recomputed in the backward pass
under ``torch.utils.checkpoint``, which replays the forward's model-group
all-reduces there:

* the loss and the gathered gradients against the one-GPU port's within
  ULP_BOUND ulp of a leaf's largest magnitude (the slices' partial sums
  add in another order);
* against the JAX reference's jitted ``loss_fn`` and gradients within the
  model tests' bound (1e-5, relative to a leaf's scale above 1);
* every leaf every GPU of the node holds whole gets a gradient bitwise
  the same on each of them, with no all-reduce of the engine's own;
* planted faults fail: the MLP's row-parallel all-reduce removed, and the
  sum over the node's GPUs of a whole kv weight's partial gradients
  dropped.
"""
import dataclasses
import os
import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs import get_config, reduced
from repro_torch.core.exchange import node_grads_fn
from repro_torch.models import TransformerLM, param_split
from repro_torch.models.split import kv_deviation
from repro_torch.models.convert import (params_from_numpy, shard_params,
                                        unshard_params)
from repro_torch.tree import tree_leaves, tree_map, tree_paths

WORLD, B, S = 4, 2, 16
ARCHS = ("transformer-wmt", "olmo-1b", "gemma3-4b", "chatglm3-6b")
ODD_VOCAB = "transformer-wmt@v510"     # 510 rows: whole at K = 4
REMAT = "@remat"                       # the same arch with cfg.remat on
CASES = [(a, k) for k in (2, 4) for a in ARCHS] + [(ODD_VOCAB, 4)] + \
    [("gemma3-4b" + REMAT, 2), ("chatglm3-6b" + REMAT, 4)]
FAULTS = {"mlp_reduce_dropped": ("transformer-wmt", 2),
          "kv_grad_sum_dropped": ("chatglm3-6b", 4)}
ULP_BOUND = 32
ULP = 2.0 ** -23
ATOL = 1e-5


def _arch(name):
    return name.split("@")[0]


def _cfg(name):
    cfg = reduced(get_config(_arch(name)), n_layers=2, d_model=32)
    if name == ODD_VOCAB:
        cfg = dataclasses.replace(cfg, vocab_size=510)
    if name.endswith(REMAT):
        cfg = dataclasses.replace(cfg, remat=True)
    return cfg


def _jcfg(name):
    from repro.configs import get_config as jget, reduced as jreduced
    cfg = jreduced(jget(_arch(name)), n_layers=2, d_model=32)
    if name == ODD_VOCAB:
        cfg = dataclasses.replace(cfg, vocab_size=510)
    if name.endswith(REMAT):
        cfg = dataclasses.replace(cfg, remat=True)
    return cfg


def _np_params(name, out):
    """The JAX package's initial weights of `name`, node-stacked [1, ...],
    saved once by the parent (``out``) for the ranks to read."""
    return torch.load(os.path.join(out, f"params_{name}.pt"),
                      weights_only=False)


def _batch(cfg):
    rng = np.random.default_rng(0)
    return {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, B, S))
                                .astype(np.int32))
            for k in ("tokens", "targets")}


def _grads(cfg, params, tp):
    """(loss [1], gradient tree) through the engine's ``node_grads_fn``."""
    g, losses = node_grads_fn(TransformerLM(cfg, tp=tp).functional_loss)(
        params, _batch(cfg))
    return losses, g


def _mlp_without_reduce(cfg, p, x, tp=None):
    from repro_torch.models import layers as L
    x = L.copy_to_model(x, tp)
    h = L.activation(cfg, torch.matmul(x, p["w_gate"])) * \
        torch.matmul(x, p["w_up"]) if cfg.gated_mlp else \
        L.activation(cfg, torch.matmul(x, p["w_up"]))
    return torch.matmul(h, p["w_down"])


def _kv_without_sum(cfg, p, tp):
    hd = cfg.resolved_head_dim
    if tp is None or p["wk"].shape[-1] != cfg.n_kv_heads * hd:
        return p["wk"], p["wv"]
    nh = cfg.n_heads // tp.size
    lo = (tp.index * nh) // (cfg.n_heads // cfg.n_kv_heads)
    return p["wk"][..., lo * hd:(lo + 1) * hd], \
        p["wv"][..., lo * hd:(lo + 1) * hd]


def _run_mesh(rank, port, out, K, res):
    from repro_torch.launch.mesh import init_node_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    mesh = init_node_mesh("cpu", rank=rank, world_size=WORLD,
                          init_method=f"tcp://localhost:{port}",
                          model_parallel=K)
    for name, k in CASES:
        if k != K:
            continue
        cfg = _cfg(name)
        mine = params_from_numpy(shard_params(
            _np_params(name, out), cfg, K, mesh.model_index, stacked=True),
            "cpu")
        L.COLLECTIVES = calls = {}
        try:
            res[name, K] = _grads(cfg, mine, mesh.model_shard)
        finally:
            L.COLLECTIVES = None
        res["allreduces", name, K] = calls["calls"]
    for fault, (name, k) in FAULTS.items():
        if k != K:
            continue
        cfg = _cfg(name)
        mine = params_from_numpy(shard_params(
            _np_params(name, out), cfg, K, mesh.model_index, stacked=True),
            "cpu")
        if fault == "mlp_reduce_dropped":
            saved, T.apply_mlp = T.apply_mlp, _mlp_without_reduce
        else:
            saved, T._local_kv = T._local_kv, _kv_without_sum
        try:
            res[fault] = _grads(cfg, mine, mesh.model_shard)
        finally:
            if fault == "mlp_reduce_dropped":
                T.apply_mlp = saved
            else:
                T._local_kv = saved
    res["where", K] = (mesh.rank, mesh.model_index)
    mesh.close()


def _rank(rank, ports, out):
    torch.set_num_threads(1)
    res = {}
    _run_mesh(rank, ports[0], out, 4, res)
    _run_mesh(rank, ports[1], out, 2, res)
    torch.save(res, os.path.join(out, f"r{rank}.pt"))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import jax
    from repro.models import init_params as jinit
    out = str(tmp_path_factory.mktemp("tp_model"))
    names = {n for n, _ in CASES} | {n for n, _ in FAULTS.values()}
    for name in names:
        p = jax.device_get(jinit(jax.random.PRNGKey(7), _jcfg(name)))
        torch.save(tree_map(lambda x: np.asarray(x)[None], p),
                   os.path.join(out, f"params_{name}.pt"))
    mp.spawn(_rank, args=((_free_port(), _free_port()), out), nprocs=WORLD,
             join=True)
    return out, [torch.load(os.path.join(out, f"r{r}.pt"), weights_only=False)
                 for r in range(WORLD)]


def _one_gpu(out, name):
    cfg = _cfg(name)
    params = params_from_numpy(_np_params(name, out), "cpu")
    return _grads(cfg, params, None)


def _node_gpus(res, key, K):
    """The K ranks of node 0 at mesh K, in model index order."""
    return [r[key] for r in res if r["where", K] in
            [(0, i) for i in range(K)]]


def _gathered(res, key, K, name):
    parts = _node_gpus(res, key, K)
    return parts[0][0], unshard_params([g for _, g in parts], _cfg(name),
                                       stacked=True)


def _ulp_close(got, want, k=ULP_BOUND) -> bool:
    scale = max(float(want.abs().max()), 1e-30)
    return float((got - want).abs().max()) <= k * ULP * scale


def _ids(case):
    return f"{case[0]}-K{case[1]}"


def test_every_rank_ran_its_place(ranks):
    _, res = ranks
    assert [r["where", 4] for r in res] == [(0, i) for i in range(4)]
    assert [r["where", 2] for r in res] == [(0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_loss_and_grads_match_one_gpu(ranks, case):
    """The loss on every GPU of the node, and the slices' gradients put
    back together, within ULP_BOUND ulp of the one-GPU port's."""
    out, res = ranks
    name, K = case
    loss1, g1 = _one_gpu(out, name)
    losses = [r[case][0] for r in res if (case in r)]
    for lt in losses:
        assert _ulp_close(lt, loss1), (lt, loss1)
    loss, g = _gathered(res, case, K, name)
    for path, a, b in zip(tree_paths(g1), tree_leaves(g), tree_leaves(g1)):
        assert a.shape == b.shape, path
        assert _ulp_close(a, b), (path, float((a - b).abs().max()))


@pytest.mark.parametrize("case", [(a, k) for a, k in CASES if k == 2],
                         ids=_ids)
def test_both_nodes_compute_the_same(ranks, case):
    """At K = 2 both nodes of the mesh run the same case on their own
    model groups: bitwise the same losses and gradients."""
    _, res = ranks
    for i in range(2):
        a, b = res[i][case], res[2 + i][case]
        assert torch.equal(a[0], b[0])
        assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a[1]),
                                                     tree_leaves(b[1])))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_loss_and_grads_match_the_reference(ranks, case):
    """Against the JAX package's jitted value_and_grad of ``loss_fn`` on
    the same weights and batch, within the model tests' bound."""
    import jax
    import jax.numpy as jnp
    from repro.models import loss_fn as jloss_fn
    out, res = ranks
    name, K = case
    jc = _jcfg(name)
    p = tree_map(lambda x: jnp.asarray(x[0]), _np_params(name, out))
    b = {k: jnp.asarray(v[0].numpy()) for k, v in _batch(jc).items()}
    jl, jg = jax.jit(jax.value_and_grad(lambda q: jloss_fn(jc, q, b)))(p)
    loss, g = _gathered(res, case, K, name)

    def close(j, t):
        j = np.asarray(j)
        scale = max(1.0, float(np.abs(j).max()))
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=ATOL * scale)
    close(jl, loss[0])
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(tree_leaves(g))
    for a, t in zip(jleaves, tree_leaves(g)):
        close(a, t[0])


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_whole_leaves_get_bitwise_equal_gradients(ranks, case):
    """A leaf every GPU of the node holds whole (norm scales, QK-norm, a
    whole kv weight below K, a vocabulary that does not divide) gets
    bitwise the same gradient on each of them: the conjugate collectives
    sum its partial gradients, and ``node_grads_fn`` adds no all-reduce
    of its own."""
    _, res = ranks
    name, K = case
    split = tree_leaves(param_split(_cfg(name), K))
    parts = [tree_leaves(g) for _, g in _node_gpus(res, case, K)]
    whole = 0
    for i, d in enumerate(split):
        if d is None:
            whole += 1
            assert all(torch.equal(parts[0][i], p[i]) for p in parts[1:]), i
    # olmo-1b's norms carry no parameters: every one of its leaves is split
    assert whole > 0 or _arch(name) == "olmo-1b"


def test_the_cases_cover_the_deviation_and_a_whole_vocabulary():
    assert kv_deviation(_cfg("chatglm3-6b"), 4)
    assert not kv_deviation(_cfg("chatglm3-6b"), 2)
    attn = param_split(_cfg("chatglm3-6b"), 4)["blocks"]["layer_0"]["attn"]
    assert attn["wk"] is None and attn["wq"] == 2
    assert param_split(_cfg(ODD_VOCAB), 4)["embed"] is None
    assert param_split(_cfg("gemma3-4b"), 4)["embed"] == 0


@pytest.mark.parametrize("case", [c for c in CASES if c[0].endswith(REMAT)],
                         ids=_ids)
def test_remat_replays_the_model_groups_all_reduces(ranks, case):
    """With ``cfg.remat`` on each block's forward runs again in the
    backward pass, its model-group all-reduces with it: more of them than
    the same case with remat off, the same number on every GPU."""
    _, res = ranks
    name, K = case
    on = [r["allreduces", name, K] for r in _node_gpus_all(res, K)]
    off = [r["allreduces", _arch(name), K] for r in _node_gpus_all(res, K)]
    assert _cfg(name).remat and not _cfg(_arch(name)).remat
    assert len(set(on)) == 1 and on[0] > off[0], (on, off)


def _node_gpus_all(res, K):
    return [r for r in res if r["where", K][0] == 0]


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_faults_fail(ranks, fault):
    """The MLP's output left as each GPU's partial sum, or a whole kv
    weight's gradient left partial on each GPU: the pair breaks (the
    loss or a gradient leaves the bound, or a whole leaf's gradient
    differs across the node's GPUs)."""
    out, res = ranks
    name, K = FAULTS[fault]
    loss1, g1 = _one_gpu(out, name)
    loss, g = _gathered(res, fault, K, name)
    parts = [tree_leaves(p[1]) for p in _node_gpus(res, fault, K)]
    split = tree_leaves(param_split(_cfg(name), K))
    good = _ulp_close(loss[0], loss1[0]) and all(
        _ulp_close(a, b) for a, b in zip(tree_leaves(g), tree_leaves(g1)))
    whole_equal = all(torch.equal(parts[0][i], p[i]) for p in parts[1:]
                      for i, d in enumerate(split) if d is None)
    assert not (good and whole_equal)
