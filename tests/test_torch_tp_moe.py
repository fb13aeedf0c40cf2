"""A MoE node split over K GPUs (the model axis's expert rules,
``models/split.py``; ``models/moe.py`` ``expert_ffn``), on the CPU: gloo
ranks of ``launch/mesh.py`` ``init_node_mesh(..., model_parallel=K)``,
fp32, reduced widths (d_model 32, 4 experts top-2, 2 layers).

Both of the reference's layouts: granite-moe-3b-a800m cuts each expert's
d_ff (``expert_ffn``), qwen3-moe-30b-a3b its experts (``expert``).
``reduced`` sets ``expert_shard_axis`` to None, which would run qwen3 in
granite's layout, so every config here (the port's and the JAX
package's alike) has its arch's expert axis restored. ``reduced`` also
sets a capacity factor of 4.0, which drops nothing: the ``@cf1.25`` cases
run the arch's own 1.25, and drop choices.

One ``torch.multiprocessing.spawn`` of 4 ranks runs two meshes in turn:
one node of K = 4, then two nodes of K = 2 (both nodes compute the same
cases). Each rank takes its slices of the JAX package's initial weights
(``models/convert.py`` ``shard_params``) and computes its loss and
gradients through the engine's own path (``core/exchange.py``
``node_grads_fn``), and each MoE layer's routing choices and dropped
choices of one train forward. The tests hold:

* the loss and the gathered gradients against the one-GPU port's within
  ULP_BOUND ulp of a leaf's largest magnitude, and against the JAX
  reference's jitted ``loss_fn`` and gradients within 1e-5;
* every whole leaf (the router, norms, QK-norm) gets a gradient bitwise
  the same on each GPU of the node, with no all-reduce of the engine's;
* the routing choices bitwise the same on the node's GPUs and as the
  one-GPU port's (0 flips), and choices dropped at capacity 1.25;
* with ``cfg.remat`` on, the recompute replays the model group's
  collectives (the all-gather among them);
* planted faults fail: the expert FFN's row-parallel all-reduce dropped
  (granite), and ``copy_to_model`` moved from the dispatched buffer to
  the layer's input (qwen3), which sums the router path's whole gradient
  K times;
* one blocking q8 gather superstep of granite on 2 nodes x 2 GPUs
  (``launch/train.py`` ``build(args, cfg, mesh=)``), held as
  ``tests/test_torch_tp_swarm.py`` holds the dense superstep: each
  encode bitwise the plain encode of the rank's own slice's buffer, whole
  leaves bitwise on the node's GPUs, the losses the same on every rank.
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
from repro_torch.kernels import ref as R
from repro_torch.models import TransformerLM, param_split
from repro_torch.models import split as MS
from repro_torch.models.convert import (params_from_numpy, shard_params,
                                        unshard_params)
from repro_torch.quant.schemes import ModularQuantConfig
from repro_torch.tree import tree_leaves, tree_map, tree_paths

WORLD, B, S = 4, 2, 16
GRANITE, QWEN = "granite-moe-3b-a800m", "qwen3-moe-30b-a3b"
DROPS = "@cf1.25"                      # the arch's own capacity factor
REMAT = "@remat"                       # the same arch with cfg.remat on
CASES = [(a, k) for k in (2, 4) for a in (GRANITE, QWEN)] + \
    [(QWEN + DROPS, 2), (GRANITE + DROPS, 4), (GRANITE + REMAT, 2),
     (QWEN + REMAT, 4)]
FAULTS = {"expert_reduce_dropped": (GRANITE, 2),
          "copy_on_the_layer_input": (QWEN, 2)}
SWARM_STEPS = 2
ULP_BOUND = 32
ULP = 2.0 ** -23
ATOL = 1e-5


def _arch(name):
    return name.split("@")[0]


def _variant(cfg, name):
    """`cfg` with the arch's expert axis restored and the case's
    variant applied."""
    moe = dataclasses.replace(
        cfg.moe, expert_shard_axis=get_config(_arch(name)).moe
        .expert_shard_axis)
    if name.endswith(DROPS):
        moe = dataclasses.replace(moe, capacity_factor=1.25)
    return dataclasses.replace(cfg, moe=moe, remat=name.endswith(REMAT))


def _cfg(name):
    return _variant(reduced(get_config(_arch(name)), n_layers=2,
                            d_model=32), name)


def _jcfg(name):
    from repro.configs import get_config as jget, reduced as jreduced
    return _variant(jreduced(jget(_arch(name)), n_layers=2, d_model=32),
                    name)


def _np_params(name, out):
    return torch.load(os.path.join(out, f"params_{_arch(name)}.pt"),
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


def _routing(cfg, params, tp):
    """Each MoE layer's choices [T, k] and its count of dropped choices,
    of one train forward of node 0's parameters (not stacked)."""
    from repro_torch.models import forward
    from repro_torch.models import moe
    route0, pos0 = moe.route, moe.dispatch_positions
    idx, drops = [], []

    def route(*a):
        out = route0(*a)
        idx.append(out[1].clone())
        return out

    def positions(*a):
        out = pos0(*a)
        drops.append(int((~out[1]).sum()))
        return out
    moe.route, moe.dispatch_positions = route, positions
    try:
        with torch.no_grad():
            forward(cfg, tree_map(lambda x: x[0], params),
                    _batch(cfg)["tokens"][0], tp=tp)
    finally:
        moe.route, moe.dispatch_positions = route0, pos0
    return idx, drops


def _ffn_without_reduce(cfg, p, buf, tp=None):
    """Planted fault: the d_ff slices' partial outputs left unsummed."""
    from repro_torch.models import moe
    return moe._ffn(cfg, p, moe.copy_to_model(buf, tp))


class _Plant:
    """A context planting `fault` in ``models/moe.py``."""

    def __init__(self, fault):
        from repro_torch.models import layers as L
        from repro_torch.models import moe
        self.moe, self.fault = moe, fault
        self.saved = (moe.expert_ffn, moe.apply_moe, moe.copy_to_model)
        apply0 = moe.apply_moe

        def apply_copied(cfg, p, x, **kw):
            return apply0(cfg, p, L.copy_to_model(x, kw.get("tp")), **kw)
        self.apply_copied = apply_copied

    def __enter__(self):
        if self.fault == "expert_reduce_dropped":
            self.moe.expert_ffn = _ffn_without_reduce
        else:
            self.moe.apply_moe = self.apply_copied
            self.moe.copy_to_model = lambda x, tp: x

    def __exit__(self, *exc):
        self.moe.expert_ffn, self.moe.apply_moe, self.moe.copy_to_model = \
            self.saved


def _mine(name, out, mesh, K):
    return params_from_numpy(shard_params(
        _np_params(name, out), _cfg(name), K, mesh.model_index,
        stacked=True), "cpu")


def _swarm_argv():
    return ["--arch", GRANITE, "--nodes", "2", "--steps", str(SWARM_STEPS),
            "--H", "2", "--batch", "2", "--seq", "16", "--device", "cpu",
            "--gossip-impl", "gather", "--seed", "3", "--quantize"]


def _swarm(mesh):
    """SWARM_STEPS blocking q8 supersteps of granite on this rank: its
    losses, parameters after each superstep and its encodes."""
    from repro_torch.launch import train
    from repro_torch.quant.codecs import LatticeCodec
    enc0, encodes = LatticeCodec.encode, []

    def encode(codec, buf, prev_buf, rng, **kw):
        state = rng.get_state().clone()
        wire = enc0(codec, buf, prev_buf, rng, **kw)
        encodes.append({"buf": buf.clone(), "prev": prev_buf.clone(),
                        "rng": state, "q": wire[0].clone(),
                        "s": wire[1].clone()})
        return wire
    LatticeCodec.encode = encode
    try:
        tr = train.build(train.build_parser().parse_args(_swarm_argv()),
                         _cfg(GRANITE), mesh=mesh)
        steps = []
        for t in range(SWARM_STEPS):
            m = tr.superstep(t)
            steps.append({"loss": float(m["loss"]), "params": tree_map(
                lambda x: x.detach().clone(), tr.state.params)})
    finally:
        LatticeCodec.encode = enc0
    return {"steps": steps, "encodes": encodes}


def _run_mesh(rank, port, out, K, res):
    from repro_torch.launch.mesh import init_node_mesh
    from repro_torch.models import layers as L
    mesh = init_node_mesh("cpu", rank=rank, world_size=WORLD,
                          init_method=f"tcp://localhost:{port}",
                          model_parallel=K)
    for name, k in CASES:
        if k != K:
            continue
        cfg = _cfg(name)
        mine = _mine(name, out, mesh, K)
        L.COLLECTIVES = calls = {}
        try:
            res[name, K] = _grads(cfg, mine, mesh.model_shard)
        finally:
            L.COLLECTIVES = None
        res["collectives", name, K] = calls
        res["routing", name, K] = _routing(cfg, mine, mesh.model_shard)
    for fault, (name, k) in FAULTS.items():
        if k != K:
            continue
        with _Plant(fault):
            res[fault] = _grads(_cfg(name), _mine(name, out, mesh, K),
                                mesh.model_shard)
    if K == 2:
        res["swarm"] = _swarm(mesh)
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
    out = str(tmp_path_factory.mktemp("tp_moe"))
    for arch in (GRANITE, QWEN):
        p = jax.device_get(jinit(jax.random.PRNGKey(7), _jcfg(arch)))
        torch.save(tree_map(lambda x: np.asarray(x)[None], p),
                   os.path.join(out, f"params_{arch}.pt"))
    mp.spawn(_rank, args=((_free_port(), _free_port()), out), nprocs=WORLD,
             join=True)
    return out, [torch.load(os.path.join(out, f"r{r}.pt"), weights_only=False)
                 for r in range(WORLD)]


_ONE_GPU = {}


def _one_gpu(out, name):
    """The one-GPU port's (loss, gradients) and routing of `name`."""
    if name not in _ONE_GPU:
        cfg = _cfg(name)
        params = params_from_numpy(_np_params(name, out), "cpu")
        _ONE_GPU[name] = (_grads(cfg, params, None),
                          _routing(cfg, params, None))
    return _ONE_GPU[name]


_JAX = {}


def _reference(out, name):
    """The JAX package's jitted value_and_grad of ``loss_fn``."""
    if name not in _JAX:
        import jax
        import jax.numpy as jnp
        from repro.models import loss_fn as jloss_fn
        jc = _jcfg(name)
        p = tree_map(lambda x: jnp.asarray(x[0]), _np_params(name, out))
        b = {k: jnp.asarray(v[0].numpy()) for k, v in _batch(jc).items()}
        _JAX[name] = jax.jit(jax.value_and_grad(
            lambda q: jloss_fn(jc, q, b)))(p)
    return _JAX[name]


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


def test_the_cases_cover_both_layouts():
    """qwen3 (restored) splits its experts, granite its experts' d_ff;
    the router is whole in both (dims of the blocks' stacked leaves)."""
    q = param_split(_cfg(QWEN), 2)["blocks"]["layer_0"]["moe"]
    g = param_split(_cfg(GRANITE), 2)["blocks"]["layer_0"]["moe"]
    assert MS.expert_split(_cfg(QWEN)) and not MS.expert_split(_cfg(GRANITE))
    assert (q["w_up"], q["w_gate"], q["w_down"], q["router"]) == \
        (1, 1, 1, None)
    assert (g["w_up"], g["w_gate"], g["w_down"], g["router"]) == \
        (3, 3, 2, None)
    # reduced alone would have hidden the expert split
    assert not MS.expert_split(reduced(get_config(QWEN)))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_loss_and_grads_match_one_gpu(ranks, case):
    """The loss on every GPU of the node, and the slices' gradients put
    back together, within ULP_BOUND ulp of the one-GPU port's."""
    out, res = ranks
    name, K = case
    (loss1, g1), _ = _one_gpu(out, name)
    for lt in [r[case][0] for r in res if case in r]:
        assert _ulp_close(lt, loss1), (lt, loss1)
    _, g = _gathered(res, case, K, name)
    for path, a, b in zip(tree_paths(g1), tree_leaves(g), tree_leaves(g1)):
        assert a.shape == b.shape, path
        assert _ulp_close(a, b), (path, float((a - b).abs().max()))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_loss_and_grads_match_the_reference(ranks, case):
    """Against the JAX package's jitted value_and_grad of ``loss_fn`` on
    the same weights, batch and restored config, within 1e-5 of a leaf's
    scale above 1."""
    import jax
    out, res = ranks
    name, K = case
    jl, jg = _reference(out, name)
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
    """The router, the norms and QK-norm get bitwise the same gradient on
    each GPU of the node: the router's path is computed whole on every
    GPU, the dispatch path's partial gradients are summed by
    ``copy_to_model``, and ``node_grads_fn`` adds no all-reduce."""
    _, res = ranks
    name, K = case
    split = tree_leaves(param_split(_cfg(name), K))
    paths = tree_paths(param_split(_cfg(name), K))
    parts = [tree_leaves(g) for _, g in _node_gpus(res, case, K)]
    whole = [p for p, d in zip(paths, split) if d is None]
    assert any(p.endswith(".router") for p in whole)
    for i, d in enumerate(split):
        if d is None:
            assert all(torch.equal(parts[0][i], p[i]) for p in parts[1:]), \
                paths[i]


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_routing_is_the_same_on_every_gpu_and_the_one_gpu_port(ranks,
                                                                case):
    """Every MoE layer's choices bitwise the same on the node's GPUs and
    the one-GPU port's (0 flips), and so the same dropped choices."""
    out, res = ranks
    name, K = case
    _, (idx1, drops1) = _one_gpu(out, name)
    routes = [r["routing", name, K] for r in res if ("routing", name, K)
              in r]
    assert len(routes) == WORLD
    for idx, drops in routes:
        assert len(idx) == len(idx1) == _cfg(name).n_layers
        assert all(torch.equal(a, b) for a, b in zip(idx, idx1))
        assert drops == drops1


@pytest.mark.parametrize("case", [c for c in CASES if DROPS in c[0]],
                         ids=_ids)
def test_capacity_drops_choices_on_a_split_node(ranks, case):
    """At the arch's own capacity factor 1.25 some choices are dropped on
    the split node (the drop path runs), and ``reduced``'s 4.0 drops
    none."""
    _, res = ranks
    name, K = case
    _, drops = res[0]["routing", name, K]
    assert sum(drops) > 0, drops
    _, plain = res[0]["routing", _arch(name), 2]
    assert sum(plain) == 0


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_the_model_groups_collectives(ranks, case):
    """qwen3's layers all-gather their experts' outputs, one a layer and
    pass (the remat recompute replays it); granite's gather nothing. The
    counts are the same on every GPU of the node."""
    _, res = ranks
    name, K = case
    cfg = _cfg(name)
    calls = _node_gpus(res, ("collectives", name, K), K)
    assert all(c == calls[0] for c in calls)
    passes = 2 if cfg.remat else 1
    want = passes * cfg.n_layers if MS.expert_split(cfg) else 0
    assert calls[0].get("gather_calls", 0) == want
    if cfg.remat:
        off = _node_gpus(res, ("collectives", _arch(name), K), K)
        assert calls[0]["calls"] > off[0]["calls"]


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_faults_fail(ranks, fault):
    """The expert FFN's output left as each GPU's partial sum, or the
    model group's gradient sum moved from the buffer to the layer input:
    the loss or a gradient leaves the bound, or a whole leaf's gradient
    differs across the node's GPUs."""
    out, res = ranks
    name, K = FAULTS[fault]
    (loss1, g1), _ = _one_gpu(out, name)
    loss, g = _gathered(res, fault, K, name)
    parts = [tree_leaves(p[1]) for p in _node_gpus(res, fault, K)]
    split = tree_leaves(param_split(_cfg(name), K))
    good = _ulp_close(loss[0], loss1[0]) and all(
        _ulp_close(a, b) for a, b in zip(tree_leaves(g), tree_leaves(g1)))
    whole_equal = all(torch.equal(parts[0][i], p[i]) for p in parts[1:]
                      for i, d in enumerate(split) if d is None)
    assert not (good and whole_equal)


def test_q8_superstep_encodes_the_ranks_own_slice(ranks):
    """Each encode of granite's blocking q8 supersteps on each rank:
    bitwise ``kernels/ref.py`` ``quantize_mod`` of the rank's own
    slices' packed buffer with its node's fold of the run's generator,
    the same uniforms on both GPUs of a node and not across nodes."""
    _, res = ranks
    qc = ModularQuantConfig()
    for t in range(SWARM_STEPS):
        us = []
        for r in range(WORLD):
            e = res[r]["swarm"]["encodes"][t]
            g = torch.Generator()
            g.set_state(e["rng"])
            u = torch.rand(e["buf"].shape, generator=g)
            q, s = R.quantize_mod(e["buf"].reshape(-1, qc.block),
                                  e["prev"].reshape(-1, qc.block),
                                  u.reshape(-1, qc.block), safety=qc.safety,
                                  min_scale=qc.min_scale, bits=qc.bits)
            assert torch.equal(q.reshape(e["q"].shape), e["q"])
            assert torch.equal(s.reshape(e["s"].shape), e["s"])
            us.append(u)
        assert torch.equal(us[0], us[1]) and torch.equal(us[2], us[3])
        assert not torch.equal(us[0], us[2])


def test_q8_superstep_keeps_whole_leaves_bitwise(ranks):
    """After every superstep the router and the norms are bitwise the
    same on a node's GPUs, and the losses finite and the same on every
    rank."""
    _, res = ranks
    split = tree_leaves(param_split(_cfg(GRANITE), 2))
    for t in range(SWARM_STEPS):
        losses = {r["swarm"]["steps"][t]["loss"] for r in res}
        assert len(losses) == 1 and np.isfinite(losses.pop())
        for n in range(2):
            a, b = (tree_leaves(res[2 * n + i]["swarm"]["steps"][t]
                                ["params"]) for i in range(2))
            assert all(torch.equal(x, y) for d, x, y in zip(split, a, b)
                       if d is None)
