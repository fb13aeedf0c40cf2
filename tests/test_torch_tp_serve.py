"""Serving on a node split over K GPUs (the model axis: ``models/split.py``,
``init_cache(..., tp=)``, ``logits_head``'s all-gather, ``launch/serve.py``
``make_serve_fns(cfg, tp=)`` and ``run_oneshot(..., mesh=)``), on the CPU:
gloo ranks of ``launch/mesh.py`` ``init_node_mesh(..., model_parallel=K)``,
fp32, reduced widths (d_model 32, 4 heads).

One ``torch.multiprocessing.spawn`` of 4 ranks runs two meshes in turn:
one node group of K = 4, then two node groups of K = 2 (both groups
compute the same cases). Each rank takes its slices of the JAX package's
initial weights (``models/convert.py`` ``shard_params``) and runs the
reference's serving sequence: a prefill of two prompts, the cache grown
to capacity, three teacher-forced decode steps, then a chunk of four
tokens of which three are real (the reference's scalar ``n_valid``) and a
ragged chunk (two lanes of 4 and 2 real tokens, the engine's per-lane
form). The archs: olmo-1b, gemma3-4b at 6 layers with a window of 8 (one
global layer; the rings wrap), granite-moe-3b-a800m and qwen3-moe-30b-a3b
with their expert axes restored (``reduced`` clears them), and
chatglm3-6b (2 kv heads: at K 4 each whole kv head is cached by the two
GPUs that read it, the port's named deviation). The tests hold:

* every step's logits (gathered along V: the whole vocabulary on every
  GPU) and each GPU's cache within ULP_BOUND ulp of the one-GPU port's
  (its cache the one-GPU cache's slice of the kv heads it reads), and
  within 1e-5 of the JAX package's forward run eagerly
  (``jax.disable_jit``: ROADMAP.md C 6 and C 16), of a leaf's largest
  magnitude above 1 as ``tests/test_torch_tp_model.py`` holds training;
* each GPU's cache leaf shapes those of the reference's
  ``cache_pspec(layout="headdim")`` on a ``FakeMesh`` of the node groups
  and K, except the named deviation (n_kv_heads < K: the reference cuts
  ``head_dim``, the port keeps a whole head);
* a MoE arch's routing choices bitwise the same on the node's GPUs and as
  the one-GPU port's;
* the one-shot path (``run_oneshot(..., mesh=)``, greedy) gives the
  one-GPU path's tokens, for olmo-1b and for paligemma-3b's frontend
  prefix (one kv head, whole at every K), each node group serving its
  share of the prompts;
* planted faults fail the bound: a GPU caching the kv heads of the next
  model index, the argmax over a GPU's own vocab slice with no gather,
  and attention's ``reduce_from_model`` dropped in decode;
* the dry run traces ``decode_32k`` and ``prefill_32k`` at
  ``--model-parallel 2``: argument and peak bytes below K 1's, the model
  group's all-reduces and the logits' all-gather counted.
"""
import dataclasses
import os
import socket
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import PartitionSpec as P

from repro_torch.configs import INPUT_SHAPES, get_config, reduced
from repro_torch.models import forward, init_cache, logits_head
from repro_torch.models import split as MS
from repro_torch.models.convert import params_from_numpy, shard_params
from repro_torch.serve.engine import grow_cache
from repro_torch.tree import tree_flatten, tree_leaves, tree_map

WORLD, B, S, CAP = 4, 2, 8, 24
GEMMA = "gemma3-4b@w8"                 # 6 layers (one global), window 8
ARCHS = ("olmo-1b", GEMMA, "granite-moe-3b-a800m", "qwen3-moe-30b-a3b",
         "chatglm3-6b")
CASES = [(a, k) for k in (2, 4) for a in ARCHS]
ONESHOT = ("olmo-1b", "paligemma-3b")
FAULTS = {"next_kv_heads": ("olmo-1b", 2), "argmax_no_gather": (GEMMA, 2),
          "decode_reduce_dropped": ("chatglm3-6b", 4)}
CHUNK_NV = 3
ULP_BOUND = 32
ULP = 2.0 ** -23
ATOL = 1e-5


def _arch(name):
    return name.split("@")[0]


def _variant(cfg, name):
    """`cfg` with the arch's expert axis restored, and gemma's depth
    and window."""
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, expert_shard_axis=get_config(_arch(name)).moe
            .expert_shard_axis))
    if name == GEMMA:
        cfg = dataclasses.replace(cfg, sliding_window=8)
    return cfg


def _layers(name):
    return 6 if name == GEMMA else 2


def _cfg(name):
    return _variant(reduced(get_config(_arch(name)), n_layers=_layers(name),
                            d_model=32), name)


def _jcfg(name):
    from repro.configs import get_config as jget, reduced as jreduced
    return _variant(jreduced(jget(_arch(name)), n_layers=_layers(name),
                             d_model=32), name)


def _inputs(cfg):
    """The prompts [B, S], the teacher-forced decode tokens [3, B] and the
    chunk [B, 4], from numpy."""
    rng = np.random.default_rng(11)
    return (rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
            rng.integers(0, cfg.vocab_size, (3, B)).astype(np.int32),
            rng.integers(0, cfg.vocab_size, (B, 4)).astype(np.int32))


def _np_params(out, name):
    return torch.load(os.path.join(out, f"params_{name}.pt"),
                      weights_only=False)


def _serve(cfg, params, tp=None):
    """The serving sequence of the module docstring on `params` -> {step:
    (logits, cache)} plus the routing choices of the prefill."""
    from repro_torch.models import moe
    prompts, steps, chunk = (torch.from_numpy(x).to(torch.int64)
                             for x in _inputs(cfg))
    route0, idx = moe.route, []

    def route(*a):
        out = route0(*a)
        idx.append(out[1].clone())
        return out
    res = {}
    with torch.no_grad():
        moe.route = route
        try:
            h, cache, _ = forward(cfg, params, prompts, mode="prefill",
                                  tp=tp)
        finally:
            moe.route = route0
        res["prefill"] = (logits_head(cfg, params, h[:, -1:], tp), cache)
        cache = grow_cache(init_cache(cfg, B, CAP, device="cpu", tp=tp),
                           cache)
        for t in range(steps.shape[0]):
            h, cache, _ = forward(cfg, params, steps[t][:, None],
                                  mode="decode", cache=cache, tp=tp)
            res[f"decode{t}"] = (logits_head(cfg, params, h, tp), cache)
        h, c2, _ = forward(cfg, params, chunk, mode="chunk", cache=cache,
                           n_valid=CHUNK_NV, tp=tp)
        res["chunk"] = (logits_head(cfg, params, h[:, :CHUNK_NV], tp), c2)
        ragged = torch.tensor([4, 2])
        h, c3, _ = forward(cfg, params, chunk, mode="chunk", cache=cache,
                           n_valid=ragged, tp=tp, moe_per_lane=True)
        last = h[torch.arange(B), ragged - 1][:, None]
        res["ragged"] = (logits_head(cfg, params, last, tp), c3)
    res["routing"] = idx
    return res


class _Plant:
    """A context planting `fault` in ``models/transformer.py`` (the
    weights' fault, ``next_kv_heads``, is planted by ``_mine``)."""

    def __init__(self, fault):
        from repro_torch.models import transformer as tf
        self.tf, self.fault = tf, fault
        self.saved = (tf.gather_from_model, tf.reduce_from_model,
                      tf._attn_layer)

    def __enter__(self):
        tf = self.tf
        if self.fault == "argmax_no_gather":
            tf.gather_from_model = lambda x, tp: x
        elif self.fault == "decode_reduce_dropped":
            attn0, red0, skip = tf._attn_layer, tf.reduce_from_model, [0]

            def attn(cfg, p, x, positions, *, mode="train", **kw):
                skip[0] = mode == "decode"
                try:
                    return attn0(cfg, p, x, positions, mode=mode, **kw)
                finally:
                    skip[0] = False
            tf._attn_layer = attn
            tf.reduce_from_model = lambda x, tp: x if skip[0] \
                else red0(x, tp)

    def __exit__(self, *exc):
        (self.tf.gather_from_model, self.tf.reduce_from_model,
         self.tf._attn_layer) = self.saved


def _mine(out, name, K, index, fault=""):
    """GPU `index`'s slices of `name`'s weights; with the fault
    ``next_kv_heads`` its wk / wv those of the next model index."""
    cfg, whole = _cfg(name), _np_params(out, name)
    mine = shard_params(whole, cfg, K, index)
    if fault == "next_kv_heads":
        nxt = shard_params(whole, cfg, K, (index + 1) % K)
        for layer, p in mine["blocks"].items():
            for k in ("wk", "wv"):
                p["attn"][k] = nxt["blocks"][layer]["attn"][k]
    return params_from_numpy(mine, "cpu")


def _oneshot_args():
    return SimpleNamespace(device="cpu", batch=4, prompt_len=8, gen=6,
                           temperature=0.0)


def _oneshot(out, name, mesh=None):
    from repro_torch.launch.serve import make_generators, run_oneshot
    cfg = _cfg(name)
    K = 1 if mesh is None else mesh.model_size
    params = _np_params(out, name) if mesh is None else shard_params(
        _np_params(out, name), cfg, K, mesh.model_index)
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, cfg.vocab_size, (4, 8)).astype(np.int32)
    prefix = None if cfg.frontend is None else rng.normal(
        size=(4, cfg.frontend.n_prefix, cfg.frontend.d_embed)).astype(
            np.float32)
    with torch.no_grad():
        return run_oneshot(cfg, _oneshot_args(), params_from_numpy(
            params, "cpu"), make_generators(0, "cpu"), prompts=prompts,
            prefix=prefix, mesh=mesh)["tokens"]


def _run_mesh(rank, port, out, K, res):
    from repro_torch.launch.mesh import init_node_mesh
    mesh = init_node_mesh("cpu", rank=rank, world_size=WORLD,
                          init_method=f"tcp://localhost:{port}",
                          model_parallel=K)
    tp = mesh.model_shard
    for name, k in CASES:
        if k == K:
            res[name, K] = _serve(_cfg(name), _mine(out, name, K,
                                                    mesh.model_index), tp)
    for fault, (name, k) in FAULTS.items():
        if k == K:
            with _Plant(fault):
                res[fault] = _serve(_cfg(name), _mine(
                    out, name, K, mesh.model_index, fault), tp)
    for name in ONESHOT:
        res["oneshot", name, K] = _oneshot(out, name, mesh)
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
    from repro.models import init_params as jinit
    out = str(tmp_path_factory.mktemp("tp_serve"))
    for name in ARCHS + ONESHOT[1:]:
        p = jax.device_get(jinit(jax.random.PRNGKey(9), _jcfg(name)))
        torch.save(tree_map(np.asarray, p),
                   os.path.join(out, f"params_{name}.pt"))
    mp.spawn(_rank, args=((_free_port(), _free_port()), out), nprocs=WORLD,
             join=True)
    return out, [torch.load(os.path.join(out, f"r{r}.pt"), weights_only=False)
                 for r in range(WORLD)]


_ONE_GPU = {}


def _one_gpu(out, name):
    if name not in _ONE_GPU:
        _ONE_GPU[name] = _serve(_cfg(name), params_from_numpy(
            _np_params(out, name), "cpu"))
    return _ONE_GPU[name]


_JAX = {}


def _reference(out, name):
    """The JAX package's forward and logits_head run eagerly on the same
    weights and inputs: {step: (logits, cache)} (no ragged chunk: the
    reference's n_valid is one scalar)."""
    if name not in _JAX:
        from repro.models import forward as jfwd, init_cache as jinit_cache
        from repro.models import transformer as jtf
        from repro.serve.engine import grow_cache as jgrow
        jc = _jcfg(name)
        p = jax.tree.map(jnp.asarray, _np_params(out, name))
        prompts, steps, chunk = _inputs(jc)
        res = {}
        with jax.disable_jit():
            h, cache, _ = jfwd(jc, p, jnp.asarray(prompts), mode="prefill")
            res["prefill"] = (jtf.logits_head(jc, p, h[:, -1:]), cache)
            cache = jgrow(jinit_cache(jc, B, CAP), cache)
            for t in range(steps.shape[0]):
                h, cache, _ = jfwd(jc, p, jnp.asarray(steps[t][:, None]),
                                   mode="decode", cache=cache)
                res[f"decode{t}"] = (jtf.logits_head(jc, p, h), cache)
            h, c2, _ = jfwd(jc, p, jnp.asarray(chunk), mode="chunk",
                            cache=cache, n_valid=jnp.int32(CHUNK_NV))
            res["chunk"] = (jtf.logits_head(jc, p, h[:, :CHUNK_NV]), c2)
        _JAX[name] = jax.tree.map(np.asarray, res)
    return _JAX[name]


def _ref_close(want, got):
    """Within ATOL of the leaf's largest magnitude above 1, the model
    tests' bound (``tests/test_torch_tp_model.py``)."""
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL * scale)


def _ulp_close(got, want, k=ULP_BOUND) -> bool:
    scale = max(float(want.abs().max()), 1e-30)
    return float((got - want).abs().max()) <= k * ULP * scale


def _kv_slice(cfg, K, index, path, leaf):
    """The one-GPU cache leaf's part GPU `index` holds: its kv heads of an
    attention or ring cache, the leaf itself otherwise."""
    if path[-1] not in ("k", "v"):
        return leaf
    lo, hi = MS.kv_heads_of(cfg, K, index)
    return leaf[..., lo:hi, :]


def _cache_pairs(cfg, K, index, got, want):
    from repro_torch.tree import tree_key_paths
    for path, a, b in zip(tree_key_paths(want), tree_leaves(got),
                          tree_leaves(want)):
        yield path, a, _kv_slice(cfg, K, index, path, b)


STEPS = ("prefill", "decode0", "decode1", "decode2", "chunk", "ragged")


def _ids(case):
    return f"{case[0]}-K{case[1]}"


def test_every_rank_ran_its_place(ranks):
    _, res = ranks
    assert [r["where", 4] for r in res] == [(0, i) for i in range(4)]
    assert [r["where", 2] for r in res] == [(0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_logits_and_caches_match_one_gpu(ranks, case):
    """Every step's gathered logits on every GPU, and each GPU's cache
    against the one-GPU cache's slice of its kv heads, within ULP_BOUND
    ulp."""
    out, res = ranks
    name, K = case
    cfg, want = _cfg(name), _one_gpu(out, name)
    for r in res:
        if case not in r:
            continue
        index = r["where", K][1]
        for step in STEPS:
            lg, cache = r[case][step]
            assert lg.shape == want[step][0].shape, step
            assert _ulp_close(lg, want[step][0]), (step, float(
                (lg - want[step][0]).abs().max()))
            for path, a, b in _cache_pairs(cfg, K, index, cache,
                                           want[step][1]):
                assert a.shape == b.shape, (step, path)
                assert _ulp_close(a.to(torch.float32),
                                  b.to(torch.float32)), (step, path)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_logits_and_caches_match_the_eager_reference(ranks, case):
    """The split node's logits and its GPUs' caches (the kv heads each
    holds) within 1e-5 of the JAX package's forward run eagerly."""
    out, res = ranks
    name, K = case
    cfg, ref = _cfg(name), _reference(out, name)
    for r in res:
        if case not in r:
            continue
        index = r["where", K][1]
        for step in ref:
            lg, cache = r[case][step]
            _ref_close(ref[step][0], lg.numpy())
            jl = jax.tree.leaves(ref[step][1])
            tl = tree_flatten(cache)[0]
            assert len(jl) == len(tl)
            from repro_torch.tree import tree_key_paths
            for path, a, b in zip(tree_key_paths(cache), jl, tl):
                a = _kv_slice(cfg, K, index, path, torch.from_numpy(
                    np.array(a)))
                _ref_close(a.numpy(), b.numpy())


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_cache_shapes_are_the_references_headdim_layout(ranks, case):
    """Each GPU's cache leaves have the local shapes of the reference's
    ``cache_pspec(layout="headdim")`` on a FakeMesh of the node groups
    and K, but where n_kv_heads < K (chatglm3-6b at K 4): there the
    reference cuts head_dim and the port keeps the one whole kv head the
    GPU reads."""
    from repro.launch import specs as RS
    from repro.models import init_cache as jinit_cache
    from repro_torch.configs.base import InputShape
    _, res = ranks
    name, K = case
    groups = WORLD // K
    mesh = FakeMesh({"data": groups, "model": K})
    jc = _jcfg(name)
    glob = jax.eval_shape(lambda: jinit_cache(jc, B * groups, CAP))
    spec = RS.cache_pspec(jc, mesh, InputShape("decode", CAP, B * groups,
                                               "decode"), layout="headdim")
    specs = jax.tree.leaves(spec, is_leaf=lambda s: isinstance(s, P))
    deviation = MS.kv_deviation(_cfg(name), K)
    assert deviation == ((name, K) == ("chatglm3-6b", 4))
    cache = res[0][case]["decode2"][1]
    for g, sp, leaf in zip(jax.tree.leaves(glob), specs,
                           tree_flatten(cache)[0]):
        local = [d // int(np.prod([mesh.shape[a] for a in
                                   (ax if isinstance(ax, tuple) else (ax,))
                                   if a is not None]))
                 for d, ax in zip(g.shape, tuple(sp) + (None,) * 8)]
        if deviation and "model" in tuple(sp)[-1:]:
            local[-2], local[-1] = 1, g.shape[-1]     # a whole kv head
        assert list(leaf.shape) == local, (sp, g.shape, leaf.shape)


class FakeMesh:
    """``tests/test_specs_host.py``'s stand-in: axis names and sizes."""

    def __init__(self, shape_map):
        self.shape = shape_map
        self.axis_names = tuple(shape_map)
        self.size = int(np.prod(list(shape_map.values())))


@pytest.mark.parametrize("case", [c for c in CASES if get_config(
    _arch(c[0])).moe is not None], ids=_ids)
def test_routing_is_the_same_on_every_gpu_and_one_gpu(ranks, case):
    out, res = ranks
    want = _one_gpu(out, case[0])["routing"]
    for r in res:
        got = r[case]["routing"]
        assert len(got) == len(want) == _cfg(case[0]).n_layers
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("name", ONESHOT)
@pytest.mark.parametrize("K", (2, 4))
def test_oneshot_tokens_equal_one_gpu(ranks, name, K):
    """``run_oneshot(..., mesh=)``: each node group serves its share of
    the 4 prompts (a frontend's prefix with them), and the gathered
    greedy tokens on every rank are the one-GPU path's."""
    out, res = ranks
    want = _oneshot(out, name)
    assert want.shape == (4, 6)
    for r in res:
        assert np.array_equal(r["oneshot", name, K], want)


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_faults_fail(ranks, fault):
    """A GPU caching the next model index's kv heads, the argmax over a
    GPU's own vocab slice (no gather), or attention's all-reduce dropped
    in decode: some step's logits or greedy tokens leave the one-GPU
    port's."""
    out, res = ranks
    name, K = FAULTS[fault]
    want = _one_gpu(out, name)
    bad = False
    for r in res:
        if fault not in r:
            continue
        for step in STEPS:
            lg = r[fault][step][0]
            w = want[step][0]
            bad |= lg.shape != w.shape or not _ulp_close(lg, w) or \
                not torch.equal(lg.argmax(-1), w.argmax(-1))
    assert bad


def _dry(shape, K):
    from repro_torch.launch import dryrun as D
    cfg = reduced(get_config("olmo-1b"), n_layers=2, d_model=64)
    return D.run_one("olmo-1b", shape, nodes=2, batch=2, seq=64,
                     device="cpu", cfg=cfg, model_parallel=K)


@pytest.mark.parametrize("shape", ("decode_32k", "prefill_32k"))
def test_dry_run_serves_on_the_model_axis(shape):
    """``dryrun --model-parallel 2`` of a serving shape: model index 0 of
    node group 0, its slices and its kv heads' cache (argument and peak
    bytes below one GPU a node's), the model group's all-reduces (one an
    attention and an MLP a layer, and the embedding's) and the logits'
    all-gather counted apart and in the rank's collectives."""
    one, two = _dry(shape, 1), _dry(shape, 2)
    assert (one["mesh"], one["n_devices"], one["batch_per_dev"]) == \
        ("2_gpus", 2, 2)
    assert (two["mesh"], two["n_devices"], two["batch_per_dev"]) == \
        ("2_gpus_tp2", 4, 2)
    assert two["layout"] == "node_over_gpus" and two["model_parallel"] == 2
    assert two["kv_heads_whole"] is False
    assert one["model_allreduce_calls"] == 0 and one["coll_raw"] == {}
    assert two["model_allreduce_calls"] == 2 * 2 + 1
    assert two["model_allgather_calls"] == 1
    assert two["argument_bytes"] < one["argument_bytes"]
    assert two["peak_bytes"] < one["peak_bytes"]
    assert two["coll_raw"]["all-reduce"] == \
        two["model_allreduce_bytes_per_dev"] > 0
    assert two["coll_raw"]["all-gather"] == \
        two["model_allgather_bytes_per_dev"] > 0


def test_dry_run_batch_one_runs_on_one_node_group():
    """``long_500k`` (batch 1) at K 2 runs on the model group alone, its
    cache's sequence whole (the sequence split is refused, ROADMAP.md)."""
    from repro_torch.launch import dryrun as D
    cfg = dataclasses.replace(reduced(get_config("gemma3-4b"), n_layers=2,
                                      d_model=64), subquadratic=True)
    rec = D.run_one("gemma3-4b", "long_500k", seq=64, device="cpu",
                    cfg=cfg, model_parallel=2)
    assert (rec["n_devices"], rec["batch_per_dev"]) == (2, 1)
    assert rec["note"] == D.NO_SEQ_SHARDING
    assert rec["model_allreduce_calls"] > 0
    assert INPUT_SHAPES["long_500k"].global_batch == 1
