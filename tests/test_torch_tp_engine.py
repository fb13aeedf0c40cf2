"""The continuous-batching engine on a node split over K GPUs
(``serve/engine.py`` ``ServeEngine(..., tp=)``), on the CPU: gloo ranks of
``launch/mesh.py`` ``init_node_mesh(..., model_parallel=K)``, fp32,
reduced widths (d_model 32, 4 heads, 2 layers; gemma3-4b 6 layers with a
window of 8).

One ``torch.multiprocessing.spawn`` of 4 ranks runs two meshes in turn:
one node group of K = 4, then two node groups of K = 2, each group one
engine over its K GPUs' slices of the JAX package's weights
(``models/convert.py`` ``shard_params``). Six ragged prompts (1 to 8
tokens, 5 new tokens each) on 3 slots, in every mode, against the same
engine on one GPU with the whole weights:

* ``dense``, ``paged`` (pages of 4), ``chunked`` (chunks of 4) and
  ``paged_chunked`` under ``serve_openloop``'s arrivals (in model index
  0's time, ``ServeEngine.clock``), greedy: the tokens of every request
  equal, and no shape signature beyond one-GPU's;
* ``temperature`` (0.8, the engine's seeded generator), all requests
  queued at once: the same draws on every GPU and as one GPU's;
* ``live_swap``: a ``LiveSource`` over two nodes' stacked slices
  publishes a second model after 4 steps (each GPU its own slices); each
  request's tokens and generation equal one GPU's;
* ``follow_swap``: a ``CheckpointFollower`` with `tp` and `split` on a
  reduced training run's checkpoint directory (``launch/train.py
  --ckpt --ckpt-every 1``, two nodes), the second checkpoint landing
  after 4 steps: each GPU reads only its slices of each node's row, and
  its tokens and generations equal one GPU's follower engine's;
* the GPUs of a node group agree on every token and completion, and a
  GPU's KV bytes are one GPU's over K (kv heads split) or equal (a whole
  kv head shared);
* ``launch/serve.py`` ``run_continuous(..., mesh=)``: node group i serves
  requests i, i + n, ..., each as one GPU serves it;
* a planted fault fails by check, not by hanging: one GPU admits a
  request a step later than its peers (the mesh's collectives bounded by
  a timeout), and every GPU of the group raises the engine's
  out-of-step error.
"""
import dataclasses
import glob
import os
import shutil
import socket
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs import get_config, reduced
from repro_torch.models import param_split
from repro_torch.models.convert import params_from_numpy, shard_params
from repro_torch.tree import tree_map

WORLD = 4
GEMMA = "gemma3-4b@w8"
ARCHS = ("olmo-1b", GEMMA, "qwen3-moe-30b-a3b", "chatglm3-6b")
MODES = ("dense", "paged", "chunked", "paged_chunked", "temperature",
         "live_swap")
CASES = [(a, m, k) for k in (2, 4) for a in ARCHS for m in MODES
         if m in ("dense", "paged_chunked") or a == "olmo-1b"]
CASES += [("olmo-1b", "follow_swap", k) for k in (2, 4)]
LENS = (3, 8, 5, 1, 7, 4)
SWAP_AT = 4
FAULT = ("olmo-1b", 2)


def _arch(name):
    return name.split("@")[0]


def _variant(cfg, name):
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


def _ecfg(mode):
    from repro_torch.serve import EngineConfig
    return EngineConfig(
        max_slots=3, prompt_len=8, max_new_tokens=5, queue_depth=8,
        temperature=0.8 if mode == "temperature" else 0.0, seed=3,
        paged=mode.startswith("paged"), page_size=4,
        prefill_chunk=4 if mode.endswith("chunked") else 0)


def _requests(cfg):
    from repro_torch.serve import Request
    rng = np.random.default_rng(7)
    return [Request(i, rng.integers(0, cfg.vocab_size, (n,)).astype(
        np.int32)) for i, n in enumerate(LENS)]


def _np_params(out, name, which=0):
    return torch.load(os.path.join(out, f"params_{name}_{which}.pt"),
                      weights_only=False)


def _params(out, name, tp, which=0):
    whole = _np_params(out, name, which)
    if tp is not None:
        whole = shard_params(whole, _cfg(name), tp.size, tp.index)
    return params_from_numpy(whole, "cpu")


def _follow_dir(out, group):
    """The checkpoint directory node group `group`'s engine follows."""
    return os.path.join(out, f"follow_{group}")


def _land(out, group, n):
    """Checkpoint `n` of the reduced training run lands in `group`'s
    directory: the npz first, the json (the completion mark) last."""
    d = _follow_dir(out, group)
    os.makedirs(d, exist_ok=True)
    base = sorted(glob.glob(os.path.join(out, "run", "*.json")))[n][:-5]
    for ext in (".npz", ".json"):
        shutil.copy(base + ext, os.path.join(d, os.path.basename(base) +
                                              ext))


def _engine(out, name, mode, tp, group=0, leader=True):
    """The engine of `mode` and the source, if any, it swaps from."""
    from repro_torch.core.exchange import GossipTransport
    from repro_torch.launch.serve import params_like
    from repro_torch.serve import CheckpointFollower, LiveSource, ServeEngine
    cfg = _cfg(name)
    if mode == "live_swap":
        src = LiveSource(GossipTransport(2))
        src.publish(_stacked(out, name, tp, 0))
        return ServeEngine(cfg, _ecfg(mode), source=src, device="cpu",
                           tp=tp), src
    if mode == "follow_swap":
        if leader:
            _land(out, group, 0)
        src = CheckpointFollower(
            _follow_dir(out, group), params_like(cfg, tp), 2, device="cpu",
            tp=tp, split=None if tp is None else param_split(cfg, tp.size))
        return ServeEngine(cfg, _ecfg(mode), source=src, device="cpu",
                           tp=tp), src
    return ServeEngine(cfg, _ecfg(mode), params=_params(out, name, tp),
                       device="cpu", tp=tp), None


def _stacked(out, name, tp, which):
    """Two nodes' (slices of) parameters, stacked: the weights and a
    second draw."""
    a, b = _params(out, name, tp, which), _params(out, name, tp, which + 1)
    return tree_map(lambda x, y: torch.stack([x, y]), a, b)


def _drive(out, name, mode, tp, group=0, leader=True):
    """Run the six requests through `mode`'s engine -> {rid: (tokens,
    generation)}, the metrics and the KV bytes."""
    from repro_torch.serve.engine import serve_openloop
    engine, src = _engine(out, name, mode, tp, group, leader)
    reqs = _requests(_cfg(name))
    with torch.no_grad():
        if mode in ("dense", "paged", "chunked", "paged_chunked"):
            serve_openloop(engine, [(i * 0.002, r)
                                    for i, r in enumerate(reqs)])
        else:
            for r in reqs:
                assert engine.submit(r)
            for step in range(200):
                if not engine.queue and not engine.active_count:
                    break
                if step == SWAP_AT and mode == "live_swap":
                    src.publish(_stacked(out, name, tp, 1))
                if step == SWAP_AT and mode == "follow_swap" and leader:
                    _land(out, group, 1)
                engine.step()
    m = engine.metrics
    return ({c.rid: (c.tokens.tolist(), c.gen) for c in engine.completions},
            {"decode_misses": m.decode_cache_misses,
             "prefill_misses": m.prefill_cache_misses,
             "kv_bytes": m.kv_bytes, "completed": m.completed,
             "generations": sorted({c.gen for c in engine.completions})})


def _continuous_args():
    from types import SimpleNamespace
    return SimpleNamespace(
        device="cpu", slots=3, prompt_len=8, gen=5, queue_depth=8,
        temperature=0.0, seed=0, paged=True, page_size=4, kv_pages=None,
        prefill_chunk=4, requests=6, arrival_gap_ms=2.0, wait_s=5.0,
        source="oneshot")


def _continuous(out, tp=None, mesh=None):
    """``run_continuous`` of olmo-1b's weights -> {rid: tokens}."""
    from repro_torch.launch.serve import make_generators, run_continuous
    with torch.no_grad():
        done, _ = run_continuous(_cfg("olmo-1b"), _continuous_args(),
                                 make_generators(0, "cpu"), source=None,
                                 params=_params(out, "olmo-1b", tp),
                                 mesh=mesh)
    return {c.rid: c.tokens.tolist() for c in done}


def _late_admission(engine):
    """Planted fault: this GPU's engine admits its first request one step
    later than its peers."""
    admit0, skipped = engine._admit, []

    def admit(now):
        if engine.queue and not skipped:
            skipped.append(now)
            return
        admit0(now)
    engine._admit = admit


def _fault(out, tp):
    from repro_torch.serve import ServeEngine
    name = FAULT[0]
    engine = ServeEngine(_cfg(name), _ecfg("dense"),
                         params=_params(out, name, tp), device="cpu", tp=tp)
    if tp.index == 1:
        _late_admission(engine)
    for r in _requests(_cfg(name)):
        engine.submit(r)
    try:
        with torch.no_grad():
            engine.drain(50)
    except RuntimeError as e:
        return str(e)
    return None


def _run_mesh(rank, port, out, K, res):
    from repro_torch.launch.mesh import init_node_mesh
    mesh = init_node_mesh("cpu", rank=rank, world_size=WORLD,
                          init_method=f"tcp://localhost:{port}",
                          model_parallel=K, timeout=timedelta(seconds=60))
    tp = mesh.model_shard
    for name, mode, k in CASES:
        if k == K:
            res[name, mode, K] = _drive(out, name, mode, tp,
                                        group=f"{K}_{mesh.rank}",
                                        leader=tp.index == 0)
    res["continuous", K] = _continuous(out, tp, mesh)
    if K == FAULT[1]:
        res["fault"] = _fault(out, tp)
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
    from repro_torch.launch import train
    out = str(tmp_path_factory.mktemp("tp_engine"))
    for name in ARCHS:
        for which in (0, 1, 2):
            p = jax.device_get(jinit(jax.random.PRNGKey(20 + which),
                                     _jcfg(name)))
            torch.save(tree_map(np.asarray, p),
                       os.path.join(out, f"params_{name}_{which}.pt"))
    # a reduced training run of the port, checkpointing every superstep
    torch.manual_seed(0)
    train.main(["--arch", "olmo-1b", "--device", "cpu", "--reduced",
                "--layers", "2", "--d-model", "32", "--nodes", "2",
                "--steps", "2", "--batch", "2", "--seq", "16", "--ckpt",
                os.path.join(out, "run"), "--ckpt-every", "1"])
    mp.spawn(_rank, args=((_free_port(), _free_port()), out), nprocs=WORLD,
             join=True)
    return out, [torch.load(os.path.join(out, f"r{r}.pt"), weights_only=False)
                 for r in range(WORLD)]


_ONE_GPU = {}


def _one_gpu(out, name, mode):
    if (name, mode) not in _ONE_GPU:
        _ONE_GPU[name, mode] = _drive(out, name, mode, None,
                                      group=f"one_{mode}")
    return _ONE_GPU[name, mode]


def _ids(case):
    return "-".join(map(str, case))


def test_every_rank_ran_its_place(ranks):
    _, res = ranks
    assert [r["where", 4] for r in res] == [(0, i) for i in range(4)]
    assert [r["where", 2] for r in res] == [(0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_split_engine_serves_one_gpus_tokens(ranks, case):
    """Every request's tokens and generation on every GPU equal the
    one-GPU engine's; every request completes, with no shape signature
    beyond the one-GPU engine's."""
    out, res = ranks
    name, mode, K = case
    want, wm = _one_gpu(out, name, mode)
    assert len(want) == len(LENS)
    for r in res:
        got, m = r[case]
        assert got == want
        assert m["completed"] == len(LENS)
        assert (m["decode_misses"], m["prefill_misses"]) == \
            (wm["decode_misses"], wm["prefill_misses"]) == (0, 0)


@pytest.mark.parametrize("case", [c for c in CASES if c[1].endswith("swap")],
                         ids=_ids)
def test_a_swap_serves_both_generations(ranks, case):
    """The swap lands mid-run: requests admitted before it finish on the
    first model, later ones on the second, as on one GPU."""
    out, res = ranks
    _, m = res[0][case]
    assert m["generations"] == [1, 2]


@pytest.mark.parametrize("case", [c for c in CASES if c[1] in
                                  ("dense", "paged_chunked")], ids=_ids)
def test_kv_bytes_are_a_gpus(ranks, case):
    """A GPU's KV bank or pool holds its kv heads: one GPU's bytes over
    K where K divides n_kv_heads, one GPU's over n_kv_heads where a whole
    kv head is shared (chatglm3-6b at K 4)."""
    out, res = ranks
    name, mode, K = case
    _, wm = _one_gpu(out, name, mode)
    n_kv = _cfg(name).n_kv_heads
    for r in res:
        assert r[case][1]["kv_bytes"] * min(K, n_kv) == wm["kv_bytes"]


@pytest.mark.parametrize("K", (2, 4))
def test_run_continuous_splits_the_requests_over_node_groups(ranks, K):
    """``run_continuous(..., mesh=)``: each node group serves its share
    of the requests (i, i + n, ...), each as the one-GPU run serves it."""
    out, res = ranks
    want = _continuous(out)
    assert sorted(want) == list(range(6))
    for r in res:
        node = r["where", K][0]
        got = r["continuous", K]
        assert sorted(got) == list(range(node, 6, WORLD // K))
        assert all(got[rid] == want[rid] for rid in got)


def test_a_gpu_admitting_a_step_late_fails_by_check(ranks):
    """Model index 1 admits a step after its peer: the next check of the
    node's host state raises the engine's out-of-step error on both GPUs
    of each node group (before either posts a mismatched collective)."""
    _, res = ranks
    for r in res:
        assert r["fault"] is not None and "out of step" in r["fault"], \
            r["fault"]
