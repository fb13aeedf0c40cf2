"""The SwarmSGD superstep on a node mesh with a model axis, on the CPU: 2
nodes x K = 2 GPUs (4 gloo ranks, ``launch/mesh.py``
``init_node_mesh(..., model_parallel=2)``), each rank its slices of its
node (``models/split.py``), built by ``launch/train.py`` ``build(args,
cfg, mesh=)`` as the one-GPU driver builds its 2 nodes.

One ``torch.multiprocessing.spawn`` runs every case for 3 supersteps of
the blocking engine (reduced gemma3-4b: swa, QK-norm, kv heads split with
the q heads; reduced paligemma-3b: one kv head, so ``wk`` / ``wv`` whole on
both GPUs of a node); the tests read what the ranks kept and hold it to
the one-GPU port of the same flags, run in this process:

* exact, over ``gather`` and ``ppermute``: every parameter, Γ and the
  losses within EXACT_ULP ulp (of a leaf's largest magnitude) of the
  one-GPU run of 2 nodes, μ (``mean_model_tree(mesh=)``) too;
* q8: each rank's codes bitwise the plain encode (``kernels/ref.py``) of
  its own slice's packed buffer with the uniforms of its node's fold of
  the run's generator (the same on both GPUs of a node, the reference's
  ``P()`` key), and every decoded coordinate of a row within the
  lattice's reach within one lattice step of the exact average with its
  partner's buffer;
* the leaves every GPU of a node holds whole stay bitwise equal across
  its GPUs after every superstep; a planted fault (the encode's generator
  folded by the global rank) breaks that;
* the checkpoint the mesh writes (``Trainer.write_ckpt``) is bitwise the
  one-GPU save of the gathered state, loads back to each rank's slices,
  and loads in the JAX package.
"""
import dataclasses
import os
import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.checkpoint import (load_checkpoint, load_metadata,
                                    mean_model_tree, save_checkpoint)
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import ref as R
from repro_torch.launch import train
from repro_torch.models import param_split
from repro_torch.models.convert import unshard_params
from repro_torch.quant.schemes import ModularQuantConfig
from repro_torch.tree import tree_flatten, tree_leaves, tree_map

NODES, K, STEPS = 2, 2, 3
WORLD = NODES * K
EXACT_ULP = 64
ULP = 2.0 ** -23
CASES = {
    "gemma_gather_exact": ("gemma3-4b", "gather", False),
    "gemma_ppermute_exact": ("gemma3-4b", "ppermute", False),
    "gemma_gather_q8": ("gemma3-4b", "gather", True),
    "gemma_ppermute_q8": ("gemma3-4b", "ppermute", True),
    "paligemma_gather_q8": ("paligemma-3b", "gather", True),
    "paligemma_gather_exact": ("paligemma-3b", "gather", False),
}
EXACT = [c for c, (_, _, q) in CASES.items() if not q]
Q8 = [c for c, (_, _, q) in CASES.items() if q]
CKPT_CASE = "gemma_gather_q8"
FAULT_CASE = "paligemma_gather_q8"


def _cfg(arch):
    return reduced(get_config(arch), n_layers=2, d_model=32)


def _argv(case, out=None):
    arch, impl, q8 = CASES[case]
    argv = ["--arch", arch, "--nodes", str(NODES), "--steps", str(STEPS),
            "--H", "2", "--batch", "2", "--seq", "16", "--device", "cpu",
            "--gossip-impl", impl, "--seed", "3"]
    return argv + (["--quantize"] if q8 else [])


def _build(case, mesh=None):
    args = train.build_parser().parse_args(_argv(case))
    return train.build(args, _cfg(CASES[case][0]), mesh=mesh)


def _clone(tree):
    return tree_map(lambda x: x.detach().clone(), tree)


class _Capture:
    """Every encode and fused decode of the rank's lattice codec: its
    inputs, the generator's state before the draw, and its outputs."""

    def __init__(self):
        from repro_torch.quant.codecs import LatticeCodec
        self.cls = LatticeCodec
        self.enc0, self.dec0 = LatticeCodec.encode, LatticeCodec.decode_avg
        self.encodes, self.decodes = [], []
        cap = self

        def encode(codec, buf, prev_buf, rng, **kw):
            state = rng.get_state().clone()
            wire = cap.enc0(codec, buf, prev_buf, rng, **kw)
            cap.encodes.append({"buf": buf.clone(), "prev": prev_buf.clone(),
                                "rng": state, "q": wire[0].clone(),
                                "s": wire[1].clone()})
            return wire

        def decode_avg(codec, wire, ybuf, matched_rows=None, **kw):
            out = cap.dec0(codec, wire, ybuf, matched_rows, **kw)
            cap.decodes.append({"y": ybuf.clone(), "s": wire[1].clone(),
                                "matched": matched_rows.clone(),
                                "out": out.clone()})
            return out
        LatticeCodec.encode, LatticeCodec.decode_avg = encode, decode_avg

    def close(self):
        self.cls.encode, self.cls.decode_avg = self.enc0, self.dec0


def _run(case, mesh):
    """STEPS supersteps of `case` on this rank; -> its records."""
    cap = _Capture() if CASES[case][2] else None
    tr = _build(case, mesh)
    steps = []
    for t in range(STEPS):
        m = tr.superstep(t)
        steps.append({"loss": float(m["loss"]), "gamma": float(m["gamma"]),
                      "params": _clone(tr.state.params)})
    rec = {"steps": steps, "mu": mean_model_tree(tr.state.params,
                                                 mesh=mesh)}
    if cap is not None:
        cap.close()
        rec["encodes"], rec["decodes"] = cap.encodes, cap.decodes
    return rec, tr


def _rank(rank, port, out):
    from repro_torch.launch.mesh import NodeMesh, init_node_mesh
    torch.set_num_threads(1)
    mesh = init_node_mesh("cpu", rank=rank, world_size=WORLD,
                          init_method=f"tcp://localhost:{port}",
                          model_parallel=K)
    recs = {}
    for case in CASES:
        recs[case], tr = _run(case, mesh)
        if case == CKPT_CASE:
            path = os.path.join(out, "mesh_ckpt")
            tr.write_ckpt(path, STEPS)
            recs[case]["prev"] = _clone(tr.state.prev)
            tree = {"params": tr.state.params, "prev": tr.state.prev}
            split = {k: tr.param_specs for k in tree}
            back = load_checkpoint(path, tree, mesh=mesh, split=split)
            recs[case]["reload_bitwise"] = all(
                torch.equal(a, b) for a, b in zip(tree_leaves(back),
                                                  tree_leaves(tree)))
    # planted fault: the encode's uniforms folded by the global rank, not
    # by the node
    fold = NodeMesh.fold_seed
    NodeMesh.fold_seed = lambda self, rng: fold(
        dataclasses.replace(self, rank=self.world_rank), rng)
    recs["fault_fold_by_rank"], _ = _run(FAULT_CASE, mesh)
    NodeMesh.fold_seed = fold
    torch.save({"recs": recs, "node": mesh.rank,
                "index": mesh.model_index}, os.path.join(out, f"r{rank}.pt"))
    mesh.close()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tp_swarm"))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_rank, args=(port, out), nprocs=WORLD, join=True)
    got = [torch.load(os.path.join(out, f"r{r}.pt")) for r in range(WORLD)]
    assert [(g["node"], g["index"]) for g in got] == \
        [(r // K, r % K) for r in range(WORLD)]
    return {"out": out, "recs": [g["recs"] for g in got]}


@pytest.fixture(scope="module")
def one_gpu():
    """The one-GPU port of each exact case's flags: its records."""
    res = {}
    for case in EXACT + [CKPT_CASE]:
        torch.set_num_threads(2)
        tr = _build(case)
        steps = []
        for t in range(STEPS):
            m = tr.superstep(t)
            steps.append({"loss": float(m["loss"]),
                          "gamma": float(m["gamma"]),
                          "params": _clone(tr.state.params)})
        res[case] = {"steps": steps, "mu": mean_model_tree(tr.state.params),
                     "split": param_split(tr.cfg, K)}
    return res


def _gathered(recs, case, t):
    """Superstep t's node-stacked whole parameters from the ranks'
    slices."""
    cfg = _cfg(CASES[case][0])
    nodes = []
    for n in range(NODES):
        shards = [recs[n * K + i][case]["steps"][t]["params"]
                  for i in range(K)]
        nodes.append(unshard_params(shards, cfg, stacked=True))
    return tree_map(lambda *xs: torch.cat(xs), *nodes)


def _within_ulp(got, want, k):
    g, w = got.double(), want.double()
    scale = max(float(w.abs().max()), 1e-30)
    return float((g - w).abs().max()) <= k * ULP * scale


@pytest.mark.parametrize("case", EXACT)
def test_exact_superstep_matches_one_gpu(ranks, one_gpu, case):
    """Every parameter after every superstep, the loss and Γ within
    EXACT_ULP ulp of the one-GPU port's 2-node run of the same flags."""
    for t in range(STEPS):
        got = _gathered(ranks["recs"], case, t)
        want = one_gpu[case]["steps"][t]["params"]
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert a.shape == b.shape
            assert _within_ulp(a, b, EXACT_ULP), (case, t)
        for k in ("loss", "gamma"):
            w = one_gpu[case]["steps"][t][k]
            for rec in ranks["recs"]:
                g = rec[case]["steps"][t][k]
                assert abs(g - w) <= EXACT_ULP * ULP * abs(w), (case, t, k)


@pytest.mark.parametrize("case", EXACT)
def test_mean_model_matches_one_gpu(ranks, one_gpu, case):
    """μ on the mesh (each model index over its node group) is the slice
    of the one-GPU μ, within EXACT_ULP ulp."""
    cfg = _cfg(CASES[case][0])
    shards = [ranks["recs"][i][case]["mu"] for i in range(K)]
    mu = unshard_params(shards, cfg)
    for n in range(1, NODES):
        for i in range(K):
            assert all(torch.equal(a, b) for a, b in zip(
                tree_leaves(ranks["recs"][n * K + i][case]["mu"]),
                tree_leaves(shards[i])))
    for a, b in zip(tree_leaves(mu), tree_leaves(one_gpu[case]["mu"])):
        assert _within_ulp(a, b, EXACT_ULP)


@pytest.mark.parametrize("case", list(CASES))
def test_whole_leaves_bitwise_across_a_nodes_gpus(ranks, case):
    """A leaf every GPU of a node holds whole (norm scales, QK-norm, one
    kv head, the frontend's proj) is bitwise the same on the node's GPUs
    after every superstep, and the losses are the same on every rank."""
    split = tree_leaves(param_split(_cfg(CASES[case][0]), K))
    recs = ranks["recs"]
    n_whole = 0
    for t in range(STEPS):
        for n in range(NODES):
            a, b = (tree_leaves(recs[n * K + i][case]["steps"][t]["params"])
                    for i in range(K))
            for d, x, y in zip(split, a, b):
                if d is None:
                    n_whole += 1
                    assert torch.equal(x, y), (case, t, n)
        losses = {rec[case]["steps"][t]["loss"] for rec in recs}
        assert len(losses) == 1
    assert n_whole > 0


def test_paligemma_keeps_its_kv_head_whole():
    split = param_split(_cfg("paligemma-3b"), K)
    attn = split["blocks"]["layer_0"]["attn"]
    assert attn["wk"] is None and attn["wv"] is None
    assert attn["wq"] == 2 and attn["wo"] == 1
    gsplit = param_split(_cfg("gemma3-4b"), K)["blocks"]["layer_0"]["attn"]
    assert gsplit["wk"] == 2 and gsplit["q_norm"] is None


@pytest.mark.parametrize("case", Q8)
def test_q8_codes_are_the_plain_encode_of_the_ranks_slice(ranks, case):
    """Each encode on each rank: its buffer is the packed buffer of the
    rank's own slices (the one-GPU buffer's width over K, near enough),
    and its codes and scales are bitwise ``kernels/ref.py``
    ``quantize_mod`` of that buffer with the uniforms drawn from the
    node's fold of the run's generator, the same on both GPUs of the
    node and not across nodes."""
    recs = ranks["recs"]
    for t in range(STEPS):
        us = []
        for r in range(WORLD):
            e = recs[r][case]["encodes"][t]
            g = torch.Generator()
            g.set_state(e["rng"])
            u = torch.rand(e["buf"].shape, generator=g)
            qc = ModularQuantConfig()
            q, s = R.quantize_mod(e["buf"].reshape(-1, qc.block),
                                  e["prev"].reshape(-1, qc.block), u.reshape(
                                      -1, qc.block), safety=qc.safety,
                                  min_scale=qc.min_scale, bits=qc.bits)
            assert torch.equal(q.reshape(e["q"].shape), e["q"])
            assert torch.equal(s.reshape(e["s"].shape), e["s"])
            us.append(u)
        for n in range(NODES):
            assert torch.equal(us[n * K], us[n * K + 1])
        assert not torch.equal(us[0], us[K])


@pytest.mark.parametrize("case", Q8)
def test_q8_decode_within_one_lattice_step_of_the_exact_average(ranks, case):
    """Every matched row of each rank's fused decode that lies within the
    lattice's reach (its partner's buffer less than 2^(bits-1) of the
    partner's steps from the rank's own, ``bucket.count_wraps``'s
    measure; ROADMAP.md C 1 and C 7) lands within one of the partner's
    lattice steps of (own + partner's buffer) / 2, its partner the same
    model index of the matched node; an unmatched row keeps its own. Most
    rows are within reach."""
    recs = ranks["recs"]
    half = 1 << (ModularQuantConfig().bits - 1)
    reach = []
    for t in range(STEPS):
        for r in range(WORLD):
            d = recs[r][case]["decodes"][t]
            node, i = divmod(r, K)
            partner = (1 - node) * K + i
            pbuf = recs[partner][case]["encodes"][t]["buf"].reshape(-1, 256)
            ps = recs[partner][case]["encodes"][t]["s"].reshape(-1, 1)
            y = d["y"].reshape(-1, 256)
            out = d["out"].reshape(-1, 256)
            m = d["matched"].reshape(-1).bool()
            assert torch.equal(out[~m], y[~m])
            ok = m & ((pbuf - y).abs().amax(dim=1) < half * ps[:, 0])
            # one step, and a few ulp of the coordinates' own rounding
            # (a step at min_scale is below their ulp)
            tol = ps[ok] + 4 * ULP * torch.maximum(y[ok].abs(),
                                                   pbuf[ok].abs())
            assert bool(((out[ok] - (y[ok] + pbuf[ok]) * 0.5).abs()
                         <= tol).all()), (case, t, r)
            reach.append(float(ok.sum()) / max(float(m.sum()), 1.0))
    assert min(reach) >= 0.5, reach


def test_planted_fault_fold_by_rank_breaks_whole_leaves(ranks):
    """The encode's uniforms folded by the global rank: the two GPUs of a
    node round a whole leaf's rows differently, and it drifts apart."""
    split = tree_leaves(param_split(_cfg(CASES[FAULT_CASE][0]), K))
    recs = ranks["recs"]
    last = [tree_leaves(recs[r]["fault_fold_by_rank"]["steps"][-1]["params"])
            for r in range(K)]
    assert any(d is None and not torch.equal(x, y)
               for d, x, y in zip(split, *last))


def test_checkpoint_is_the_one_gpu_save(ranks, tmp_path):
    """The mesh's checkpoint file holds exactly what the one-GPU save of
    the gathered state writes (every array bitwise, the json the same);
    each rank reloads its own slices bitwise; the port's one-GPU loader
    and the JAX package's loader both read it."""
    recs, out = ranks["recs"], ranks["out"]
    path = os.path.join(out, "mesh_ckpt")
    assert all(rec[CKPT_CASE]["reload_bitwise"] for rec in recs)
    cfg = _cfg(CASES[CKPT_CASE][0])
    state = {"params": _gathered(recs, CKPT_CASE, STEPS - 1),
             "prev": tree_map(lambda *xs: torch.cat(xs), *[
                 unshard_params([recs[n * K + i][CKPT_CASE]["prev"]
                                 for i in range(K)], cfg, stacked=True)
                 for n in range(NODES)])}
    ref_path = str(tmp_path / "one_gpu")
    save_checkpoint(ref_path, state, load_metadata(path))
    like = tree_map(torch.zeros_like, state)
    loaded = load_checkpoint(path, like)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(loaded),
                                                 tree_leaves(state)))
    with np.load(path + ".npz") as a, np.load(ref_path + ".npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            assert np.array_equal(a[k], b[k])
    with open(path + ".json") as f1, open(ref_path + ".json") as f2:
        assert f1.read() == f2.read()
    import jax
    from repro.checkpoint import load_checkpoint as jload
    jlike = tree_map(lambda x: np.zeros(x.shape, np.float32), like)
    jtree = jload(path, jlike)
    for a, b in zip(jax.tree.leaves(jtree), tree_leaves(loaded)):
        assert np.array_equal(np.asarray(a), b.float().numpy())
    meta = load_metadata(path)
    assert meta["nodes"] == NODES and meta["codec"]["spec"] == "q8"
    assert tree_flatten(like)[1] == tree_flatten(loaded)[1]
