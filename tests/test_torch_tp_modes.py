"""The non-blocking and overlapped supersteps on a node mesh with a model
axis, on the CPU: 2 nodes x K = 2 GPUs (4 gloo ranks, ``launch/mesh.py``
``init_node_mesh(..., model_parallel=2)``), each rank its slices of its
node, built by ``launch/train.py`` ``build(args, cfg, mesh=)`` with
``--nonblocking`` (Algorithm 2) or ``--nonblocking --overlap`` (the
pipelined steady state, primed by ``swarm_init``).

One ``torch.multiprocessing.spawn`` runs every case for 3 supersteps
(reduced gemma3-4b: kv heads split with the q heads; reduced
paligemma-3b: one kv head, ``wk`` / ``wv`` whole on both GPUs of a node);
the tests read what the ranks kept and hold it to the one-GPU port of the
same flags, run in this process:

* exact: every parameter, Γ and the losses within EXACT_ULP ulp (of a
  leaf's largest magnitude) of the one-GPU run of 2 nodes, μ too; one case
  averages the momentum too (``SwarmConfig.average_momentum``);
* q8: each encode on each rank (the overlapped prologue's included) is
  bitwise the plain encode (``kernels/ref.py``) of the rank's own slices'
  packed buffer with the uniforms of its node's fold (the same on both GPUs
  of a node, not across nodes); every fused decode lands against the
  buffer the rank itself sent (Algorithm 2's stale S, in the overlapped
  pipeline the in-flight ``sbuf``), and each decoded coordinate of a row
  within the lattice's reach lies within one of the partner's lattice steps
  of the average of the two sent buffers, from superstep 1 (ROADMAP.md
  C 8: in superstep 0 the q8 exchange moves nothing); the comm copy an
  encode measures against is the buffer the rank sent at its last
  interaction;
* the leaves every GPU of a node holds whole are bitwise equal across its
  GPUs after every superstep, and the losses equal on every rank;
* planted faults, each failing its check: the overlapped landing against
  the post-local-step buffer instead of the stale ``sbuf``; the
  non-blocking comm copy refreshed to the post-interaction model instead
  of S; the encode's generator folded by the global rank;
* a non-blocking and an overlapped q8 run write the one-GPU checkpoint
  file through rank 0 (``Trainer.write_ckpt``, the pipeline drained by
  ``pipeline_epilogue``), and a run resumed from a mesh checkpoint (the
  codec state, the momentum and the encode's generator; the overlapped
  one re-primed by ``pipeline_prologue``) is bitwise the uninterrupted
  run.
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
from repro_torch.core import bucket as B
from repro_torch.core import swarm as SW
from repro_torch.core.exchange import transport_from_config
from repro_torch.kernels import ref as R
from repro_torch.launch import train
from repro_torch.models import TransformerLM, param_split
from repro_torch.models.convert import unshard_params
from repro_torch.optim import make_optimizer
from repro_torch.quant.codecs import LatticeCodec
from repro_torch.quant.schemes import ModularQuantConfig
from repro_torch.tree import tree_leaves, tree_map

NODES, K, STEPS = 2, 2, 3
WORLD = NODES * K
EXACT_ULP = 64
ULP = 2.0 ** -23
# name: (arch, transport, mode, q8, momentum averaged)
CASES = {
    "gemma_gather_nb_exact": ("gemma3-4b", "gather", "nonblocking", False,
                              False),
    "gemma_ppermute_overlap_exact": ("gemma3-4b", "ppermute", "overlap",
                                     False, False),
    "paligemma_gather_overlap_exact": ("paligemma-3b", "gather", "overlap",
                                       False, False),
    "gemma_gather_nb_exact_mom": ("gemma3-4b", "gather", "nonblocking",
                                  False, True),
    "gemma_gather_nb_q8": ("gemma3-4b", "gather", "nonblocking", True,
                           False),
    "gemma_gather_overlap_q8": ("gemma3-4b", "gather", "overlap", True,
                                False),
    "paligemma_ppermute_nb_q8": ("paligemma-3b", "ppermute", "nonblocking",
                                 True, False),
    "paligemma_gather_overlap_q8": ("paligemma-3b", "gather", "overlap",
                                    True, False),
}
EXACT = [c for c, v in CASES.items() if not v[3]]
Q8 = [c for c, v in CASES.items() if v[3]]
RESUME = ("gemma_gather_nb_q8", "gemma_gather_overlap_q8")
# planted faults: name -> (the case it runs on, the check it must fail)
FAULTS = {"land_on_post": "paligemma_gather_overlap_q8",
          "prev_to_post": "gemma_gather_nb_q8",
          "fold_by_rank": "paligemma_gather_overlap_q8"}


def _cfg(arch):
    return reduced(get_config(arch), n_layers=2, d_model=32)


def _argv(case):
    arch, impl, mode, q8, _ = CASES[case]
    argv = ["--arch", arch, "--nodes", str(NODES), "--steps", str(STEPS),
            "--H", "2", "--batch", "2", "--seq", "16", "--device", "cpu",
            "--gossip-impl", impl, "--seed", "3", "--nonblocking"]
    return argv + (["--overlap"] if mode == "overlap" else []) + \
        (["--quantize"] if q8 else [])


def _build(case, mesh=None):
    """The case's trainer (its step rebuilt with the momentum averaged
    where the case says: the driver has no flag for it)."""
    args = train.build_parser().parse_args(_argv(case))
    cfg = _cfg(CASES[case][0])
    tr = train.build(args, cfg, mesh=mesh)
    if CASES[case][4]:
        scfg = dataclasses.replace(tr.scfg, average_momentum=True)
        opt = make_optimizer("sgd", lr=args.lr, momentum=0.9,
                             state_dtype=cfg.opt_state_dtype)
        tp = None if mesh is None else mesh.model_shard
        tr.step = SW.make_swarm_step(
            scfg, TransformerLM(cfg, tp=tp).functional_loss, opt.update,
            lambda s: args.lr, transport_from_config(scfg, tr.graph,
                                                     args.seed, mesh=mesh),
            mesh=mesh, param_specs=tr.param_specs)
        tr.scfg = scfg
    return tr


def _clone(tree):
    return tree_map(lambda x: x.detach().clone(), tree)


class _Capture:
    """Every encode and fused decode of the rank's lattice codec: its
    inputs, the generator's state before the draw, and its outputs."""

    def __init__(self):
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
            cap.decodes.append({"y": ybuf.clone(),
                                "matched": matched_rows.clone(),
                                "out": out.clone()})
            return out
        LatticeCodec.encode, LatticeCodec.decode_avg = encode, decode_avg

    def close(self):
        LatticeCodec.encode, LatticeCodec.decode_avg = self.enc0, self.dec0


class _Plant:
    """A planted fault of the engine (None: nothing): ``land_on_post``
    decodes the overlapped landing against the post-local-step buffer
    instead of the in-flight stale ``sbuf``; ``prev_to_post`` refreshes the
    non-blocking comm copy to the post-interaction model instead of S;
    ``fold_by_rank`` folds the encode's generator by the global rank, not
    by the node. Patched before the step is built."""

    def __init__(self, fault):
        self.fault, self.undo = fault, []

    def _set(self, owner, name, value):
        self.undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def __enter__(self):
        from repro_torch.launch.mesh import NodeMesh
        cell = {}
        if self.fault == "land_on_post":
            mls0, dec0 = SW.make_local_steps, LatticeCodec.decode_avg

            def make_local_steps(*a, **kw):
                inner = mls0(*a, **kw)

                def local_steps(*b):
                    out = inner(*b)
                    cell["post"] = out[0]
                    return out
                return local_steps

            def decode_avg(codec, wire, ybuf, matched_rows=None, **kw):
                post = cell.pop("post", None)
                if post is not None:
                    ybuf = B.pack(B.build_layout(post, block=codec.block),
                                  post)
                return dec0(codec, wire, ybuf, matched_rows, **kw)
            self._set(SW, "make_local_steps", make_local_steps)
            self._set(LatticeCodec, "decode_avg", decode_avg)
        elif self.fault == "prev_to_post":
            combine0, select0 = SW.stale_combine, SW.select

            def stale_combine(*a):
                cell["post"] = out = combine0(*a)
                return out

            def select(active, new, old):
                return select0(active, cell.pop("post", new), old)
            self._set(SW, "stale_combine", stale_combine)
            self._set(SW, "select", select)
        elif self.fault == "fold_by_rank":
            fold = NodeMesh.fold_seed
            self._set(NodeMesh, "fold_seed", lambda m, rng: fold(
                dataclasses.replace(m, rank=m.world_rank), rng))
        return self

    def __exit__(self, *exc):
        for owner, name, value in reversed(self.undo):
            setattr(owner, name, value)


def _run(case, mesh, fault=None):
    """STEPS supersteps of `case` on this rank; -> its records."""
    cap = _Capture() if CASES[case][3] else None
    with _Plant(fault):
        tr = _build(case, mesh)
        steps = []
        for t in range(STEPS):
            m = tr.superstep(t)
            steps.append({"loss": float(m["loss"]),
                          "gamma": float(m["gamma"]),
                          "params": _clone(tr.state.params)})
    rec = {"steps": steps, "mu": mean_model_tree(tr.state.params,
                                                 mesh=mesh)}
    if cap is not None:
        cap.close()
        rec["encodes"], rec["decodes"] = cap.encodes, cap.decodes
    return rec, tr


def _resume_split(tr):
    specs = tr.param_specs
    return {"codec": {k: specs for k in ("params", "prev")},
            "opt": {"m": specs}, "rng": None}


def _resume_tree(tr, gen_state):
    """What a resume needs: the codec state (an overlapped state drained
    first), the momentum, and the encode's generator (a row a rank; every
    rank holds the same) as it stood when the in-flight payload was drawn
    — the generator's state before the last superstep in overlap mode,
    so the resumed prologue re-draws the same uniforms."""
    st = SW.pipeline_epilogue(tr.scfg, tr.state) if tr.scfg.overlap \
        else tr.state
    return {"codec": SW.codec_checkpoint_tree(st), "opt": st.opt,
            "rng": gen_state[None].clone()}


def _resume(case, mesh, path):
    """Two supersteps, a mesh checkpoint of what a resume needs, a fresh
    trainer restored from it, and its third superstep; -> the resumed
    run's parameters and loss."""
    first = _build(case, mesh)
    for t in range(STEPS - 1):
        before = first.enc_gen.get_state()
        first.superstep(t)
    overlap = first.scfg.overlap
    tree = _resume_tree(first, before if overlap
                        else first.enc_gen.get_state())
    save_checkpoint(path, tree, {"nodes": NODES, "step": STEPS - 1},
                    mesh=mesh, split=_resume_split(first))
    second = _build(case, mesh)
    back = load_checkpoint(path, _resume_tree(second,
                                              second.enc_gen.get_state()),
                           mesh=mesh, split=_resume_split(second))
    second.enc_gen.set_state(back["rng"][0].contiguous())
    st = SW.restore_codec_state(second.state, back["codec"])
    st = SW.SwarmState(st.params, back["opt"], st.prev, STEPS - 1)
    if overlap:
        st = SW.pipeline_prologue(second.scfg, st,
                                  mesh.fold_generator(second.enc_gen))
    second.state = st
    m = second.superstep(STEPS - 1)
    return {"params": _clone(second.state.params), "loss": float(m["loss"])}


def _rank(rank, port, out):
    from repro_torch.launch.mesh import init_node_mesh
    torch.set_num_threads(1)
    mesh = init_node_mesh("cpu", rank=rank, world_size=WORLD,
                          init_method=f"tcp://localhost:{port}",
                          model_parallel=K)
    recs = {}
    for case in CASES:
        recs[case], tr = _run(case, mesh)
        if case in RESUME:
            path = os.path.join(out, f"ckpt_{case}")
            tr.write_ckpt(path, STEPS)
            recs[case]["prev"] = _clone(
                SW.pipeline_epilogue(tr.scfg, tr.state).prev)
            recs[case]["resumed"] = _resume(
                case, mesh, os.path.join(out, f"resume_{case}"))
    for fault, case in FAULTS.items():
        recs[f"fault_{fault}"], _ = _run(case, mesh, fault)
    torch.save({"recs": recs, "node": mesh.rank,
                "index": mesh.model_index}, os.path.join(out, f"r{rank}.pt"))
    mesh.close()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tp_modes"))
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
    torch.set_num_threads(2)
    for case in EXACT:
        tr = _build(case)
        steps = []
        for t in range(STEPS):
            m = tr.superstep(t)
            steps.append({"loss": float(m["loss"]),
                          "gamma": float(m["gamma"]),
                          "params": _clone(tr.state.params)})
        res[case] = {"steps": steps, "mu": mean_model_tree(tr.state.params)}
    return res


def _gathered(recs, case, t=None, key="params"):
    """Superstep t's (None: the record's own `key`) node-stacked whole
    tree from the ranks' slices."""
    cfg = _cfg(CASES[case][0])
    nodes = []
    for n in range(NODES):
        shards = [recs[n * K + i][case]["steps"][t][key] if t is not None
                  else recs[n * K + i][case][key] for i in range(K)]
        nodes.append(unshard_params(shards, cfg, stacked=True))
    return tree_map(lambda *xs: torch.cat(xs), *nodes)


def _within_ulp(got, want, k):
    g, w = got.double(), want.double()
    scale = max(float(w.abs().max()), 1e-30)
    return float((g - w).abs().max()) <= k * ULP * scale


def _exact_ok(recs, one, case) -> bool:
    for t in range(STEPS):
        got = _gathered(recs, case, t)
        want = one["steps"][t]["params"]
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            if a.shape != b.shape or not _within_ulp(a, b, EXACT_ULP):
                return False
        for k in ("loss", "gamma"):
            w = one["steps"][t][k]
            if any(abs(rec[case]["steps"][t][k] - w) >
                   EXACT_ULP * ULP * abs(w) for rec in recs):
                return False
    return True


@pytest.mark.parametrize("case", EXACT)
def test_exact_superstep_matches_one_gpu(ranks, one_gpu, case):
    """Every parameter after every superstep, the loss and Γ within
    EXACT_ULP ulp of the one-GPU port's 2-node run of the same flags."""
    assert _exact_ok(ranks["recs"], one_gpu[case], case)


@pytest.mark.parametrize("case", EXACT)
def test_mean_model_matches_one_gpu(ranks, one_gpu, case):
    """μ on the mesh is the slice of the one-GPU μ, within EXACT_ULP ulp,
    the same on every node."""
    cfg = _cfg(CASES[case][0])
    shards = [ranks["recs"][i][case]["mu"] for i in range(K)]
    for n in range(1, NODES):
        for i in range(K):
            assert all(torch.equal(a, b) for a, b in zip(
                tree_leaves(ranks["recs"][n * K + i][case]["mu"]),
                tree_leaves(shards[i])))
    for a, b in zip(tree_leaves(unshard_params(shards, cfg)),
                    tree_leaves(one_gpu[case]["mu"])):
        assert _within_ulp(a, b, EXACT_ULP)


def _whole_same(recs, case, arch) -> bool:
    split = tree_leaves(param_split(_cfg(arch), K))
    for t in range(STEPS):
        for n in range(NODES):
            a, b = (tree_leaves(recs[n * K + i][case]["steps"][t]["params"])
                    for i in range(K))
            if not all(torch.equal(x, y) for d, x, y in zip(split, a, b)
                       if d is None):
                return False
    return True


@pytest.mark.parametrize("case", list(CASES))
def test_whole_leaves_bitwise_across_a_nodes_gpus(ranks, case):
    """A leaf every GPU of a node holds whole is bitwise the same on the
    node's GPUs after every superstep; the losses are the same on every
    rank."""
    recs = ranks["recs"]
    assert _whole_same(recs, case, CASES[case][0])
    for t in range(STEPS):
        assert len({rec[case]["steps"][t]["loss"] for rec in recs}) == 1


def _encodes_plain(recs, case) -> bool:
    """Every encode bitwise the plain encode of its buffer with the
    uniforms of its captured generator; the same uniforms on a node's
    GPUs, others across the nodes."""
    qc = ModularQuantConfig()
    n_enc = len(recs[0][case]["encodes"])
    for t in range(n_enc):
        us = []
        for r in range(WORLD):
            e = recs[r][case]["encodes"][t]
            g = torch.Generator()
            g.set_state(e["rng"])
            u = torch.rand(e["buf"].shape, generator=g)
            q, s = R.quantize_mod(e["buf"].reshape(-1, qc.block),
                                  e["prev"].reshape(-1, qc.block),
                                  u.reshape(-1, qc.block), safety=qc.safety,
                                  min_scale=qc.min_scale, bits=qc.bits)
            if not (torch.equal(q.reshape(e["q"].shape), e["q"]) and
                    torch.equal(s.reshape(e["s"].shape), e["s"])):
                return False
            us.append(u)
        if not all(torch.equal(us[n * K], us[n * K + i])
                   for n in range(NODES) for i in range(K)):
            return False
        if torch.equal(us[0], us[K]):
            return False
    return True


@pytest.mark.parametrize("case", Q8)
def test_q8_codes_are_the_plain_encode_of_the_ranks_slice(ranks, case):
    """Each encode on each rank (an overlapped run's prologue first, then
    one a superstep) is bitwise ``kernels/ref.py`` ``quantize_mod`` of the
    rank's own slices' packed buffer with the uniforms of its node's fold
    of the run's generator: the same on both GPUs of a node, not across
    nodes."""
    recs = ranks["recs"]
    overlap = CASES[case][2] == "overlap"
    assert len(recs[0][case]["encodes"]) == STEPS + overlap
    assert _encodes_plain(recs, case)


def _comm_copy_ok(recs, case) -> bool:
    """The comm copy each encode measures against is the buffer the rank
    sent at its last interaction (both nodes are matched every superstep
    of 2 nodes): encode t+1's prev is encode t's buffer."""
    for r in range(WORLD):
        enc = recs[r][case]["encodes"]
        if not all(torch.equal(enc[t + 1]["prev"], enc[t]["buf"])
                   for t in range(len(enc) - 1)):
            return False
    return True


@pytest.mark.parametrize("case", Q8)
def test_comm_copy_is_the_sent_buffer(ranks, case):
    assert _comm_copy_ok(ranks["recs"], case)


def _decode_readings(recs, case):
    """-> (every decode lands against the buffer its rank sent, every
    in-reach coordinate within one lattice step, the smallest in-reach
    share of matched rows) over supersteps 1.. (ROADMAP.md C 8)."""
    half = 1 << (ModularQuantConfig().bits - 1)
    against_sent, within, reach = True, True, []
    for t in range(1, STEPS):
        for r in range(WORLD):
            d = recs[r][case]["decodes"][t]
            node, i = divmod(r, K)
            partner = (1 - node) * K + i
            mine = recs[r][case]["encodes"][t]["buf"].reshape(-1, 256)
            pbuf = recs[partner][case]["encodes"][t]["buf"].reshape(-1, 256)
            ps = recs[partner][case]["encodes"][t]["s"].reshape(-1, 1)
            y = d["y"].reshape(-1, 256)
            out = d["out"].reshape(-1, 256)
            m = d["matched"].reshape(-1).bool()
            against_sent &= torch.equal(y, mine)
            ok = m & ((pbuf - y).abs().amax(dim=1) < half * ps[:, 0])
            tol = ps[ok] + 4 * ULP * torch.maximum(y[ok].abs(),
                                                   pbuf[ok].abs())
            within &= bool(((out[ok] - (y[ok] + pbuf[ok]) * 0.5).abs()
                            <= tol).all())
            reach.append(float(ok.sum()) / max(float(m.sum()), 1.0))
    return against_sent, within, min(reach)


@pytest.mark.parametrize("case", Q8)
def test_q8_decode_within_one_lattice_step_of_the_exact_average(ranks, case):
    """Every fused decode from superstep 1 lands against the buffer its
    rank sent, and every matched row within the lattice's reach (its
    partner's buffer less than 2^(bits-1) of the partner's steps from the
    rank's own, ``bucket.count_wraps``'s measure) lands within one of the
    partner's lattice steps of the average of the two sent buffers; most
    rows are within reach."""
    against_sent, within, reach = _decode_readings(ranks["recs"], case)
    assert against_sent and within and reach >= 0.5, (against_sent, within,
                                                      reach)


def test_planted_fault_landing_on_the_post_local_step_buffer(ranks):
    """The overlapped landing decoded against the post-local-step buffer:
    the decode no longer lands against the stale S its rank sent."""
    recs = [dict(r, case=r["fault_land_on_post"]) for r in ranks["recs"]]
    against_sent, _, _ = _decode_readings(recs, "case")
    assert not against_sent


def test_planted_fault_comm_copy_refreshed_to_the_post_interaction_model(
        ranks):
    """The non-blocking comm copy refreshed to the post-interaction model:
    the next encode measures against a buffer its rank never sent, and
    the decodes wrap."""
    recs = [dict(r, case=r["fault_prev_to_post"]) for r in ranks["recs"]]
    assert not _comm_copy_ok(recs, "case")
    assert _decode_readings(recs, "case")[2] < 0.5


def test_planted_fault_fold_by_rank_breaks_whole_leaves(ranks):
    """The encode's uniforms folded by the global rank: the two GPUs of a
    node round a whole leaf's rows differently, and it drifts apart."""
    recs = [dict(r, case=r["fault_fold_by_rank"]) for r in ranks["recs"]]
    assert not _whole_same(recs, "case", CASES[FAULTS["fold_by_rank"]][0])
    assert not _encodes_plain(recs, "case")


@pytest.mark.parametrize("case", RESUME)
def test_checkpoint_is_the_one_gpu_save(ranks, case, tmp_path):
    """The mesh's checkpoint of a non-blocking / overlapped q8 run (the
    pipeline drained) holds exactly what the one-GPU save of the gathered
    params and comm copy writes."""
    recs = ranks["recs"]
    path = os.path.join(ranks["out"], f"ckpt_{case}")
    cfg = _cfg(CASES[case][0])
    state = {"params": _gathered(recs, case, STEPS - 1),
             "prev": tree_map(lambda *xs: torch.cat(xs), *[
                 unshard_params([recs[n * K + i][case]["prev"]
                                 for i in range(K)], cfg, stacked=True)
                 for n in range(NODES)])}
    ref_path = str(tmp_path / "one_gpu")
    save_checkpoint(ref_path, state, load_metadata(path))
    with np.load(path + ".npz") as a, np.load(ref_path + ".npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            assert np.array_equal(a[k], b[k])
    with open(path + ".json") as f1, open(ref_path + ".json") as f2:
        assert f1.read() == f2.read()
    meta = load_metadata(path)
    assert meta["nodes"] == NODES and meta["codec"]["state"] == ["params",
                                                                 "prev"]


@pytest.mark.parametrize("case", RESUME)
def test_resumed_run_is_the_uninterrupted_run(ranks, case):
    """Resumed at superstep 2 from a mesh checkpoint: the third
    superstep's parameters and loss bitwise the uninterrupted run's on
    every rank."""
    for rec in ranks["recs"]:
        got, want = rec[case]["resumed"], rec[case]["steps"][-1]
        assert got["loss"] == want["loss"]
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(got["params"]), tree_leaves(want["params"])))


def _dry(K, **kw):
    from repro_torch.launch import dryrun as D
    cfg = dataclasses.replace(reduced(get_config("gemma3-4b"), n_layers=2,
                                      d_model=64), remat=True)
    return D.run_one("gemma3-4b", "train_4k", nodes=2, batch=2, seq=32,
                     device="cpu", cfg=cfg, model_parallel=K, **kw)


def test_dry_run_counts_the_in_flight_buffers_per_slice():
    """``dryrun --model-parallel 2 --overlap --quantize`` traces the
    pipelined superstep on model index 0 of node 0, and its state holds
    the rank's own in-flight buffers, packed from its slices: the stale
    ``sbuf`` and the comm copy ``prev`` (fp32, the slice's padded width
    each) and the wire (the slice's q8 payload) in place of the blocking
    run's comm-copy tree; each under the one-GPU node's."""
    recs = {(k, mode, q8): _dry(k, quantize=q8, nonblocking=mode != "bl",
                                overlap=mode == "ov")
            for k in (1, 2) for mode, q8 in (("bl", False), ("ov", False),
                                             ("ov", True), ("nb", True))}
    per_slice = {}
    for k in (1, 2):
        base = recs[k, "bl", False]["argument_bytes"]
        sbuf = recs[k, "ov", False]["argument_bytes"] - base
        q8 = recs[k, "ov", True]
        assert q8["overlap"] and q8["nonblocking"]
        assert q8["model_parallel"] == k
        # sbuf and prev fp32 of one padded width, and the wire
        assert q8["argument_bytes"] - base == \
            2 * sbuf + q8["wire_bytes_per_node"]
        # the wire: a code byte a coordinate and an fp32 scale a block
        n_pad = sbuf // 4
        assert q8["wire_bytes_per_node"] == n_pad + 4 * (n_pad // 256)
        per_slice[k] = sbuf
        # the non-blocking run keeps a comm-copy tree, not the buffers
        assert recs[k, "nb", True]["argument_bytes"] < q8["argument_bytes"]
    assert per_slice[1] / 2 <= per_slice[2] < per_slice[1]
    two = recs[2, "ov", True]
    assert two["mesh"] == "2_gpus_tp2" and two["model_allreduce_calls"] > 0
    assert two["coll_raw"]["send"] == two["wire_bytes_per_node"]


def test_dry_run_traces_the_per_leaf_oracle_on_the_model_axis():
    """``--gossip-impl gather_legacy`` on the model axis: the rank sends
    each leaf of its slices as its own message, the leaf's codes (a byte
    a coordinate, padded to its own blocks) and its scales."""
    from repro_torch.launch.mesh import ModelShard
    from repro_torch.models import init_params
    rec = _dry(2, quantize=True, gossip_impl="gather_legacy")
    assert rec["gossip"] == "gather_legacy" and rec["model_parallel"] == 2
    cfg = reduced(get_config("gemma3-4b"), n_layers=2, d_model=64)
    mine = init_params(torch.Generator().manual_seed(0), cfg, "cpu",
                       tp=ModelShard(K, 0, None))
    blocks = [-(-x.numel() // 256) for x in tree_leaves(mine)]
    assert rec["coll_raw"]["send"] == sum(260 * b for b in blocks)


def test_the_model_axis_table_keeps_a_line_per_run():
    """An overlapped q8 record on the model axis reads on its own line of
    ``roofline/table.py``'s model-axis table, beside the sweep's."""
    from repro_torch.roofline.table import model_axis_table
    gib = 2 ** 30

    def rec(K, peak, **flags):
        return {"arch": "gemma3-4b", "shape": "train_4k", "model_parallel": K,
                "mesh": "2_gpus" + (f"_tp{K}" if K > 1 else ""),
                "peak_bytes": peak * gib, "fits": peak <= 79.18,
                "kv_heads_whole": False, **flags}
    ov = dict(overlap=True, nonblocking=True, quantize=True, gossip="gather")
    table = model_axis_table([rec(1, 144.5), rec(2, 60.0),
                              rec(1, 160.0, **ov), rec(2, 70.5, **ov)])
    assert "| gemma3-4b | 2_gpus | 144.50 | K 8: - | K 2: 60.00 | no |" \
        in table
    assert "| gemma3-4b | 2_gpus (--overlap --quantize) | 160.00 | K 8: - " \
        "| K 2: 70.50 | no |" in table
