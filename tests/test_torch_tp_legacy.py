"""The reference's per-leaf oracles (``--gossip-impl gather_legacy`` and
``ppermute_legacy``) on a node mesh with a model axis, on the CPU: 2 nodes
x K = 2 GPUs (4 gloo ranks), each rank its slices of its node, built by
``launch/train.py`` ``build(args, cfg, mesh=)``, blocking and non-blocking,
exact and q8.

Each leaf crosses as its own message between the ranks of one model index
(``core/exchange.py`` ``_per_leaf_on_mesh``), and each quantized leaf is
encoded on the rank's slice of it, its uniforms drawn leaf by leaf from
the run's generator itself, the same on every rank (the reference's
per-leaf ``shard_map`` splits one key on every shard).

One ``torch.multiprocessing.spawn`` runs every case for 3 supersteps
(reduced gemma3-4b and paligemma-3b); the tests hold:

* exact: every parameter, Γ and the losses within EXACT_ULP ulp of the
  one-GPU port of the same flags (run in this process);
* q8: every leaf's codes and scales bitwise the plain encode
  (``kernels/ref.py``) of the rank's slice of the leaf, blocked on its
  own; the draws line up leaf by leaf on a node's GPUs (a split leaf's
  slices have one size on every GPU), so each leaf's uniforms are the
  same there; every decoded coordinate of a block within the lattice's
  reach lies within one of the partner's lattice steps of the partner's
  slice, from superstep 1 in a non-blocking run (ROADMAP.md C 8);
* whole leaves bitwise equal on a node's GPUs after every superstep; a
  planted fault (each rank's uniforms from its own generator) breaks it;
* the overlapped pipeline still refuses the per-leaf oracles.
"""
import os
import socket

import pytest
import torch
import torch.multiprocessing as mp
import torch.nn.functional as F

from repro_torch.configs import get_config, reduced
from repro_torch.core import exchange as E
from repro_torch.kernels import ref as R
from repro_torch.launch import train
from repro_torch.models import param_split
from repro_torch.models.convert import unshard_params
from repro_torch.quant.schemes import ModularQuantConfig
from repro_torch.tree import tree_leaves, tree_map

NODES, K, STEPS = 2, 2, 3
WORLD = NODES * K
EXACT_ULP = 64
ULP = 2.0 ** -23
# name: (arch, transport, non-blocking, q8)
CASES = {
    "gemma_gather_legacy_exact": ("gemma3-4b", "gather_legacy", False,
                                  False),
    "gemma_ppermute_legacy_nb_exact": ("gemma3-4b", "ppermute_legacy", True,
                                       False),
    "paligemma_gather_legacy_nb_exact": ("paligemma-3b", "gather_legacy",
                                         True, False),
    "gemma_gather_legacy_q8": ("gemma3-4b", "gather_legacy", False, True),
    "paligemma_ppermute_legacy_q8": ("paligemma-3b", "ppermute_legacy",
                                     False, True),
    "gemma_gather_legacy_nb_q8": ("gemma3-4b", "gather_legacy", True, True),
}
EXACT = [c for c, v in CASES.items() if not v[3]]
Q8 = [c for c, v in CASES.items() if v[3]]
FAULT_CASE = "paligemma_ppermute_legacy_q8"


def _cfg(arch):
    return reduced(get_config(arch), n_layers=2, d_model=32)


def _argv(case, overlap=False):
    arch, impl, nb, q8 = CASES[case]
    argv = ["--arch", arch, "--nodes", str(NODES), "--steps", str(STEPS),
            "--H", "2", "--batch", "2", "--seq", "16", "--device", "cpu",
            "--gossip-impl", impl, "--seed", "5"]
    return argv + (["--nonblocking"] if nb or overlap else []) + \
        (["--overlap"] if overlap else []) + (["--quantize"] if q8 else [])


def _build(case, mesh=None):
    args = train.build_parser().parse_args(_argv(case))
    return train.build(args, _cfg(CASES[case][0]), mesh=mesh)


class _Capture:
    """Every per-leaf encode (its leaf, comm copy, uniforms, codes and
    scales) and decode (the decoded leaf and its scales) of the rank."""

    def __init__(self):
        self.enc0, self.dec0 = E.encode_modular, E.decode_modular
        self.encodes, self.decodes = [], []
        cap = self

        def encode(cfg, x, ref, rng=None, *, u=None, lead=0):
            q, s = cap.enc0(cfg, x, ref, rng, u=u, lead=lead)
            cap.encodes.append({"x": x.clone(), "ref": ref.clone(),
                                "u": u.clone(), "q": q.clone(),
                                "s": s.clone()})
            return q, s

        def decode(cfg, q, s, y, *, lead=0):
            out = cap.dec0(cfg, q, s, y, lead=lead)
            cap.decodes.append({"s": s.clone(), "out": out.clone()})
            return out
        E.encode_modular, E.decode_modular = encode, decode

    def close(self):
        E.encode_modular, E.decode_modular = self.enc0, self.dec0


def _rank_generator_fault():
    """Planted fault: each rank's per-leaf uniforms from a generator of
    its own (seeded by its global rank), not the run's."""
    import torch.distributed as dist
    on_mesh0 = E._per_leaf_on_mesh

    def on_mesh(params, post, matched, quant, prev, rng, u, mesh, idle=False):
        if rng is not None:
            rng = torch.Generator().manual_seed(1000 + dist.get_rank())
        return on_mesh0(params, post, matched, quant, prev, rng, u, mesh,
                        idle)
    E._per_leaf_on_mesh = on_mesh
    return lambda: setattr(E, "_per_leaf_on_mesh", on_mesh0)


def _run(case, mesh):
    cap = _Capture() if CASES[case][3] else None
    tr = _build(case, mesh)
    steps = []
    for t in range(STEPS):
        m = tr.superstep(t)
        steps.append({"loss": float(m["loss"]), "gamma": float(m["gamma"]),
                      "params": tree_map(lambda x: x.detach().clone(),
                                         tr.state.params)})
    rec = {"steps": steps}
    if cap is not None:
        cap.close()
        rec["encodes"], rec["decodes"] = cap.encodes, cap.decodes
    return rec


def _rank(rank, port, out):
    from repro_torch.launch.mesh import init_node_mesh
    torch.set_num_threads(1)
    mesh = init_node_mesh("cpu", rank=rank, world_size=WORLD,
                          init_method=f"tcp://localhost:{port}",
                          model_parallel=K)
    recs = {case: _run(case, mesh) for case in CASES}
    undo = _rank_generator_fault()
    try:
        recs["fault_rank_generator"] = _run(FAULT_CASE, mesh)
    finally:
        undo()
    args = train.build_parser().parse_args(_argv(FAULT_CASE, overlap=True))
    try:
        train.build(args, _cfg(CASES[FAULT_CASE][0]), mesh=mesh)
        recs["overlap_refusal"] = None
    except ValueError as e:
        recs["overlap_refusal"] = str(e)
    torch.save({"recs": recs, "node": mesh.rank,
                "index": mesh.model_index}, os.path.join(out, f"r{rank}.pt"))
    mesh.close()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tp_legacy"))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(_rank, args=(port, out), nprocs=WORLD, join=True)
    got = [torch.load(os.path.join(out, f"r{r}.pt")) for r in range(WORLD)]
    assert [(g["node"], g["index"]) for g in got] == \
        [(r // K, r % K) for r in range(WORLD)]
    return [g["recs"] for g in got]


@pytest.fixture(scope="module")
def one_gpu():
    torch.set_num_threads(2)
    return {case: _run(case, None) for case in EXACT}


def _within_ulp(got, want, k):
    g, w = got.double(), want.double()
    scale = max(float(w.abs().max()), 1e-30)
    return float((g - w).abs().max()) <= k * ULP * scale


@pytest.mark.parametrize("case", EXACT)
def test_exact_superstep_matches_one_gpu(ranks, one_gpu, case):
    """Every parameter after every superstep, the loss and Γ within
    EXACT_ULP ulp of the one-GPU port's 2-node run of the same flags."""
    cfg = _cfg(CASES[case][0])
    for t in range(STEPS):
        nodes = [unshard_params([ranks[n * K + i][case]["steps"][t]["params"]
                                 for i in range(K)], cfg, stacked=True)
                 for n in range(NODES)]
        got = tree_map(lambda *xs: torch.cat(xs), *nodes)
        want = one_gpu[case]["steps"][t]["params"]
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert a.shape == b.shape and _within_ulp(a, b, EXACT_ULP), \
                (case, t)
        for k in ("loss", "gamma"):
            w = one_gpu[case]["steps"][t][k]
            for rec in ranks:
                assert abs(rec[case]["steps"][t][k] - w) <= \
                    EXACT_ULP * ULP * abs(w), (case, t, k)


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
    assert _whole_same(ranks, case, CASES[case][0])
    for t in range(STEPS):
        assert len({rec[case]["steps"][t]["loss"] for rec in ranks}) == 1


def _blocks(x, block):
    flat = x.to(torch.float32).reshape(-1)
    return F.pad(flat, (0, (-flat.numel()) % block)).reshape(-1, block)


@pytest.mark.parametrize("case", Q8)
def test_q8_leaf_codes_are_the_plain_encode_of_the_ranks_slice(ranks, case):
    """Every leaf's codes and scales bitwise ``kernels/ref.py``
    ``quantize_mod`` of the rank's slice of the leaf (blocked on its own)
    with the uniforms it drew; one leaf count a superstep on every rank,
    and each leaf's uniforms of one shape and bitwise equal on a node's
    GPUs (the draws line up leaf by leaf)."""
    qc = ModularQuantConfig()
    n_leaves = len(tree_leaves(ranks[0][case]["steps"][0]["params"]))
    for r in range(WORLD):
        encs = ranks[r][case]["encodes"]
        assert len(encs) == STEPS * n_leaves
        for e in encs:
            u = e["u"].reshape(-1, qc.block)
            q, s = R.quantize_mod(_blocks(e["x"], qc.block),
                                  _blocks(e["ref"], qc.block), u,
                                  safety=qc.safety, min_scale=qc.min_scale,
                                  bits=qc.bits)
            assert torch.equal(q.reshape(e["q"].shape), e["q"])
            assert torch.equal(s.reshape(e["s"].shape), e["s"])
    for n in range(NODES):
        a, b = (ranks[n * K + i][case]["encodes"] for i in range(K))
        assert all(x["u"].shape == y["u"].shape and torch.equal(x["u"], y["u"])
                   for x, y in zip(a, b))


@pytest.mark.parametrize("case", Q8)
def test_q8_leaf_decode_within_one_lattice_step_of_the_partners_slice(
        ranks, case):
    """Each decoded block within the lattice's reach (its scale times
    2^(bits-1) above its distance from the receiver's own slice) lies
    within one of the partner's lattice steps of the partner's slice; a
    non-blocking run from superstep 1 (ROADMAP.md C 8). Most blocks are
    within reach."""
    half = 1 << (ModularQuantConfig().bits - 1)
    nb = CASES[case][2]
    n_leaves = len(tree_leaves(ranks[0][case]["steps"][0]["params"]))
    reach = []
    for r in range(WORLD):
        node, i = divmod(r, K)
        partner = (1 - node) * K + i
        mine, theirs = ranks[r][case], ranks[partner][case]
        assert len(mine["decodes"]) == len(mine["encodes"])
        for j in range(int(nb) * n_leaves, len(mine["decodes"])):
            d, e, pe = mine["decodes"][j], mine["encodes"][j], \
                theirs["encodes"][j]
            out, px, y = (_blocks(v, 256) for v in (d["out"], pe["x"],
                                                     e["x"]))
            s = pe["s"].reshape(-1, 1)
            ok = (px - y).abs().amax(dim=1) < half * s[:, 0]
            tol = s + 4 * ULP * torch.maximum(px.abs(), y.abs())
            assert bool(((out - px).abs() <= tol)[ok].all()), (case, r, j)
            reach.append(float(ok.float().mean()))
    assert min(reach) >= 0.5, reach


def test_planted_fault_rank_generators_break_whole_leaves(ranks):
    """Each rank drawing its per-leaf uniforms from a generator of its
    own: the two GPUs of a node round a whole leaf differently."""
    recs = [dict(r, case=r["fault_rank_generator"]) for r in ranks]
    assert not _whole_same(recs, "case", CASES[FAULT_CASE][0])


def test_overlap_refuses_the_per_leaf_oracles(ranks):
    """``--overlap`` over a per-leaf oracle still raises on the model
    axis, as on one GPU (``GossipTransport.check_overlap``)."""
    for rec in ranks:
        assert rec["overlap_refusal"] is not None
        assert "per-leaf" in rec["overlap_refusal"] or \
            "legacy" in rec["overlap_refusal"], rec["overlap_refusal"]
