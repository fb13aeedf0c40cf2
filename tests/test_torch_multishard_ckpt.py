"""The port's node mesh over a long run, on the CPU: the whole swarm's mean
model, checkpoints and resume, and the chunk driver (``core/scan.py``)
on a mesh of 4 gloo ranks (``repro_torch/launch/mesh.py``, one node a
rank).

* The reference: one subprocess with 4 fake CPU devices writes a
  checkpoint of a node-stacked numpy tree with JAX's ``save_checkpoint``
  (fp32, bf16, uint16 wire rows, int32), takes its ``mean_model_tree`` and
  ``mean_model``, and runs one 2-superstep chunk of the linear-loss exact
  blocking engine through ``repro.core.scan.make_superstep_scan`` over
  its ``shard_map`` step; a second one reads the mesh-written files with
  JAX's ``load_checkpoint``.
* The port: one ``torch.multiprocessing.spawn`` of 4 gloo ranks runs
  every case; the tests rebuild the one-shard side in this process from
  what the ranks kept.

The contract: μ (``mean_model_tree`` / ``mean_model`` /
``make_mean_model_eval`` with ``mesh=``) bitwise the one-shard port's μ of
the gathered rows, within 1e-6 of JAX's; a mesh-written file bitwise the
one-shard save of the gathered state (every array and the json), read
bitwise by JAX; a load gives each rank its slab; mid-run resume per step,
chunked and across drivers, and the chunk itself, bitwise the
uninterrupted per-step mesh run on every rank; the mesh chunk within 4
ulp of the reference's scan. This file imports no JAX: the reference runs
in its own processes.
"""
import json
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.algorithms import make_algorithm
from repro_torch.algorithms.sgp import sgp_init_state
from repro_torch.checkpoint import (load_checkpoint, mean_model_tree,
                                    save_checkpoint)
from repro_torch.configs import get_config, reduced
from repro_torch.core import bucket as TB
from repro_torch.core import exchange as TE
from repro_torch.core.graph import make_graph
from repro_torch.core.potential import mean_model
from repro_torch.core.scan import GraphFolds, make_superstep_scan
from repro_torch.core.swarm import (SwarmConfig, SwarmState,
                                    codec_checkpoint_tree,
                                    make_mean_model_eval, pipeline_epilogue,
                                    restore_codec_state, swarm_init)
from repro_torch.launch.mesh import NodeMesh, init_node_mesh
from repro_torch.launch.train import presample_inputs
from repro_torch.models import TransformerLM, init_params
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import make_optimizer
from repro_torch.quant.schemes import ModularQuantConfig
from repro_torch.serve.source import CheckpointFollower, LiveSource
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten

ROOT = Path(__file__).resolve().parents[1]
N, H, LR, D, BATCH, SEQ = 4, 2, 0.05, 12, 4, 16
S, CHUNK = 8, 4                   # supersteps, chunk length
PERM = np.array([2, 3, 0, 1])
PAIRS = TB.pairs_from_perm(PERM)
GRAPH = make_graph("complete", N)
WCFG = reduced(get_config("transformer-wmt"), n_layers=1, d_model=32)
# case -> the run: algorithm, transport and SwarmConfig fields
CASES = {
    "gather_q8": dict(algo="swarm", impl="gather", quantize=True),
    "pool_overlap_geometric": dict(algo="swarm", impl="ppermute_pool",
                                   quantize=True, nonblocking=True,
                                   overlap=True, h_mode="geometric"),
    "compress_q8": dict(algo="swarm", impl="gather", quantize=True,
                        compress_state=True),
    "topk_nonblocking": dict(algo="swarm", impl="gather", quantize=True,
                             codec="topk:0.25", nonblocking=True),
    "sgp_q8": dict(algo="sgp", impl="gather", quantize=True),
    "dpsgd": dict(algo="dpsgd", impl="gather"),
}
SAVED = ("compress_q8", "topk_nonblocking", "sgp_q8",
         "pool_overlap_geometric")
CHUNKED = ("gather_q8", "pool_overlap_geometric", "dpsgd")
RESUMES = ("per_step", "chunked", "cross")

_REFERENCE = textwrap.dedent('''
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, "src")
    import pickle
    import jax, jax.numpy as jnp, numpy as np
    from repro.checkpoint import mean_model_tree, save_checkpoint
    from repro.compat import make_mesh_compat
    from repro.core import bucket as B
    from repro.core.potential import mean_model
    from repro.core.scan import make_superstep_scan
    from repro.core.swarm import SwarmConfig, make_swarm_step, swarm_init
    from repro.optim import make_optimizer

    N, H, LR, D, BATCH = 4, 2, 0.05, 12, 4
    PERM = np.array([2, 3, 0, 1])
    PAIRS = B.pairs_from_perm(PERM)
    path, jpath = sys.argv[1], sys.argv[2]
    rng = np.random.default_rng(31)
    tree = {"a": rng.normal(size=(N, 6, 16)).astype(np.float32),
            "b": jnp.asarray(rng.normal(size=(N, 7)), jnp.bfloat16),
            "codes": rng.integers(0, 65536, size=(2 * N, 256))
            .astype(np.uint16),
            "step": np.arange(N, dtype=np.int32)}
    save_checkpoint(jpath, tree, {"nodes": N})
    mu_in = {"a": jnp.asarray(tree["a"]), "b": tree["b"]}
    out = {"tree": jax.device_get(tree),
           "mu_tree": jax.device_get(mean_model_tree(mu_in)),
           "mu_leaf": jax.device_get(mean_model(mu_in))}

    # one 2-superstep chunk of the linear-loss exact blocking engine on
    # the reference's node mesh
    mesh = make_mesh_compat((N,), ("node",))
    scfg = SwarmConfig(n_nodes=N, H=H, gossip_impl="ppermute")
    opt = make_optimizer("sgd", lr=LR, momentum=0.9)
    loss = lambda p, mb: 0.5 * jnp.mean((mb["x"] @ p["w"] - mb["y"]) ** 2)
    init = lambda k: {"w": jax.random.normal(k, (D,)) * 0.3}
    r = np.random.default_rng(41)
    batch = {"x": r.normal(size=(2, N, H, BATCH, D)).astype(np.float32),
             "y": r.normal(size=(2, N, H, BATCH)).astype(np.float32)}
    with mesh:
        state = swarm_init(jax.random.PRNGKey(0), scfg, init, opt.init)
        step = make_swarm_step(scfg, loss, opt.update, lambda s: LR,
                               mesh=mesh, node_axes=("node",),
                               static_pairs=PAIRS)
        chunk = make_superstep_scan(step, donate=False)
        out["scan_before"] = jax.device_get((state.params, state.opt))
        state, _, ms = chunk(state, jax.random.PRNGKey(9),
                             jax.tree.map(jnp.asarray, batch),
                             jnp.asarray(np.stack([PERM, PERM])),
                             jnp.full((2, N), H, jnp.int32))
        out["scan_batch"] = batch
        out["scan_after"] = jax.device_get(state.params)
        out["scan_metrics"] = {k: np.asarray(ms[k]) for k in ("loss",
                                                             "gamma")}
    with open(path, "wb") as f:
        pickle.dump(out, f)
''')

# JAX's load_checkpoint of each named file, into `like` trees built from
# their specs: -> each leaf's (dtype, shape, bytes) in flatten order
_JAX_LOAD = textwrap.dedent('''
    import sys
    sys.path.insert(0, "src")
    import pickle
    import jax, jax.numpy as jnp, numpy as np
    from repro.checkpoint import load_checkpoint

    def like(spec):
        if isinstance(spec, dict):
            return {k: like(v) for k, v in spec.items()}
        if isinstance(spec, tuple):
            return tuple(like(v) for v in spec)
        dt, shape = spec            # a leaf: [dtype, shape]
        return jnp.zeros(shape, getattr(jnp, dt))

    with open(sys.argv[1], "rb") as f:
        specs = pickle.load(f)
    out = {}
    for name, (path, spec) in specs.items():
        got = load_checkpoint(path, like(spec))
        out[name] = [(str(a.dtype), a.shape, np.asarray(a).tobytes())
                     for a in jax.tree.leaves(got)]
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
''')


def _jax_env():
    return dict(os.environ, JAX_PLATFORMS="cpu")


# ---------------------------------------------------------------------------
# The runs (shared by the ranks and the one-shard side)
# ---------------------------------------------------------------------------


def _linear_loss(p, mb):
    return 0.5 * torch.mean((mb["x"] @ p["w"] - mb["y"]) ** 2)


def _linear_init(gen):
    return {"w": 0.3 * torch.randn((D,), generator=gen)}


def _wmt_loss():
    return TransformerLM(WCFG).functional_loss


def _wmt_init(gen):
    return init_params(gen, WCFG, "cpu")


def _scfg(case) -> SwarmConfig:
    c = CASES[case]
    return SwarmConfig(n_nodes=N, H=H, h_mode=c.get("h_mode", "fixed"),
                       h_max=4, quantize=c.get("quantize", False),
                       quant=ModularQuantConfig(safety=16.0),
                       codec=c.get("codec"),
                       nonblocking=c.get("nonblocking", False),
                       overlap=c.get("overlap", False),
                       compress_state=c.get("compress_state", False),
                       gossip_impl=c["impl"], pool_size=4)


class _Run:
    """One run of `case` on `mesh` (None: one shard): its step, transport,
    state, the run's generator and the presampled (perm, h) rows."""

    def __init__(self, case, mesh, *, wmt=False, seed=0):
        self.case, self.mesh, self.wmt = case, mesh, wmt
        self.scfg = scfg = _scfg(case)
        c = CASES[case]
        self.opt = opt = make_optimizer("sgd", lr=LR, momentum=0.9)
        kw = {}
        if c["impl"] == "ppermute_pool":
            kw["matching_pool"] = TE.make_matching_pool(GRAPH, 4, seed)
        self.tr = TE.GossipTransport(N, impl=c["impl"], quant=scfg.quant,
                                     codec=scfg.make_codec(), mesh=mesh, **kw)
        self.loss = _wmt_loss() if wmt else _linear_loss
        akw = dict(loss_fn=self.loss, opt_update=opt.update,
                   lr_fn=lambda s: LR, n_nodes=N, transport=self.tr,
                   mesh=mesh)
        if c["algo"] == "swarm":
            akw["scfg"] = scfg
        if c["algo"] == "dpsgd":
            akw["graph"] = make_graph("ring", N)
        if c["algo"] == "sgp":
            akw["quantize"] = scfg.quantize
        self.step = make_algorithm(c["algo"], **akw)
        self.gen = torch.Generator().manual_seed(seed)
        self.state = swarm_init(self.gen, scfg,
                                _wmt_init if wmt else _linear_init, opt.init,
                                mesh=mesh)
        if c["algo"] == "sgp":
            self.state = sgp_init_state(self.state, N, scfg.quantize,
                                        mesh=mesh)
        self.perms, self.hs = presample_inputs(
            scfg, GRAPH, np.random.default_rng(seed), S, seed=seed)
        self.chunker = None

    def batch(self, t) -> dict:
        """Superstep t's batch: the global one on one shard, the rank's
        node on a mesh."""
        hb = self.scfg.h_loop_bound
        r = np.random.default_rng(100 + t)
        if self.wmt:
            tok = r.integers(0, WCFG.vocab_size, size=(N, hb, BATCH, SEQ + 1))
            b = {"tokens": tok[..., :-1], "targets": tok[..., 1:]}
        else:
            b = {"x": r.normal(size=(N, hb, BATCH, D)).astype(np.float32),
                 "y": r.normal(size=(N, hb, BATCH)).astype(np.float32)}
        rows = slice(None) if self.mesh is None else \
            slice(self.mesh.rank, self.mesh.rank + 1)
        return {k: torch.from_numpy(np.ascontiguousarray(v[rows]))
                for k, v in b.items()}

    def per_step(self, t0, t1) -> list:
        ms = []
        for t in range(t0, t1):
            self.state, m = self.step(self.state, self.batch(t),
                                      self.perms[t], self.hs[t], self.gen)
            ms.append({k: float(v) for k, v in m.items()})
        return ms

    def chunked(self, t0, t1) -> list:
        if self.chunker is None:
            self.chunker = make_superstep_scan(self.step)
        ms = []
        for t in range(t0, t1, CHUNK):
            k = min(CHUNK, t1 - t)
            batch = {n: torch.stack([self.batch(s)[n]
                                     for s in range(t, t + k)])
                     for n in self.batch(t)}
            self.state, m = self.chunker(self.state, self.gen, batch,
                                         self.perms[t:t + k],
                                         self.hs[t:t + k])
            ms.extend({n: float(v[i]) for n, v in m.items()}
                      for i in range(k))
        return ms

    def ckpt_tree(self) -> dict:
        """What a resume needs: the codec tree (an overlapped state
        drained first), the momentum and the run's generator state (a
        rank's row; every rank holds the same)."""
        st = pipeline_epilogue(self.scfg, self.state) \
            if self.scfg.overlap else self.state
        return {"codec": codec_checkpoint_tree(st), "opt": st.opt,
                "rng": self.gen.get_state()[None].clone()}

    def restore(self, tree, t) -> None:
        st = restore_codec_state(self.state, tree["codec"])
        self.state = SwarmState(st.params, tree["opt"], st.prev, t,
                                st.inflight, st.residual)
        self.gen.set_state(tree["rng"][0].contiguous())


def _meta(run, t) -> dict:
    return {"nodes": N, "step": t, "algo": CASES[run.case]["algo"],
            "codec": {"spec": run.scfg.codec or "q8",
                      "state": sorted(codec_checkpoint_tree(run.state)),
                      "compress_state": run.scfg.compress_state}}


def _leaves(tree) -> list:
    """Tensors of a tree in flatten order, into tuples (a wire) too."""
    return tree_flatten(tree, tuples=True)[0]


def _state_leaves(st) -> list:
    return [x for f in ("params", "opt", "prev", "residual", "inflight")
            for x in _leaves(getattr(st, f) or {})]


def _linear_eval_batch() -> dict:
    r = np.random.default_rng(7)
    return {"x": torch.from_numpy(r.normal(size=(BATCH, D))
                                  .astype(np.float32)),
            "y": torch.from_numpy(r.normal(size=(BATCH,)).astype(np.float32))}


def _wmt_eval_batch() -> dict:
    r = np.random.default_rng(8)
    tok = r.integers(0, WCFG.vocab_size, size=(BATCH, SEQ + 1))
    return {"tokens": torch.from_numpy(tok[:, :-1]),
            "targets": torch.from_numpy(tok[:, 1:])}


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------


def _rank_main(rank, workdir):
    torch.set_num_threads(1)
    mesh = init_node_mesh("cpu", rank=rank, world_size=N,
                          init_method=f"file://{workdir}/rendezvous")
    with open(f"{workdir}/ref.pkl", "rb") as f:
        ref = pickle.load(f)
    out = {}
    try:
        _rank_mean_and_save(out, mesh, workdir)
        _rank_jax_file(out, mesh, workdir)
        _rank_codec_states(out, mesh, workdir)
        _rank_resume(out, mesh, workdir)
        _rank_chunks(out, mesh)
        _rank_reference_scan(out, mesh, ref)
    finally:
        mesh.close()
    torch.save(out, f"{workdir}/rank{rank}.pt")


def _rank_mean_and_save(out, mesh, workdir):
    """After one gather q8 superstep (the nodes differ): μ three ways, the
    live source's μ, the save and the load of what a resume needs."""
    for model in ("linear", "wmt"):
        run = _Run("gather_q8", mesh, wmt=model == "wmt")
        run.per_step(0, 1)
        params = run.state.params
        ev = _wmt_eval_batch() if run.wmt else _linear_eval_batch()
        live = LiveSource(run.tr)
        live.publish(params)
        out[("mu", model)] = {
            "rows": params, "tree": mean_model_tree(params, mesh=mesh),
            "leaf": mean_model(params, mesh=mesh),
            "eval": make_mean_model_eval(run.loss, mesh=mesh)(params, ev),
            "live": live.poll().params}
        if model == "wmt":
            continue
        # the driver's checkpoint (a follower reads it), and what a
        # resume needs
        save_checkpoint(f"{workdir}/ckpt/step_000001",
                        codec_checkpoint_tree(run.state), _meta(run, 1),
                        mesh=mesh)
        tree = run.ckpt_tree()
        save_checkpoint(f"{workdir}/ck_engine", tree, _meta(run, 1),
                        mesh=mesh)
        out[("saved", "engine")] = tree
        out[("loaded", "engine")] = load_checkpoint(f"{workdir}/ck_engine",
                                                    tree, mesh=mesh)


def _rank_jax_file(out, mesh, workdir):
    """The slab of JAX's file, its μ on the mesh, and its save back."""
    like = {"a": torch.zeros(1, 6, 16), "b": torch.zeros(1, 7,
                                                          dtype=torch.bfloat16),
            "codes": torch.zeros(2, 256, dtype=torch.uint16),
            "step": torch.zeros(1, dtype=torch.int32)}
    slab = load_checkpoint(f"{workdir}/jax_ckpt", like, mesh=mesh)
    out[("loaded", "jaxtree")] = slab
    mu_in = {"a": slab["a"], "b": slab["b"]}
    out["jax_mu"] = {"tree": mean_model_tree(mu_in, mesh=mesh),
                     "leaf": mean_model(mu_in, mesh=mesh)}
    save_checkpoint(f"{workdir}/ck_jaxtree", slab, {"nodes": N}, mesh=mesh)
    out[("saved", "jaxtree")] = slab


def _rank_codec_states(out, mesh, workdir):
    """Two supersteps of each codec state's run, saved and loaded."""
    for case in SAVED:
        run = _Run(case, mesh)
        run.per_step(0, 2)
        tree = run.ckpt_tree()
        save_checkpoint(f"{workdir}/ck_{case}", tree, _meta(run, 2),
                        mesh=mesh)
        out[("saved", case)] = tree
        out[("loaded", case)] = load_checkpoint(f"{workdir}/ck_{case}", tree,
                                                mesh=mesh)
        if case == "compress_q8":
            # the comm copy's wire rows of this rank's params with given
            # uniforms: node-contiguous, so rank order is the one-shard
            # layout
            lay = TB.build_layout(run.state.params)
            u = np.random.default_rng(5).random((N, lay.n_padded))
            out["wire_rows"] = (run.state.params,
                                run.tr.codec.encode_state(
                                    TB.pack(lay, run.state.params), None,
                                    u=torch.from_numpy(
                                        u[mesh.rank:mesh.rank + 1]
                                        .astype(np.float32))))


def _rank_resume(out, mesh, workdir):
    """gather q8 blocking: the uninterrupted per-step run, and resumes at
    S/2 (per step, chunked, across drivers) from a mesh checkpoint into a
    fresh run; --eval-mean at the chunk boundary."""
    full = _Run("gather_q8", mesh)
    out["full_metrics"] = full.per_step(0, S // 2)
    ev = make_mean_model_eval(_linear_loss, mesh=mesh)
    out["eval_per_step"] = ev(full.state.params, _linear_eval_batch())
    out["full_metrics"] += full.per_step(S // 2, S)
    out["full"] = _state_leaves(full.state)
    for how in RESUMES:
        first = _Run("gather_q8", mesh)
        if how == "per_step":
            first.per_step(0, S // 2)
        else:
            first.chunked(0, S // 2)
        if how == "chunked":
            out["eval_chunk_boundary"] = ev(first.state.params,
                                            _linear_eval_batch())
        path = f"{workdir}/resume_{how}"
        save_checkpoint(path, first.ckpt_tree(), _meta(first, S // 2),
                        mesh=mesh)
        if first.chunker is not None:
            first.chunker.close()          # every rank, before the next
        second = _Run("gather_q8", mesh)
        second.restore(load_checkpoint(path, second.ckpt_tree(), mesh=mesh),
                       S // 2)
        ms = second.per_step(S // 2, S) if how != "chunked" \
            else second.chunked(S // 2, S)
        out[("resume", how)] = (_state_leaves(second.state), ms)


def _rank_chunks(out, mesh):
    """Each chunked case per step and chunked (chunks of 4) from the same
    state; the chunk driver's graph keys."""
    for case in CHUNKED:
        per, chk = _Run(case, mesh), _Run(case, mesh)
        ms_per = per.per_step(0, S)
        ms_chk = chk.chunked(0, S)
        keys = [chk.step.graph_key(None, tuple(int(x) for x in h), p)
                if case != "dpsgd" else None
                for p, h in zip(chk.perms, chk.hs)]
        out[("chunk", case)] = (_state_leaves(per.state), ms_per,
                                _state_leaves(chk.state), ms_chk, keys)


def _rank_reference_scan(out, mesh, ref):
    """The reference's exact blocking chunk on the mesh: ppermute by the
    static pairs, from its state and batches."""
    scfg = SwarmConfig(n_nodes=N, H=H, gossip_impl="ppermute")
    opt = make_optimizer("sgd", lr=LR, momentum=0.9)
    tr = TE.GossipTransport(N, impl="ppermute", static_pairs=PAIRS,
                            mesh=mesh)
    step = make_algorithm("swarm", loss_fn=_linear_loss,
                          opt_update=opt.update, lr_fn=lambda s: LR,
                          n_nodes=N, scfg=scfg, transport=tr, mesh=mesh)
    r = slice(mesh.rank, mesh.rank + 1)
    params, mom = (params_from_numpy(tree_map(lambda a: a[r], x), "cpu")
                   for x in ref["scan_before"])
    state = SwarmState(params, mom, None, 0)
    batch = {k: torch.from_numpy(np.ascontiguousarray(v[:, r]))
             for k, v in ref["scan_batch"].items()}
    state, ms = make_superstep_scan(step)(
        state, None, batch, np.stack([PERM, PERM]), np.full((2, N), H))
    out["reference_scan"] = (state.params, {k: v for k, v in ms.items()})


# ---------------------------------------------------------------------------
# Fixtures
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("multishard_ckpt")


@pytest.fixture(scope="module")
def ref(workdir):
    path = workdir / "ref.pkl"
    res = subprocess.run([sys.executable, "-c", _REFERENCE, str(path),
                          str(workdir / "jax_ckpt")], cwd=ROOT,
                         env=_jax_env(), capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def ranks(ref, workdir):
    mp.spawn(_rank_main, args=(str(workdir),), nprocs=N, join=True)
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False)
            for r in range(N)]


def _cat(trees):
    """The ranks' slabs of one tree, concatenated along dim 0 in rank
    order: the whole swarm's tree on one shard."""
    flat = [tree_flatten(t, tuples=True) for t in trees]
    return tree_unflatten(flat[0][1], [torch.cat(xs) for xs in
                                       zip(*[lv for lv, _ in flat])])


def _same(a, b) -> bool:
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.uint16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a.reshape(-1).view(torch.uint8),
                       b.reshape(-1).view(torch.uint8))


def _same_tree(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(_same(x, y) for x, y in zip(la, lb))


def _one_shard_file(tmp, name, ranks, meta):
    """The one-shard save of the ranks' gathered tree: -> its path."""
    path = str(tmp / f"one_{name}")
    save_checkpoint(path, _cat([r[("saved", name)] for r in ranks]), meta)
    return path


SAVES = ("engine", "jaxtree") + SAVED


def _mesh_path(workdir, name):
    return f"{workdir}/ck_{name}"


# ---------------------------------------------------------------------------
# The mean model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", ["linear", "wmt"])
def test_mean_model_tree_is_the_whole_swarms(ranks, model):
    """A rank's μ is the whole swarm's, bitwise the one-shard μ of the
    gathered rows, on every rank — not the rank's own row."""
    stacked = _cat([r[("mu", model)]["rows"] for r in ranks])
    want = mean_model_tree(stacked)
    for r, res in enumerate(ranks):
        assert _same_tree(res[("mu", model)]["tree"], want), r
        own = tree_map(lambda x: x[0], res[("mu", model)]["rows"])
        assert not _same_tree(res[("mu", model)]["tree"], own), r


@pytest.mark.parametrize("model", ["linear", "wmt"])
def test_mean_model_per_leaf_is_the_whole_swarms(ranks, model):
    stacked = _cat([r[("mu", model)]["rows"] for r in ranks])
    for res in ranks:
        assert _same_tree(res[("mu", model)]["leaf"], mean_model(stacked))


@pytest.mark.parametrize("model", ["linear", "wmt"])
def test_mean_model_eval_reports_the_whole_swarm(ranks, model):
    """μ's loss bitwise the one-shard evaluation's; the node losses
    (every rank's own, all-gathered) within 1e-6 of the one-shard vmap."""
    stacked = _cat([r[("mu", model)]["rows"] for r in ranks])
    loss = _wmt_loss() if model == "wmt" else _linear_loss
    ev = _wmt_eval_batch() if model == "wmt" else _linear_eval_batch()
    want = make_mean_model_eval(loss)(stacked, ev)
    for res in ranks:
        got = res[("mu", model)]["eval"]
        assert _same(got["loss_mean_model"], want["loss_mean_model"])
        for k in ("loss_node_mean", "loss_node_worst"):
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=0, atol=1e-6)


def test_mean_model_matches_jax(ref, ranks):
    """μ of JAX's node-stacked tree, loaded a slab a rank: bitwise the
    one-shard port's, within 1e-6 of JAX's mean_model_tree and
    mean_model."""
    full = params_from_numpy({"a": ref["tree"]["a"],
                              "b": np.asarray(ref["tree"]["b"], np.float32)},
                             "cpu")
    full["b"] = full["b"].to(torch.bfloat16)
    for res in ranks:
        got = res["jax_mu"]
        assert _same_tree(got["tree"], mean_model_tree(full))
        assert _same_tree(got["leaf"], mean_model(full))
        for form in ("tree", "leaf"):
            for k in ("a", "b"):
                np.testing.assert_allclose(
                    got[form][k].float().numpy(),
                    np.asarray(ref[f"mu_{form}"][k], np.float32),
                    rtol=0, atol=1e-6)


def test_live_source_is_the_followers_mean(ranks, workdir):
    """The live source on the mesh publishes the follower's μ of the
    mesh-written checkpoint, bitwise, on every rank."""
    like = tree_map(lambda x: x[0], ranks[0][("mu", "linear")]["rows"])
    follower = CheckpointFollower(str(workdir / "ckpt"), like, N,
                                  device="cpu")
    upd = follower.poll()
    assert upd is not None
    for res in ranks:
        assert _same_tree(res[("mu", "linear")]["live"], upd.params)
        assert _same_tree(res[("mu", "linear")]["live"],
                          res[("mu", "linear")]["tree"])


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", SAVES)
def test_mesh_save_is_the_one_shard_save(ranks, workdir, tmp_path, name):
    """Rank 0 writes the one-shard file of the gathered state: every
    array and the json (names, dtypes, treedef, metadata)."""
    mesh_path = _mesh_path(workdir, name)
    with open(mesh_path + ".json") as f:
        meta = json.load(f)
    one = _one_shard_file(tmp_path, name, ranks, meta["metadata"])
    with open(one + ".json") as f:
        assert json.load(f) == meta
    with np.load(mesh_path + ".npz") as a, np.load(one + ".npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("name", SAVES)
def test_load_gives_each_rank_its_slab(ranks, name):
    for res in ranks:
        assert _same_tree(res[("loaded", name)], res[("saved", name)])


def test_jax_file_loads_a_slab_a_rank(ref, ranks):
    tree = ref["tree"]
    for r, res in enumerate(ranks):
        got = res[("loaded", "jaxtree")]
        np.testing.assert_array_equal(got["a"].numpy(), tree["a"][r:r + 1])
        np.testing.assert_array_equal(
            got["b"].float().numpy(), np.asarray(tree["b"][r:r + 1],
                                                 np.float32))
        np.testing.assert_array_equal(
            got["codes"].view(torch.int16).numpy().view(np.uint16),
            tree["codes"][2 * r:2 * r + 2])
        assert int(got["step"][0]) == r


def _spec(tree):
    if isinstance(tree, dict):
        return {k: _spec(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_spec(v) for v in tree)
    return [str(tree.dtype).replace("torch.", ""), tuple(tree.shape)]


@pytest.fixture(scope="module")
def jax_loaded(ranks, workdir):
    """JAX's load_checkpoint of every mesh-written file, in one
    subprocess."""
    specs = {name: (_mesh_path(workdir, name),
                    _spec(_cat([r[("saved", name)] for r in ranks])))
             for name in SAVES}
    with open(workdir / "specs.pkl", "wb") as f:
        pickle.dump(specs, f)
    res = subprocess.run([sys.executable, "-c", _JAX_LOAD,
                          str(workdir / "specs.pkl"),
                          str(workdir / "jax_loaded.pkl")], cwd=ROOT,
                         env=_jax_env(), capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    with open(workdir / "jax_loaded.pkl", "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("name", SAVES)
def test_jax_reads_the_mesh_file(ranks, jax_loaded, name):
    """JAX's loader reads the mesh-written file bitwise: the gathered
    state (bf16 narrowed back, uint16 codes, the wire tuple)."""
    want = _leaves(_cat([r[("saved", name)] for r in ranks]))
    got = jax_loaded[name]
    assert len(got) == len(want)
    for (dt, shape, raw), w in zip(got, want):
        assert tuple(shape) == tuple(w.shape), (dt, w.dtype)
        wb = w.view(torch.int16) if w.dtype in (torch.uint16,
                                                torch.bfloat16) else w
        assert raw == wb.contiguous().numpy().tobytes(), (dt, w.dtype)


def test_compress_state_wire_rows_are_node_contiguous(ranks):
    """A compressed comm copy's wire rows of each rank, in rank order,
    are the one-shard encode of the stacked buffer."""
    params = _cat([r["wire_rows"][0] for r in ranks])
    lay = TB.build_layout(params)
    u = torch.from_numpy(np.random.default_rng(5).random(
        (N, lay.n_padded)).astype(np.float32))
    codec = _Run("compress_q8", None).tr.codec
    want = codec.encode_state(TB.pack(lay, params), None, u=u)
    got = _cat([r["wire_rows"][1] for r in ranks])
    assert len(got) == len(want)
    assert all(_same(a, b) for a, b in zip(got, want))
    assert got[0].shape[0] == N * lay.rows_per_node


# ---------------------------------------------------------------------------
# Resume and the chunk driver
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("how", RESUMES)
def test_mid_run_resume_is_bitwise(ranks, how):
    """Resumed at S/2 from a mesh checkpoint (codec tree, momentum and
    the run's generator) into a fresh run — per step, chunked, or
    chunked then per step — the final state (params, momentum, comm
    copy) and the metrics equal the uninterrupted per-step run's on
    every rank."""
    for r, res in enumerate(ranks):
        leaves, ms = res[("resume", how)]
        assert len(leaves) == len(res["full"]) > 0
        assert all(_same(a, b) for a, b in zip(leaves, res["full"])), r
        assert ms == res["full_metrics"][S // 2:], r


def test_eval_mean_at_a_chunk_boundary(ranks):
    for res in ranks:
        a, b = res["eval_chunk_boundary"], res["eval_per_step"]
        assert all(_same(a[k], b[k]) for k in a)


@pytest.mark.parametrize("case", CHUNKED)
def test_chunk_equals_per_step_on_every_rank(ranks, case):
    for r, res in enumerate(ranks):
        per, ms_per, chk, ms_chk, _ = res[("chunk", case)]
        assert len(chk) == len(per) > 0
        assert all(_same(a, b) for a, b in zip(chk, per)), (case, r)
        assert ms_chk == ms_per, (case, r)
        assert all(np.isfinite(m["loss"]) for m in ms_chk)


def test_dpsgd_mesh_chunk_equals_the_one_shard_chunk(ranks):
    """The mesh chunk's mix is the one-shard chunk's on the same rows."""
    one = _Run("dpsgd", None)
    ms = one.chunked(0, S)
    got = [torch.cat(xs) for xs in zip(*[r[("chunk", "dpsgd")][2]
                                         for r in ranks])]
    assert all(_same(a, b) for a, b in zip(got, _state_leaves(one.state)))
    assert [m["loss"] for m in ms] == \
        [m["loss"] for m in ranks[0][("chunk", "dpsgd")][3]]


@pytest.mark.parametrize("case", ["gather_q8", "pool_overlap_geometric"])
def test_graph_keys_carry_the_posted_peers(ranks, case):
    """On a mesh a graph key ends with the rank's (dsts, src) for the
    superstep's host perm, the same on every rank for a matching seen
    from both ends."""
    for r, res in enumerate(ranks):
        run = _Run(case, NodeMesh(r, N, torch.device("cpu")))
        keys = res[("chunk", case)][4]
        for p, k in zip(run.perms, keys):
            assert k[-1] == run.tr.mesh_route(p)
            dsts, src = k[-1]
            if src is not None:
                assert dsts == (src,)          # a matching: one partner


def test_graph_key_separates_partners():
    """Two supersteps whose partners differ never share a graph."""
    mesh = NodeMesh(0, N, torch.device("cpu"))
    step = _Run("gather_q8", mesh).step
    h = (H,) * N
    a = step.graph_key(None, h, np.array([1, 0, 3, 2]))
    b = step.graph_key(None, h, np.array([2, 3, 0, 1]))
    c = step.graph_key(None, h, np.array([0, 1, 3, 2]))
    assert a != b and a[:-1] == b[:-1]
    assert a[-1] == ((1,), 1) and c[-1] == ((), None)
    assert _Run("dpsgd", mesh).step.graph_key(None, h, None) == ()
    # the local steps' signature is the rank's own count's
    geo = _Run("pool_overlap_geometric", mesh).step
    pool0 = np.zeros(N, np.int64)
    assert geo.graph_key(None, (3, 1, 4, 1), pool0)[:2] == (3, 3)
    assert geo.graph_key(None, (3, 1, 4, 1), pool0) != \
        geo.graph_key(None, (1, 1, 4, 3), pool0)


def test_graph_folds_draw_what_the_fold_draws():
    """Eagerly a chunk's folds are the mesh's fold: the same draws, and
    the run's generator moves on alike; each graph key keeps its own
    folds, and a capture that folds another number of times than its
    key's eager run raises."""
    mesh = NodeMesh(2, N, torch.device("cpu"))
    runs = [torch.Generator().manual_seed(3) for _ in range(2)]
    want = [torch.rand(5, generator=mesh.fold_generator(runs[0]))
            for _ in range(3)]
    folds = GraphFolds(mesh)
    got = []
    for key, n in (("a", 2), ("b", 1)):    # two supersteps, two keys
        folds.begin(key, runs[1], capturing=False)
        with mesh.folding(folds):
            for _ in range(n):
                got.append(torch.rand(5, generator=mesh.fold_generator(
                    runs[1])))
        folds.end()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(runs[0].get_state(), runs[1].get_state())
    assert len(folds.gens) == 2 and list(folds.places) == ["a", "b"]
    assert [len(p) for p in folds.places.values()] == [2, 1]
    # outside `folding` the mesh folds a fresh generator again
    assert mesh.fold_generator(runs[1]) not in folds.gens
    folds.begin("b", runs[1], capturing=True)
    with mesh.folding(folds), pytest.raises(RuntimeError, match="2 times"):
        for _ in range(2):
            mesh.fold_generator(runs[1])
    folds.begin("a", runs[1], capturing=True)
    with mesh.folding(folds):
        mesh.fold_generator(runs[1])
    with pytest.raises(RuntimeError, match="1 times"):
        folds.end()
    with pytest.raises(RuntimeError, match="before an eager run"):
        folds.begin("c", runs[1], capturing=True)


def test_closed_chunk_driver_runs_no_chunk():
    """`close` releases a driver for good: every rank calls it before a
    new driver is built (a mesh's ranks meet there; none here)."""
    run = _Run("gather_q8", NodeMesh(0, N, torch.device("cpu")))
    chunk = make_superstep_scan(run.step)
    chunk.close()
    assert chunk.graphs == {} and chunk.pool_reserved() == 0
    with pytest.raises(RuntimeError, match="closed"):
        chunk(run.state, run.gen, {}, run.perms[:1], run.hs[:1])


def test_mesh_chunk_matches_jax_scan(ref, ranks):
    """The linear-loss exact blocking engine, one 2-superstep chunk on the
    mesh, against the reference's scan over its shard_map step: params
    within 4 ulp of the leaf's largest magnitude, the metrics within
    1e-6. (Elementwise, a coordinate near 0 sits up to 32 of its own ulp
    away after two chained supersteps: XLA contracts the multiply-adds,
    eager torch does not — ROADMAP.md Queue C 6 — and the one-superstep
    engine cases hold 4 ulp from a restarted state.)"""
    got = torch.cat([r["reference_scan"][0]["w"] for r in ranks]).numpy()
    want = np.asarray(ref["scan_after"]["w"], np.float32)
    assert got.shape == want.shape
    ulp = np.spacing(np.max(np.abs(want)))
    assert np.max(np.abs(got - want)) <= 4 * ulp
    for k in ("loss", "gamma"):
        np.testing.assert_allclose(
            ranks[0]["reference_scan"][1][k].numpy(),
            ref["scan_metrics"][k], rtol=1e-6, atol=1e-7)
