"""The gather transport, the five baselines and the join step on the port's
node mesh, on the CPU: one node a ``torch.distributed`` rank
(``repro_torch/launch/mesh.py``, gloo here), against the JAX package's
one-device program jitted with its node axis sharded over a real 4-device
mesh.

* The reference: one subprocess with 4 fake CPU devices
  (``XLA_FLAGS=--xla_force_host_platform_device_count=4``) places every
  node-stacked input with ``NamedSharding(mesh, P("node"))`` and runs,
  jitted (GSPMD lowers ``buf[perm]``, the node mean and ``W @ X`` to
  collectives): ``bucket.gossip_flat_exact`` / ``gossip_flat_coded``
  (exact, q4, q8, q16, bf16, ``topk:0.25`` with its residual; masked and
  not; by a matching, a partial matching and SGP's cyclic shift),
  ``gossip_flat_mean`` (masked and not), ``gossip_flat_matrix``,
  ``exchange.gossip_exact`` / ``gossip_quantized`` per leaf, 3
  supersteps of ``make_swarm_step`` on gather (blocking exact, exact with
  the momentum averaged, blocking / non-blocking q8, non-blocking top-k,
  overlapped q8, ``compress_state`` q8, masked q8, ``hier:2``
  matchings), the five baselines through ``make_algorithm`` (3 steps
  each) and one join bin through ``make_join_step`` — the engines on the
  linear loss of ``tests/test_async_pipeline.py`` and on transformer-wmt
  reduced to 1 layer of d_model 32. It saves inputs, uniforms, states
  and outputs.
* The port: 4 gloo ranks (spawned, rendezvous through a file) run the same
  cases with the reference's uniforms (each rank its row), every engine
  and baseline step restarted from the reference's state, and record the
  messages each rank posts; then the churn schedule of
  ``sched/bridge.py`` drives the mesh engine.

The contract: wire codes, scales and byte counts bitwise; every mesh
exchange, mean and mix bitwise the one-shard port's on the same buffers
and perm or W, with the ranks' uniforms concatenated; flat exact bitwise
its ``gather_legacy`` oracle; exact floats within 4 ulp of the jitted
reference; q8 within one lattice step of the partner's row and >= 99.98%
within 2e-5 (ROADMAP.md Queue C 6); engine and baseline steps exact
within 2e-5, q8 as above, top-k within half the partner's largest shipped
magnitude on >= 99.9%; the metrics global and equal on every rank.
Planted faults fail: a rank sending to ``perm[r]`` instead of to the
``j`` with ``perm[j] == r`` (invisible on a matching, visible on SGP's
shift), a mean over the rank's own row only, the wrong row of ``W X``, a
missed wait. This file imports no JAX: the reference runs in its own
process.
"""
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.algorithms import make_algorithm
from repro_torch.algorithms.dpsgd import masked_metropolis
from repro_torch.algorithms.sgp import sgp_debias, sgp_init_state
from repro_torch.configs import get_config, reduced
from repro_torch.core import bucket as TB
from repro_torch.core import exchange as TE
from repro_torch.core.graph import make_graph
from repro_torch.core.potential import gamma_potential
from repro_torch.core.swarm import (SwarmConfig, SwarmState, make_join_step,
                                    make_swarm_step, retire_nodes)
from repro_torch.launch.mesh import NodeMesh, init_node_mesh
from repro_torch.models import TransformerLM
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import make_optimizer
from repro_torch.quant import schemes as TS
from repro_torch.quant.codecs import LatticeCodec, TopKCodec, make_codec
from repro_torch.tree import tree_leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
N = 4
PERMS = {"match": np.array([2, 3, 0, 1]), "partial": np.array([1, 0, 2, 3]),
         "shift": np.array([3, 0, 1, 2])}
MASK = np.array([True, True, False, True])
CODECS = ("exact", "q4", "q8", "q16", "bf16", "topk")
H, STEPS, LR, D = 2, 3, 0.05, 12
MODELS = ("linear", "wmt")
ENGINES = ("blocking-exact", "blocking-exact-mom", "blocking-q8",
           "nonblocking-q8", "nonblocking-topk", "overlap-q8", "compress-q8",
           "masked-q8", "hier2-q8")
BASELINES = ("allreduce-masked", "localsgd", "dpsgd-masked",
             "adpsgd-q8-masked", "adpsgd-nonblocking", "sgp-masked",
             "sgp-q8")
SAFETY = 16.0

_REFERENCE = textwrap.dedent('''
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, "src")
    import pickle
    from concurrent.futures import ThreadPoolExecutor
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.algorithms import make_algorithm
    from repro.algorithms.dpsgd import masked_metropolis, metropolis_weights
    from repro.algorithms.sgp import sgp_init_state
    from repro.compat import make_mesh_compat
    from repro.configs import get_config, reduced
    from repro.core import bucket as B
    from repro.core import exchange as E
    from repro.core.graph import make_graph, sample_matching
    from repro.core.hier import parse_topology
    from repro.core.swarm import (SwarmConfig, SwarmState, make_join_step,
                                  make_swarm_step, swarm_init)
    from repro.models import init_params, loss_fn
    from repro.optim import make_optimizer
    from repro.quant.codecs import make_codec
    from repro.quant.schemes import ModularQuantConfig

    N, H, STEPS, LR, D, BATCH, SEQ = 4, 2, 3, 0.05, 12, 4, 16
    PERMS = {"match": np.array([2, 3, 0, 1]),
             "partial": np.array([1, 0, 2, 3]),
             "shift": np.array([3, 0, 1, 2])}
    MASK = np.array([True, True, False, True])
    mesh = make_mesh_compat((N,), ("node",))
    SHARD, REPL = NamedSharding(mesh, P("node")), NamedSharding(mesh, P())


    def put(tree):
        """Node-stacked leaves sharded over the node axis, the rest
        replicated."""
        def one(x):
            x = jnp.asarray(x)
            s = SHARD if x.ndim and x.shape[0] % N == 0 else REPL
            return jax.device_put(x, s)
        return jax.tree.map(one, tree)


    rng = np.random.default_rng(11)
    buf = rng.normal(size=(N, 2048)).astype(np.float32)
    prev = (buf + 0.01 * rng.normal(size=buf.shape)).astype(np.float32)
    res = (0.01 * rng.normal(size=buf.shape)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    W = metropolis_weights(make_graph("ring", N)).astype(np.float32)
    out = {"buf": buf, "prev": prev, "res": res, "mask": MASK, "W": W,
           "u_flat": np.asarray(jax.random.uniform(key, (N, 2048)))}
    Q8 = ModularQuantConfig()
    CODECS = {"exact": None, "q4": ModularQuantConfig(bits=4), "q8": Q8,
              "q16": ModularQuantConfig(bits=16), "bf16": make_codec("bf16"),
              "topk": make_codec("topk:0.25")}
    tree = {"a": rng.normal(size=(N, 6, 16)).astype(np.float32),
            "b": rng.normal(size=(N, 7)).astype(np.float32),
            "c": rng.normal(size=(N, 3, 5)).astype(np.float32)}
    tprev = {k: (v + 0.01 * rng.normal(size=v.shape)).astype(np.float32)
             for k, v in tree.items()}
    out["tree"], out["tprev"] = tree, tprev
    lkey = jax.random.PRNGKey(5)
    # the per-leaf oracle's uniforms: a key a leaf, split a node
    out["u_leaf"] = [np.stack([np.asarray(jax.random.uniform(
        nk, (-(-int(np.prod(tree[k].shape[1:])) // 256), 256)))
        for nk in jax.random.split(sub, N)])
        for k, sub in zip(sorted(tree), jax.random.split(lkey, len(tree)))]


    def flat(name):
        codec = CODECS[name]
        for pname, perm in PERMS.items():
            for masked in (False, True):
                matched = perm != np.arange(N)
                if masked:
                    matched = matched & MASK
                if codec is None:
                    f = jax.jit(lambda b, p, m: B.gossip_flat_exact(b, p, m))
                    got = (f(put(buf), put(perm),
                             put(matched) if masked else None), None)
                else:
                    c = B.as_codec(codec)
                    f = jax.jit(lambda b, pv, p, m, k, r: B.gossip_flat_coded(
                        c, b, pv, p, m, k,
                        residual=r if c.carries_residual else None))
                    got = f(put(buf), put(prev), put(perm), put(matched),
                            key, put(res))
                out[("flat", name, pname, masked)] = jax.device_get(got)
        if codec is not None:
            c = B.as_codec(codec)
            enc = jax.jit(lambda b, pv, k, r: c.encode_ef(b, pv, k, r)[0]
                          if c.carries_residual else c.encode(b, pv, k))
            out[("wire", name)] = jax.device_get(enc(buf, prev, key, res))
            out[("bytes", name)] = B.build_layout(
                {"b": jnp.zeros((N, 2048))}).payload_num_bytes(codec)


    def collectives():
        for masked in (False, True):
            f = jax.jit(lambda b, m: B.gossip_flat_mean(b, m))
            out[("mean", masked)] = np.asarray(
                f(put(buf), put(MASK) if masked else None))
        f = jax.jit(lambda w, b: B.gossip_flat_matrix(w, b))
        out[("matrix", "ring")] = np.asarray(f(put(W), put(buf)))
        wm = np.asarray(masked_metropolis(jnp.asarray(W), jnp.asarray(MASK)))
        out["W_masked"] = wm
        out[("matrix", "masked")] = np.asarray(f(put(wm), put(buf)))


    def per_leaf(name):
        for pname, perm in PERMS.items():
            matched = (perm != np.arange(N)) & MASK
            if name == "exact":
                r = jax.jit(lambda t_, p_, m_: E.gossip_exact(t_, p_, m_))(
                    put(tree), put(perm), put(matched))
            else:
                r = jax.jit(lambda t_, pv_, p_, m_, k_: E.gossip_quantized(
                    Q8, t_, pv_, p_, m_, k_))(put(tree), put(tprev),
                                              put(perm), put(matched), lkey)
            out[("leaf", name, pname)] = jax.device_get(r)


    wcfg = reduced(get_config("transformer-wmt"), n_layers=1, d_model=32)
    MODELS = {
        "linear": (lambda p, mb: 0.5 * jnp.mean((mb["x"] @ p["w"] - mb["y"])
                                                ** 2),
                   lambda k: {"w": jax.random.normal(k, (D,)) * 0.3}),
        "wmt": (lambda p, mb: loss_fn(wcfg, p, mb),
                lambda k: init_params(k, wcfg))}


    def batch_of(model, t, h_slots):
        r = np.random.default_rng(100 + t)
        if model == "linear":
            return {"x": r.normal(size=(N, h_slots, BATCH, D))
                    .astype(np.float32),
                    "y": r.normal(size=(N, h_slots, BATCH)).astype(np.float32)}
        tok = r.integers(0, wcfg.vocab_size, size=(N, h_slots, BATCH, SEQ + 1))
        return {"tokens": tok[..., :-1].astype(np.int32),
                "targets": tok[..., 1:].astype(np.int32)}


    def snap(st):
        return jax.device_get((st.params, st.opt, st.prev, st.inflight,
                               st.residual))


    def inputs_of(case):
        """(perms, masks) of the case's STEPS steps."""
        r = np.random.default_rng(3)
        if "hier2" in case:
            topo = parse_topology("hier:2", N)
            perms = [topo.sample_event(r)[0] for _ in range(STEPS)]
        else:
            perms = [sample_matching(make_graph("complete", N), r)
                     for _ in range(STEPS)]
        masks = [np.random.default_rng(7 + t).random(N) < 0.7
                 if "masked" in case else None for t in range(STEPS)]
        if "masked" in case:
            masks[0] = MASK
        return perms, masks


    def run(model, case, step, state, h_slots, n_pad_of):
        perms, masks = inputs_of(case)
        h = jnp.full((N,), h_slots, jnp.int32)
        for t in range(STEPS):
            before = snap(state)
            b = batch_of(model, t, h_slots)
            skey = jax.random.PRNGKey(1000 + t)
            args = (put(state), put(b), put(perms[t]), put(h), skey)
            if masks[t] is not None:
                args += (put(masks[t]),)
            state, m = step(*args)
            n_pad = n_pad_of(state)
            out[(model, case, t)] = {
                "state": before, "batch": b, "perm": perms[t],
                "mask": masks[t],
                "u": np.asarray(jax.random.uniform(skey, (N, n_pad))),
                "u_state": np.asarray(jax.random.uniform(
                    jax.random.fold_in(skey, 0x5E), (N, n_pad))),
                "after": snap(state),
                **{k: float(m[k]) for k in ("loss", "gamma", "matched_frac")
                   if k in m}}


    def engine(model, case):
        mode, codec = case.split("-")[:2]
        loss, init = MODELS[model]
        quant = codec != "exact"
        scfg = SwarmConfig(n_nodes=N, H=H, quantize=quant,
                           quant=ModularQuantConfig(safety=16.0),
                           codec="topk:0.25" if codec == "topk" else None,
                           nonblocking=mode in ("nonblocking", "overlap"),
                           overlap=mode == "overlap",
                           compress_state=mode == "compress",
                           gossip_impl="gather",
                           average_momentum=case.endswith("-mom"))
        opt = make_optimizer("sgd", lr=LR, momentum=0.9)
        state = swarm_init(jax.random.PRNGKey(0), scfg, init, opt.init,
                           same_init=quant)
        step = jax.jit(make_swarm_step(scfg, loss, opt.update,
                                       lambda s: LR))
        run(model, case, step, state, H,
            lambda st: B.build_layout(st.params).n_padded)


    def baseline(model, case):
        algo = case.split("-")[0]
        loss, init = MODELS[model]
        quant = "q8" in case
        q = ModularQuantConfig(safety=16.0)
        scfg = SwarmConfig(n_nodes=N, H=1, quantize=quant, quant=q,
                           gossip_impl="gather")
        opt = make_optimizer("sgd", lr=LR, momentum=0.9)
        kw = dict(loss_fn=loss, opt_update=opt.update, lr_fn=lambda s: LR,
                  n_nodes=N, transport=E.GossipTransport("gather", N,
                                                         quant=q))
        h_slots = 1
        if algo == "localsgd":
            kw["H"] = h_slots = H
        if algo == "dpsgd":
            kw["graph"] = make_graph("ring", N)
        if algo in ("adpsgd", "sgp"):
            kw["quantize"] = quant
        if algo == "adpsgd":
            kw["nonblocking"] = "nonblocking" in case
        # all-reduce from one model, so that its nodes stay equal
        state = swarm_init(jax.random.PRNGKey(0), scfg, init, opt.init,
                           same_init=quant or algo == "allreduce")
        if algo == "sgp":
            state = sgp_init_state(state, N, quant)
        step = jax.jit(make_algorithm(algo, **kw))
        run(model, case, step, state, h_slots,
            lambda st: B.build_layout(st.params).n_padded)


    def join(model):
        """One join bin: node 2 joins from donor 0, on a state whose nodes
        differ, with a comm copy and a residual."""
        loss, init = MODELS[model]
        scfg = SwarmConfig(n_nodes=N, H=H, quantize=True, codec="topk:0.25",
                           gossip_impl="gather")
        opt = make_optimizer("sgd", lr=LR, momentum=0.9)
        st = swarm_init(jax.random.PRNGKey(0), scfg, init, opt.init,
                        same_init=False)
        r = np.random.default_rng(17)
        prev = jax.tree.map(lambda x: np.asarray(x) + 0.01 * r.normal(
            size=x.shape).astype(np.asarray(x).dtype), st.params)
        res = r.normal(size=st.residual.shape).astype(np.float32)
        st = SwarmState(st.params, st.opt, prev, st.step, residual=res)
        perm, jm = np.array([2, 1, 0, 3]), np.array([False, False, True,
                                                     False])
        got = jax.jit(make_join_step(scfg))(put(st), put(perm), put(jm))
        out[("join", model)] = {"state": snap(st), "perm": perm, "jm": jm,
                                "after": snap(got)}


    tasks = [lambda n=n: flat(n) for n in CODECS] + [collectives] + \\
        [lambda n=n: per_leaf(n) for n in ("exact", "q8")] + \\
        [lambda m=m, c=c: engine(m, c) for m in MODELS
         for c in sys.argv[2].split(",")] + \\
        [lambda m=m, c=c: baseline(m, c) for m in MODELS
         for c in sys.argv[3].split(",")] + \\
        [lambda m=m: join(m) for m in MODELS]
    with ThreadPoolExecutor(8) as ex:
        for f in [ex.submit(t) for t in tasks]:
            f.result()
    with open(sys.argv[1], "wb") as f:
        pickle.dump(out, f)
''')


# ---------------------------------------------------------------------------
# The two sides
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("multishard_gather")


@pytest.fixture(scope="module")
def ref(workdir):
    """The reference's run on 4 fake devices (its own process: the device
    count is fixed when JAX starts)."""
    path = workdir / "ref.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", _REFERENCE, str(path),
                          ",".join(ENGINES), ",".join(BASELINES)], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    with open(path, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def ranks(ref, workdir):
    """The port's 4 gloo ranks over every case; -> each rank's results."""
    mp.spawn(_rank_main, args=(str(workdir),), nprocs=N, join=True)
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False)
            for r in range(N)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _codec(name):
    return {"exact": None, "q4": TS.ModularQuantConfig(bits=4),
            "q8": TS.ModularQuantConfig(),
            "q16": TS.ModularQuantConfig(bits=16),
            "bf16": make_codec("bf16"), "topk": make_codec("topk:0.25")}[name]


def _rows(tree, r, n=1):
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return tuple(_rows(x, r, n) for x in tree)
    return tree_map(lambda a: a[r * n:(r + 1) * n], tree)


def _port(tree):
    return None if tree is None else params_from_numpy(tree, "cpu")


class _Log:
    """Records the point-to-point messages this rank posts ((kind, peer,
    bytes)), what each exchange received, and the local steps (("sgd",))
    in one event list; `missed_wait` plants a missed wait."""

    def __init__(self):
        self.events, self.recv = [], []
        self._batch, self._wait = dist.batch_isend_irecv, TB.Posted.wait
        self.missed_wait = False
        log = self

        def batch(ops):
            for op in ops:
                log.events.append(("isend" if op.op is dist.isend
                                   else "irecv", op.peer, op.tensor.numel()))
            return log._batch(ops)

        def wait(posted):
            got = log._wait(posted)
            if log.missed_wait:
                got = tuple(torch.zeros_like(x) for x in got)
            log.recv.append(got)
            return got
        dist.batch_isend_irecv = batch
        TB.Posted.wait = wait

    def take(self):
        out = (self.events, self.recv)
        self.events, self.recv = [], []
        return out

    def undo(self):
        dist.batch_isend_irecv, TB.Posted.wait = self._batch, self._wait


def _loss_of(model):
    if model == "linear":
        def loss(p, mb):
            return 0.5 * torch.mean((mb["x"] @ p["w"] - mb["y"]) ** 2)
        return loss
    return TransformerLM(reduced(get_config("transformer-wmt"), n_layers=1,
                                 d_model=32)).functional_loss


def _engine_cfg(case):
    mode, codec = case.split("-")[:2]
    quant = codec != "exact"
    return SwarmConfig(n_nodes=N, H=H, quantize=quant,
                       quant=TS.ModularQuantConfig(safety=SAFETY),
                       codec="topk:0.25" if codec == "topk" else None,
                       nonblocking=mode in ("nonblocking", "overlap"),
                       overlap=mode == "overlap",
                       compress_state=mode == "compress",
                       gossip_impl="gather",
                       average_momentum=case.endswith("-mom"))


def _port_step(model, case, mesh, log):
    """The port's step of an engine or baseline case on `mesh` (None: one
    shard), its optimizer calls logged."""
    opt = make_optimizer("sgd", lr=LR, momentum=0.9)

    def update(*a):
        log.events.append(("sgd",))
        return opt.update(*a)
    loss = _loss_of(model)
    if case in ENGINES:
        scfg = _engine_cfg(case)
        tr = TE.GossipTransport(N, quant=scfg.quant, codec=scfg.make_codec(),
                                mesh=mesh)
        return make_algorithm("swarm", scfg=scfg, loss_fn=loss,
                              opt_update=update, lr_fn=lambda s: LR,
                              n_nodes=N, transport=tr, mesh=mesh)
    algo = case.split("-")[0]
    q = TS.ModularQuantConfig(safety=SAFETY)
    kw = dict(loss_fn=loss, opt_update=update, lr_fn=lambda s: LR,
              n_nodes=N, transport=TE.GossipTransport(N, quant=q, mesh=mesh),
              mesh=mesh)
    if algo == "localsgd":
        kw["H"] = H
    if algo == "dpsgd":
        kw["graph"] = make_graph("ring", N)
    if algo in ("adpsgd", "sgp"):
        kw["quantize"] = "q8" in case
    if algo == "adpsgd":
        kw["nonblocking"] = "nonblocking" in case
    return make_algorithm(algo, **kw)


def _port_state(np_state, r, t, rpn=None):
    """The reference's state before a step as rank r's node (r None: every
    node, one shard)."""
    params, opt, prev, infl, res = np_state
    rows = (lambda x: x) if r is None else (lambda x: _rows(x, r))
    if infl is not None:
        rp = infl["sbuf"].shape[1] // 256
        wrows = (lambda x: x) if r is None else (lambda x: _rows(x, r, rp))
        infl = {"sbuf": _t(rows(infl["sbuf"])),
                "prev": _t(rows(infl["prev"])),
                "wire": tuple(_t(w) for w in wrows(tuple(infl["wire"])))}
    if isinstance(prev, tuple):          # compress_state's wire comm copy
        rp = rpn
        prev = tuple(_t(w) for w in (
            prev if r is None else _rows(tuple(prev), r, rp)))
    else:
        prev = _port(rows(prev))
    return SwarmState(_port(rows(params)), _port(rows(opt)) or {}, prev, t,
                      infl, None if res is None else _t(rows(res)))


def _drive(model, case, rec, step, r, t):
    """One restarted step of the case on rank r (None: one shard) ->
    (state, metrics)."""
    sel = (lambda x: x) if r is None else (lambda x: x[r:r + 1])
    n_pad = rec["u"].shape[1]
    st = _port_state(rec["state"], r, t, rpn=n_pad // 256)
    b = {k: _t(sel(v)) for k, v in rec["batch"].items()}
    kw = {"u": _t(sel(rec["u"]))}
    if case.startswith("compress"):
        kw["u_state"] = _t(sel(rec["u_state"]))
    h = H if case in ENGINES or case.startswith("localsgd") else 1
    return step(st, b, rec["perm"], np.full((N,), h), None, rec["mask"],
                **kw)


def _faulty_peers(perm, mesh, land=None):
    """The planted fault: the rank sends to perm[rank] (and so receives
    from the j with perm[j] == rank) — right for a matching, backwards
    for a shift."""
    p = np.asarray(perm).reshape(-1)
    r = mesh.rank
    src = int(np.flatnonzero(p == r)[0])
    return ([int(p[r])] if p[r] != r else []), (src if src != r else None)


def _rank_main(rank, workdir):
    torch.set_num_threads(1)
    mesh = init_node_mesh("cpu", rank=rank, world_size=N,
                          init_method=f"file://{workdir}/rendezvous")
    with open(f"{workdir}/ref.pkl", "rb") as f:
        ref = pickle.load(f)
    log = _Log()
    out = {}
    r1 = slice(rank, rank + 1)
    buf, prev, res, u = (_t(ref[k][r1]) for k in ("buf", "prev", "res",
                                                  "u_flat"))
    mask = _t(ref["mask"])
    try:
        for name in CODECS:
            codec = TB.as_codec(_codec(name))
            for pname, perm in PERMS.items():
                for masked in (False, True):
                    matched = perm != np.arange(N)
                    if masked:
                        matched = matched & MASK
                    m_r = _t(matched[r1])
                    if codec is None:
                        got = (TB.gossip_flat_exact(
                            buf, perm, m_r if masked else None, mesh=mesh),
                            None)
                    else:
                        got = TB.gossip_flat_coded(
                            codec, buf, prev, perm, m_r, None, u=u,
                            residual=res if codec.carries_residual else None,
                            mesh=mesh)
                    ev, rv = log.take()
                    out[("flat", name, pname, masked)] = (got, ev, rv)
        # drawn uniforms: the rank's generator folded from the run's
        gen = torch.Generator().manual_seed(7)
        out["drawn"] = (TB.gossip_flat_coded(
            LatticeCodec(TS.ModularQuantConfig()), buf, prev,
            PERMS["shift"], torch.ones(1, dtype=torch.bool), gen,
            mesh=mesh)[0], gen.get_state())
        log.take()
        # the node mean and the dense mix
        tr = TE.GossipTransport(N, mesh=mesh)
        for masked in (False, True):
            out[("mean", masked)] = TB.gossip_flat_mean(
                buf, mask if masked else None, mesh=mesh)
        for wname, w in (("ring", ref["W"]), ("masked", ref["W_masked"])):
            out[("matrix", wname)] = TB.gossip_flat_matrix(_t(w), buf,
                                                           mesh=mesh)
        log.take()
        # per leaf: the oracle's exchanges, collectives and flat == oracle
        tree = _port(_rows(ref["tree"], rank))
        tprev = _port(_rows(ref["tprev"], rank))
        u_leaf = [_t(a[r1]) for a in ref["u_leaf"]]
        legacy = TE.GossipTransport(N, impl="gather_legacy", mesh=mesh)
        for pname, perm in PERMS.items():
            m_r = _t(((perm != np.arange(N)) & MASK)[r1])
            out[("leaf", "exact", pname)] = (
                TE.gossip_exact(tree, perm, m_r, mesh=mesh), log.take()[0])
            out[("leaf", "q8", pname)] = (
                TE.gossip_quantized(TS.ModularQuantConfig(), tree, tprev,
                                    perm, m_r, None, u=u_leaf, mesh=mesh),
                log.take()[0])
            m_all = _t(perm != np.arange(N))
            out[("flat_vs_legacy", pname)] = (
                tr.mix_pair(tree, perm, m_all[r1]),
                legacy.mix_pair(tree, perm, m_all[r1]))
            log.take()
        out[("leaf", "mean")] = legacy.global_mean(tree, mask)
        out[("leaf", "matrix")] = legacy.matrix_mix(tree, _t(ref["W"]))
        log.take()
        # planted faults
        orig_peers = TB.gather_peers
        TB.gather_peers = _faulty_peers
        try:
            for pname in ("match", "shift"):
                out[("fault", "send_to_perm", pname)] = TB.gossip_flat_exact(
                    buf, PERMS[pname], None, mesh=mesh)
        finally:
            TB.gather_peers = orig_peers
        orig_rows = TB.all_gather_rows
        TB.all_gather_rows = lambda x, mesh_: x.expand(
            (mesh_.size,) + tuple(x.shape[1:]))
        try:
            out[("fault", "own_row_mean")] = TB.gossip_flat_mean(buf,
                                                                 mesh=mesh)
        finally:
            TB.all_gather_rows = orig_rows
        r_wrong = (rank + 1) % N
        out[("fault", "wrong_row")] = TB.gossip_flat_matrix(
            _t(ref["W"]), TB.all_gather_rows(buf, mesh))[r_wrong:r_wrong + 1]
        log.missed_wait = True
        out[("fault", "missed_wait")] = TB.gossip_flat_coded(
            TB.as_codec(TS.ModularQuantConfig()), buf, prev, PERMS["shift"],
            torch.ones(1, dtype=torch.bool), None, u=u, mesh=mesh)[0]
        log.missed_wait = False
        log.take()
        # engines and baselines, each step restarted from the reference's
        scales = []
        orig_encode = LatticeCodec.encode
        orig_topk = TopKCodec.encode_ef

        def encode(codec, *a, **kw):
            q_, s_ = orig_encode(codec, *a, **kw)
            scales.append(s_.reshape(-1).clone())
            return q_, s_

        def encode_ef(codec, *a, **kw):
            w_, r_ = orig_topk(codec, *a, **kw)
            scales.append(w_[0].abs().amax(dim=1))
            return w_, r_
        LatticeCodec.encode, TopKCodec.encode_ef = encode, encode_ef
        try:
            for model in MODELS:
                for case in ENGINES + BASELINES:
                    step = _port_step(model, case, mesh, log)
                    for t in range(STEPS):
                        rec = ref[(model, case, t)]
                        del scales[:]
                        log.take()
                        st, m = _drive(model, case, rec, step, rank, t)
                        out[(model, case, t)] = {
                            "params": st.params, "residual": st.residual,
                            "scales": scales[0] if scales else None,
                            "events": log.take()[0],
                            **{k: float(v) for k, v in m.items()
                               if k in ("loss", "gamma", "matched_frac")}}
        finally:
            LatticeCodec.encode, TopKCodec.encode_ef = orig_encode, orig_topk
        # the join bin and retirement
        for model in MODELS:
            rec = ref[("join", model)]
            st = _port_state(rec["state"], rank, 0)
            log.take()
            got = make_join_step(SwarmConfig(
                n_nodes=N, quantize=True, codec="topk:0.25"), mesh=mesh)(
                    st, rec["perm"], rec["jm"])
            out[("join", model)] = (got, log.take()[0])
        out["retired"] = retire_nodes(
            SwarmState({}, {}, None, 0, None, res), MASK, mesh=mesh).residual
        out["bridge"] = _bridge_run(mesh, rank)
    finally:
        log.undo()
        mesh.close()
    torch.save(out, f"{workdir}/rank{rank}.pt")


# ---------------------------------------------------------------------------
# The scheduler's bins driving the mesh engine
# ---------------------------------------------------------------------------


def _churn_schedule():
    """A churn schedule of 4 nodes from ``sched/`` (join bins, leaves,
    masks, per-node h), as the driver bins it."""
    from repro_torch import sched as S
    g = make_graph("complete", N)
    av = S.parse_avail("day_night:period=8,duty=0.6,join=0.25:2:6,"
                       "leave=0.25:10:20,seed=3", N, seed=0)
    prof = S.RateProfile("lognormal", sigma=0.8)
    clocks = S.PoissonClocks(g, prof.make_rates(N, 13), 13,
                             S.StragglerConfig(0.0, 10.0, 0.0, 0.0),
                             avail=av)
    tr = S.generate_trace(g, prof, 40, H=2, h_mode="rate", h_max=4, seed=13,
                          clocks=clocks)
    return S.bin_trace(tr)


def _bridge_run(mesh=None, rank=0):
    """The driver's churn loop (retire, join bins, masked supersteps with
    per-node h) on the linear engine, gather q8; on a node `mesh` the
    rank's node. -> the packed params after each bin."""
    from repro_torch import sched as S
    sched = _churn_schedule()
    scfg = SwarmConfig(n_nodes=N, H=2, h_mode="trace", h_max=4,
                       quantize=True, quant=TS.ModularQuantConfig(safety=16.0))
    opt = make_optimizer("sgd", lr=LR, momentum=0.0)
    tr = TE.GossipTransport(N, quant=scfg.quant, mesh=mesh)
    step = make_swarm_step(scfg, _loss_of("linear"), opt.update,
                           lambda s: LR, transport=tr, mesh=mesh)
    join = make_join_step(scfg, mesh=mesh)
    rng = np.random.default_rng(5)
    x0 = (0.3 * rng.normal(size=(N, D))).astype(np.float32)
    sel = (lambda a: a) if mesh is None else (lambda a: a[rank:rank + 1])
    params = {"w": _t(sel(x0))}
    state = SwarmState(params, opt.init(params),
                       {"w": params["w"].clone()}, 0)
    lay = None
    traj = []
    for s in range(sched.n_supersteps):
        if sched.retire[s].any():
            state = retire_nodes(state, sched.retire[s], mesh=mesh)
        perm, h, m = S.engine_inputs(sched, s)
        if sched.kinds[s] == S.EVENT_JOIN:
            state = join(state, perm, m)
        else:
            b = {"x": _t(sel(rng.normal(size=(N, 4, 4, D)).astype(
                    np.float32))),
                 "y": _t(sel(rng.normal(size=(N, 4, 4)).astype(np.float32)))}
            lay = lay or TB.build_layout(state.params)
            u = _t(sel(rng.random((N, lay.n_padded)).astype(np.float32)))
            state, _ = step(state, b, perm, h, None, m, u=u)
        traj.append(TB.pack(TB.build_layout(state.params), state.params))
    return traj


# ---------------------------------------------------------------------------
# Helpers of the contract
# ---------------------------------------------------------------------------


def _np(x):
    """A tensor as numpy, 16-bit codes and bf16 through an int16 view."""
    if x.dtype in (torch.uint16, torch.bfloat16):
        return x.view(torch.int16).numpy()
    return x.numpy()


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize, \
        (a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def _within_ulp(got, want, k=4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return bool(np.all(np.abs(got - want) <= k * np.spacing(np.abs(want))))


def _readings(got, want, term, partner=None):
    """got/want [N, n_padded]; term [N, rows]: per-row bound term (a
    lattice step or half top-k's largest shipped magnitude) of each
    node's encode, read at the partner's row."""
    got, want = np.asarray(got), np.asarray(want)
    d = np.abs(got - want).reshape(N, -1, 256)
    t = np.asarray(term).reshape(N, -1, 1)
    if partner is not None:
        t = t[np.asarray(partner)]
    return {"finite": bool(np.isfinite(got).all()),
            "max_abs": float(d.max()),
            "share_within_2e-5": float((d <= 2e-5).mean()),
            "beyond_bound": int((~(d <= t + 2e-5)).sum())}


def _ok(r, share=0.9998):
    return r["finite"] and r["beyond_bound"] == 0 and \
        r["share_within_2e-5"] >= share


def _flat(tree):
    t = _port(tree) if not isinstance(tree_leaves(tree)[0], torch.Tensor) \
        else tree
    return TB.pack(TB.build_layout(t), t).numpy()


FLAT_CASES = [(c, p, m) for c in CODECS for p in PERMS for m in (False, True)]
FLAT_IDS = [f"{c}-{p}-{'masked' if m else 'full'}" for c, p, m in FLAT_CASES]


def _matched(pname, masked):
    m = PERMS[pname] != np.arange(N)
    return m & MASK if masked else m


# ---------------------------------------------------------------------------
# The flat gather exchange
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,pname,masked", FLAT_CASES, ids=FLAT_IDS)
def test_flat_exchange_matches_jax(ref, ranks, name, pname, masked):
    """Exact and bf16 within 4 ulp of the jitted reference under GSPMD;
    the lattice codecs within one lattice step of the partner's row and
    >= 99.98% within 2e-5; top-k within half the partner's largest shipped
    magnitude (its residual likewise)."""
    got = torch.cat([r[("flat", name, pname, masked)][0][0] for r in ranks])
    want, want_res = ref[("flat", name, pname, masked)]
    if name in ("exact", "bf16"):
        assert _within_ulp(_np(got), want), np.abs(_np(got) - want).max()
        return
    wire = ref[("wire", name)]
    if name == "topk":
        term = 0.5 * np.abs(np.asarray(wire[0])).max(axis=1)
        r = _readings(got.numpy(), want, term, PERMS[pname])
        assert _ok(r, 0.999), r
        res = torch.cat([x[("flat", name, pname, masked)][0][1]
                         for x in ranks])
        r = _readings(res.numpy(), want_res, 2 * term)
        assert _ok(r, 0.999), r
    else:
        r = _readings(got.numpy(), want, np.asarray(wire[1]), PERMS[pname])
        assert _ok(r), r


@pytest.mark.parametrize("name,pname,masked", FLAT_CASES, ids=FLAT_IDS)
def test_flat_exchange_equals_one_shard(ref, ranks, name, pname, masked):
    """The mesh's exchange == the one-shard exchange of the same rows by
    the same perm, with the ranks' uniforms concatenated: bitwise, the
    error-feedback residual too."""
    got = torch.cat([r[("flat", name, pname, masked)][0][0] for r in ranks])
    perm, matched = _t(PERMS[pname]), _t(_matched(pname, masked))
    codec = TB.as_codec(_codec(name))
    if codec is None:
        want = TB.gossip_flat_exact(_t(ref["buf"]), perm,
                                    matched if masked else None)
    else:
        want, want_res = TB.gossip_flat_coded(
            codec, _t(ref["buf"]), _t(ref["prev"]), perm, matched, None,
            u=_t(ref["u_flat"]),
            residual=_t(ref["res"]) if codec.carries_residual else None)
        if codec.carries_residual:
            _bits(torch.cat([r[("flat", name, pname, masked)][0][1]
                             for r in ranks]).numpy(), want_res.numpy())
    _bits(_np(got), _np(want))


@pytest.mark.parametrize("name", ["q4", "q8", "q16", "bf16", "topk"])
def test_wire_crosses_bitwise(ref, ranks, name):
    """Under SGP's shift each rank's wire is the reference's encode of its
    rows (codes, scales, values and indices bitwise), its out-neighbour
    received it bit for bit, and the bytes posted are the declared payload
    bytes, the reference's."""
    perm = PERMS["shift"]
    sent = [None] * N
    layout = TB.build_layout({"b": torch.zeros(1, 2048)})
    for r, res in enumerate(ranks):
        _, ev, rv = res[("flat", name, "shift", False)]
        recv, = rv
        sent[perm[r]] = recv          # rank r received rank perm[r]'s wire
        assert sum(b for k, _, b in ev if k == "isend") == \
            layout.payload_num_bytes(_codec(name)) == ref[("bytes", name)]
    for g, want in enumerate(ref[("wire", name)]):
        got = torch.cat([w[g] for w in sent])
        _bits(_np(got), np.asarray(want).astype(_np(got).dtype)
              if name == "topk" and g == 1 else want)


def _count(ev, kind):
    return sum(1 for e in ev if e[0] == kind)


@pytest.mark.parametrize("pname", list(PERMS))
@pytest.mark.parametrize("name,want", [("exact", 1), ("q8", 2),
                                       ("topk", 2)])
def test_one_message_per_wire_tensor_by_the_perm(ranks, pname, name, want):
    """Rank r receives from perm[r] and sends to the j with perm[j] == r:
    one message per wire tensor each way. Under SGP's shift the two peers
    differ; a fixed point of a partial matching posts nothing."""
    perm = PERMS[pname]
    for r, res in enumerate(ranks):
        ev = res[("flat", name, pname, False)][1]
        if perm[r] == r:
            assert ev == []
            continue
        dst = int(np.flatnonzero(perm == r)[0])
        assert [e[1] for e in ev if e[0] == "isend"] == [dst] * want
        assert [e[1] for e in ev if e[0] == "irecv"] == [perm[r]] * want
        assert (dst != perm[r]) == (pname == "shift")


def test_drawn_uniforms_are_each_ranks_own(ref, ranks):
    """Drawn, the uniforms come from each rank's generator folded from
    the run's: the exchange equals the one-shard exchange with those
    draws concatenated, bitwise, and the run's generator moves on alike
    on every rank."""
    us = []
    for r in range(N):
        g = torch.Generator().manual_seed(7)
        us.append(torch.rand((1, 2048), generator=NodeMesh(
            r, N, torch.device("cpu")).fold_generator(g)))
    want, _ = TB.gossip_flat_coded(
        LatticeCodec(TS.ModularQuantConfig()), _t(ref["buf"]),
        _t(ref["prev"]), _t(PERMS["shift"]), torch.ones(N, dtype=torch.bool),
        None, u=torch.cat(us))
    _bits(torch.cat([r["drawn"][0] for r in ranks]).numpy(), want.numpy())
    states = [r["drawn"][1] for r in ranks]
    assert all(torch.equal(states[0], s) for s in states)
    assert torch.equal(states[0], g.get_state())


# ---------------------------------------------------------------------------
# The node mean and the dense mix
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_mean_matches_jax_and_one_shard(ref, ranks, masked):
    """The mesh's (masked) mean: within 4 ulp of the reference, bitwise
    the one-shard mean (the rows all-gathered and reduced as on one
    shard), the same on every rank."""
    got = torch.cat([r[("mean", masked)] for r in ranks])
    assert _within_ulp(got.numpy(), ref[("mean", masked)])
    want = TB.gossip_flat_mean(_t(ref["buf"]),
                               _t(ref["mask"]) if masked else None)
    _bits(got.numpy(), want.contiguous().numpy())
    assert all(torch.equal(got[0], got[i]) for i in range(N))


@pytest.mark.parametrize("wname", ["ring", "masked"])
def test_matrix_matches_jax_and_one_shard(ref, ranks, wname):
    """The rank's row of W X (Metropolis weights of a ring, and masked):
    within 4 ulp of the reference, bitwise the one-shard product's row."""
    got = torch.cat([r[("matrix", wname)] for r in ranks])
    assert _within_ulp(got.numpy(), ref[("matrix", wname)])
    w = ref["W"] if wname == "ring" else ref["W_masked"]
    want = TB.gossip_flat_matrix(_t(w), _t(ref["buf"]))
    _bits(got.numpy(), want.numpy())
    np.testing.assert_allclose(
        ref["W_masked"], masked_metropolis(_t(ref["W"]), _t(ref["mask"])),
        rtol=0, atol=1e-7)


# ---------------------------------------------------------------------------
# The per-leaf oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pname", list(PERMS))
@pytest.mark.parametrize("name", ["exact", "q8"])
def test_per_leaf_oracle_matches_jax_and_one_shard(ref, ranks, name, pname):
    """``gossip_exact`` / ``gossip_quantized`` leaf by leaf on the mesh:
    exact within 4 ulp of the reference and q8 within a lattice step on
    >= 99.98% within 2e-5; bitwise the one-shard oracle with the ranks'
    uniforms concatenated; one message per leaf (two per leaf q8) at a
    rank with a partner."""
    got = {k: torch.cat([r[("leaf", name, pname)][0][k] for r in ranks])
           for k in ref["tree"]}
    want = ref[("leaf", name, pname)]
    for k in sorted(ref["tree"]):
        if name == "exact":
            assert _within_ulp(got[k].numpy(), want[k])
        else:
            d = np.abs(got[k].numpy() - want[k])
            assert d.max() <= 0.05 and (d <= 2e-5).mean() >= 0.9998, d.max()
    perm = _t(PERMS[pname])
    matched = _t(_matched(pname, True))
    tree, tprev = _port(ref["tree"]), _port(ref["tprev"])
    one = TE.gossip_exact(tree, perm, matched) if name == "exact" else \
        TE.gossip_quantized(TS.ModularQuantConfig(), tree, tprev, perm,
                            matched, None,
                            u=[_t(a) for a in ref["u_leaf"]])
    for k in sorted(ref["tree"]):
        _bits(got[k].numpy(), one[k].numpy())
    per = 3 if name == "exact" else 6
    for r, res in enumerate(ranks):
        ev = res[("leaf", name, pname)][1]
        k = 0 if PERMS[pname][r] == r else per
        assert (_count(ev, "isend"), _count(ev, "irecv")) == (k, k)


@pytest.mark.parametrize("pname", list(PERMS))
def test_flat_exact_equals_gather_legacy(ranks, pname):
    """``mix_pair`` on the mesh: flat gather exact == its ``gather_legacy``
    per-leaf oracle, bitwise."""
    for r in ranks:
        flat, leaf = r[("flat_vs_legacy", pname)]
        for k in flat:
            _bits(flat[k].numpy(), leaf[k].numpy())


@pytest.mark.parametrize("what", ["mean", "matrix"])
def test_legacy_collectives_equal_one_shard(ref, ranks, what):
    """The oracle's mean and mix, leaf by leaf on the mesh (each leaf
    all-gathered), bitwise the one-shard oracle's."""
    tr = TE.GossipTransport(N, impl="gather_legacy")
    tree = _port(ref["tree"])
    one = tr.global_mean(tree, _t(ref["mask"])) if what == "mean" else \
        tr.matrix_mix(tree, _t(ref["W"]))
    for k in one:
        _bits(torch.cat([r[("leaf", what)][k] for r in ranks]).numpy(),
              one[k].numpy())


# ---------------------------------------------------------------------------
# The engine and the baselines on the mesh
# ---------------------------------------------------------------------------


def _partner(case, rec, t):
    if case.startswith("sgp"):
        return (np.arange(N) - 2 ** (t % 2)) % N
    return rec["perm"]


class _NoLog:
    events: list = []


def _check_step(ref, ranks, model, case):
    """Each step on the mesh: bitwise the one-shard port's step from the
    same state and uniforms; against the reference, exact within 2e-5, q8
    within one lattice step of the partner's row and top-k within half
    its largest shipped magnitude, on >= 99.9% within 2e-5 (the bound the
    one-card engine tests hold the same step to: the port's local steps
    are eager torch, the reference's contract multiply-adds, so codes at
    an integer edge flip — ROADMAP.md Queue C 6); the loss and
    matched_frac the reference's, Γ the one-shard Γ of the same
    parameters; every metric equal on every rank."""
    codec = "topk" if "topk" in case else ("q8" if "q8" in case else "exact")
    one_step = _port_step(model, case, None, _NoLog())
    for t in range(STEPS):
        rec = ref[(model, case, t)]
        per = [r[(model, case, t)] for r in ranks]
        got = np.concatenate([_flat(p["params"]) for p in per])
        one, _ = _drive(model, case, rec, one_step, None, t)
        _bits(got, _flat(one.params))
        if per[0]["residual"] is not None:
            _bits(torch.cat([p["residual"] for p in per]).numpy(),
                  one.residual.numpy())
        want = _flat(rec["after"][0])
        if codec == "exact":
            np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
        else:
            if case.startswith("overlap"):
                term = np.asarray(rec["state"][3]["wire"][1])
            else:
                term = torch.cat([p["scales"] for p in per]).numpy()
            if codec == "topk":
                term = 0.5 * term
            r = _readings(got, want, term, _partner(case, rec, t))
            assert _ok(r, 0.999), (t, r)
            if codec == "topk":
                res = torch.cat([p["residual"] for p in per]).numpy()
                r = _readings(res, rec["after"][4], 2 * term)
                assert _ok(r, 0.999), ("residual", t, r)
        for k in ("loss", "gamma", "matched_frac"):
            if k not in rec:
                continue
            vals = [p[k] for p in per]
            assert len(set(vals)) == 1, (k, vals)
            if k == "gamma":
                params = sgp_debias(one.params) if case.startswith("sgp") \
                    else one.params
                np.testing.assert_allclose(
                    vals[0], float(gamma_potential(params)), rtol=1e-5)
                if codec != "exact":
                    continue      # Γ reads the flipped codes too
            np.testing.assert_allclose(vals[0], rec[k],
                                       rtol=1e-5 if k == "loss" else 1e-4,
                                       atol=1e-9)


ENGINE_CASES = [(m, c) for m in MODELS for c in ENGINES]
BASELINE_CASES = [(m, c) for m in MODELS for c in BASELINES]


@pytest.mark.parametrize("model,case", ENGINE_CASES,
                         ids=[f"{m}-{c}" for m, c in ENGINE_CASES])
def test_engine_on_gather_matches_jax(ref, ranks, model, case):
    """Three supersteps of the swarm engine on gather, each restarted from
    the reference's state on every rank: exact within 2e-5, q8 within a
    lattice step of the partner's row on >= 99.98% within 2e-5, top-k
    within half the partner's largest shipped magnitude (its residual
    likewise); the loss, Γ and matched_frac the reference's global
    metrics, equal on every rank."""
    _check_step(ref, ranks, model, case)


@pytest.mark.parametrize("model,case", BASELINE_CASES,
                         ids=[f"{m}-{c}" for m, c in BASELINE_CASES])
def test_baseline_on_the_mesh_matches_jax(ref, ranks, model, case):
    """Three steps of each baseline through ``make_algorithm(...,
    mesh=...)``, each restarted from the reference's state: held as the
    engine is; all-reduce's nodes stay equal."""
    _check_step(ref, ranks, model, case)
    if case.startswith("allreduce"):
        for t in range(STEPS):
            rows = [_flat(r[(model, case, t)]["params"]) for r in ranks]
            assert all(np.array_equal(rows[0], x) for x in rows)


@pytest.mark.parametrize("case", ["blocking-q8", "overlap-q8"])
def test_engine_posts_its_exchange_where_its_mode_says(ranks, case):
    """The blocking superstep posts its q8 exchange (codes and scales, one
    message each way) after its last local step, the overlapped one
    before its first."""
    for res in ranks:
        for t in range(STEPS):
            ev = res[("linear", case, t)]["events"]
            kinds = [e[0] for e in ev]
            sgd = [i for i, k in enumerate(kinds) if k == "sgd"]
            first = kinds.index("isend")
            assert len(sgd) == H and _count(ev, "isend") == 2
            assert (first < sgd[0]) if case.startswith("overlap") \
                else (first > sgd[-1])


@pytest.mark.parametrize("case", ["sgp-masked", "sgp-q8"])
def test_sgp_shift_goes_to_the_out_neighbour(ranks, case):
    """SGP's push by 2^(t mod log2 n): at t = 0 and 2 (shift 1, not an
    involution) rank r sends to r + 1 and receives from r - 1; at t = 1
    (shift 2) both are r + 2."""
    for r, res in enumerate(ranks):
        for t in range(STEPS):
            ev = res[("linear", case, t)]["events"]
            s = 2 ** (t % 2)
            assert {e[1] for e in ev if e[0] == "isend"} == {(r + s) % N}
            assert {e[1] for e in ev if e[0] == "irecv"} == {(r - s) % N}


# ---------------------------------------------------------------------------
# Elastic membership
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", MODELS)
def test_join_step_on_the_mesh(ref, ranks, model):
    """One join bin: bitwise the reference's (the joiner's model, its comm
    copy re-based, its residual zeroed, every other rank untouched) and
    the one-shard port's; the donor sends one message, the joiner
    receives it, no other rank posts."""
    rec = ref[("join", model)]
    want = rec["after"]
    one = make_join_step(SwarmConfig(n_nodes=N, quantize=True,
                                     codec="topk:0.25"))(
        _port_state(rec["state"], None, 0), rec["perm"], rec["jm"])
    for r, res in enumerate(ranks):
        got, ev = res[("join", model)]
        _bits(_flat(got.params), _flat(_rows(want[0], r)))
        _bits(_flat(got.prev), _flat(_rows(want[2], r)))
        _bits(got.residual.numpy(), np.asarray(want[4])[r:r + 1])
        _bits(_flat(got.params), _flat(_rows(one.params, r)))
        donor = int(rec["perm"][2])
        kinds = [(e[0], e[1]) for e in ev]
        assert kinds == ([("isend", 2)] if r == donor else
                         [("irecv", donor)] if r == 2 else [])


def test_retire_nodes_reads_the_ranks_entry(ref, ranks):
    want = retire_nodes(SwarmState({}, {}, None, 0, None, _t(ref["res"])),
                        MASK).residual
    _bits(torch.cat([r["retired"] for r in ranks]).numpy(), want.numpy())


def test_bridge_bins_drive_the_mesh_engine(ranks):
    """``sched/bridge.py``'s churn bins — participation masks, per-node h,
    exclusive join bins, retirements — drive the mesh engine unchanged:
    every bin equals the one-shard run within 1e-6, each join bin's joiner
    bitwise its donor's model before it and every other node untouched."""
    from repro_torch import sched as S
    sched = _churn_schedule()
    joins = np.flatnonzero(sched.kinds == S.EVENT_JOIN)
    assert len(joins) and sched.mask.sum(1).min() < N
    assert len({tuple(h) for h in sched.h}) > 1
    one = _bridge_run()
    got = [torch.cat([r["bridge"][s] for r in ranks])
           for s in range(sched.n_supersteps)]
    for s in range(sched.n_supersteps):
        np.testing.assert_allclose(got[s].numpy(), one[s].numpy(),
                                   rtol=0, atol=1e-6)
    for s in joins:
        joiner = int(np.flatnonzero(sched.mask[s])[0])
        donor = int(sched.perms[s][joiner])
        before = got[s - 1]
        _bits(got[s][joiner].numpy(), before[donor].numpy())
        others = np.arange(N) != joiner
        _bits(got[s][others].numpy(), before[others].numpy())


# ---------------------------------------------------------------------------
# Planted faults
# ---------------------------------------------------------------------------


def test_send_to_perm_fault_shows_only_on_the_shift(ref, ranks):
    """A rank that sends to perm[r] instead of to the j with perm[j] == r
    is right on a matching (an involution: the two coincide) and wrong on
    SGP's shift, where the reference's bound catches it."""
    got = torch.cat([r[("fault", "send_to_perm", "match")] for r in ranks])
    _bits(got.numpy(), torch.cat([r[("flat", "exact", "match", False)][0][0]
                                  for r in ranks]).numpy())
    got = torch.cat([r[("fault", "send_to_perm", "shift")] for r in ranks])
    assert not _within_ulp(got.numpy(), ref[("flat", "exact", "shift",
                                             False)][0])


@pytest.mark.parametrize("fault", ["own_row_mean", "wrong_row",
                                   "missed_wait"])
def test_planted_faults_fail(ref, ranks, fault):
    got = torch.cat([r[("fault", fault)] for r in ranks]).numpy()
    if fault == "own_row_mean":
        assert not _within_ulp(got, ref[("mean", False)])
    elif fault == "wrong_row":
        assert not _within_ulp(got, ref[("matrix", "ring")])
    else:
        want = ref[("flat", "q8", "shift", False)][0]
        r = _readings(got, want, np.asarray(ref[("wire", "q8")][1]),
                      PERMS["shift"])
        assert not _ok(r), r
        ok = torch.cat([r[("flat", "q8", "shift", False)][0][0]
                        for r in ranks]).numpy()
        assert _ok(_readings(ok, want, np.asarray(ref[("wire", "q8")][1]),
                             PERMS["shift"]))


def test_what_a_mesh_still_refuses():
    """What a mesh does not carry yet: more than one node a rank; nothing
    else (the chunk driver runs there)."""
    assert set(TB.NOT_ON_A_MESH) == {"nodes_per_shard"}
    mesh = NodeMesh(0, N, torch.device("cpu"))
    with pytest.raises(ValueError, match="Queue A 6"):
        make_join_step(SwarmConfig(n_nodes=2 * N), mesh=mesh)
    with pytest.raises(ValueError, match="perm"):
        TB.gather_peers(np.arange(2 * N), mesh)
    with pytest.raises(ValueError, match="Queue A 6"):
        TB.gossip_flat_exact(torch.zeros(2, 256), PERMS["match"], mesh=mesh)
    with pytest.raises(ValueError, match="mesh"):
        make_algorithm("sgp", loss_fn=None, opt_update=None,
                       lr_fn=lambda s: LR, n_nodes=N, mesh=mesh,
                       transport=TE.GossipTransport(N))
    st = sgp_init_state(SwarmState({"w": torch.zeros(1, 3)}, {}, None, 0),
                        N, mesh=mesh)
    assert st.params["w"].shape == (1,)
