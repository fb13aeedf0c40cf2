"""The port's node mesh against the JAX package's multi-shard path, on the
CPU: one node a ``torch.distributed`` rank (``repro_torch/launch/mesh.py``,
gloo here), against the reference's static-matching transports run under
``shard_map`` over a real 4-device mesh.

* The reference: one subprocess with 4 fake CPU devices
  (``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as the
  reference's own multi-device tests set it) executes, jitted,
  ``bucket.gossip_flat_ppermute`` / ``_pool`` (exact, q4, q8, q16, bf16,
  with and without a mask), ``bucket.permute_payload_ppermute`` /
  ``_pool``, ``exchange.gossip_ppermute`` / ``_pool`` (exact and q8) and
  ``make_swarm_step(mesh=..., node_axes=("node",), static_pairs=...)``
  for 3 supersteps (blocking exact, blocking / non-blocking / overlapped
  q8, non-blocking exact with the momentum averaged) on the linear loss of
  ``tests/test_async_pipeline.py``, and blocking / non-blocking /
  overlapped q8 on transformer-wmt reduced to 1 layer of d_model 32. It
  saves the inputs, the uniforms each shard drew (``fold_in(key, idx)``
  on the flat path; on the per-leaf path the unfolded split, the same on
  every shard; the overlapped encode's global draw) and the outputs.
* The port: 4 gloo ranks (spawned, rendezvous through a file) run the same
  cases with the reference's uniforms injected, each engine superstep
  restarted from the reference's state, and record the point-to-point
  messages each rank posts.

The contract: wire codes, scales and byte counts bitwise; exact floats
within 4 ulp of the jitted reference; q8 within one lattice step of the
partner's row and >= 99.98% within 2e-5 (ROADMAP.md Queue C 6); the
multi-shard exchange bitwise the port's one-shard exchange of the same
buffers by the lifted perm with the ranks' uniforms concatenated (every
codec, both pool forms, the per-leaf oracles); 1 / 2 / one-per-leaf
messages; the overlapped step posts its exchange before its first local
step; planted faults (a mask ignored, a partner off by one, a missed wait
on the received tensors) fail. This file imports no JAX: the reference
runs in its own process.
"""
import os
import pickle
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.algorithms import make_algorithm, validate_run_config
from repro_torch.configs import get_config, reduced
from repro_torch.core import bucket as TB
from repro_torch.core import exchange as TE
from repro_torch.core.potential import gamma_potential
from repro_torch.core.scan import make_superstep_scan
from repro_torch.core.swarm import (SwarmConfig, SwarmState, make_swarm_step,
                                    swarm_init)
from repro_torch.launch.mesh import NodeMesh, init_node_mesh
from repro_torch.models import TransformerLM
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import make_optimizer
from repro_torch.quant import schemes as TS
from repro_torch.quant.codecs import make_codec
from repro_torch.tree import tree_leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
N = 4
PERM = np.array([2, 3, 0, 1])
PAIRS = TB.pairs_from_perm(PERM)
POOL = [np.arange(N), np.array([1, 0, 3, 2]), np.array([2, 1, 0, 3])]
POOL_IDX = 2          # ranks 1 and 3 unmatched in this entry
CODECS = ("exact", "q4", "q8", "q16", "bf16")
FORMS = ("static", "pool")
H, STEPS, LR, D = 2, 3, 0.05, 12
ENGINES = ("linear/exact/blocking", "linear/exact/nonblocking-mom",
           "linear/q8/blocking", "linear/q8/nonblocking",
           "linear/q8/overlap", "wmt/q8/blocking", "wmt/q8/nonblocking",
           "wmt/q8/overlap")
# held to the reference run eagerly (JAX_DISABLE_JIT): the contract is the
# eager reference's floats (ROADMAP.md C 6). Jitted, XLA contracts the
# transformer's multiply-adds into FMAs, by rules that depend on the host's
# CPU, and moved a q8 code at an integer edge in this case's superstep 0
# (0.999764 within 2e-5 on one host); the non-blocking and overlapped
# cases' first exchange moves nothing (C 8), and on the linear loss the
# two differ by an ulp or two, far inside the bound
EAGER_ENGINES = ("wmt/q8/blocking",)

_REFERENCE = textwrap.dedent('''
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    sys.path.insert(0, "src")
    import pickle
    from concurrent.futures import ThreadPoolExecutor
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.compat import make_mesh_compat
    from repro.configs import get_config, reduced
    from repro.core import bucket as B
    from repro.core import exchange as E
    from repro.core.swarm import SwarmConfig, make_swarm_step, swarm_init
    from repro.models import init_params, loss_fn
    from repro.optim import make_optimizer
    from repro.quant.codecs import make_codec
    from repro.quant.schemes import ModularQuantConfig

    N, H, STEPS, LR, D, BATCH, SEQ = 4, 2, 3, 0.05, 12, 4, 16
    PERM = np.array([2, 3, 0, 1])
    PAIRS = B.pairs_from_perm(PERM)
    POOL = [np.arange(N), np.array([1, 0, 3, 2]), np.array([2, 1, 0, 3])]
    POOL_IDX = 2
    MASK = np.array([True, True, False, True])
    AX = ("node",)
    mesh = make_mesh_compat((N,), AX)
    rng = np.random.default_rng(11)
    buf = rng.normal(size=(N, 2048)).astype(np.float32)
    prev = (buf + 0.01 * rng.normal(size=buf.shape)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    out = {"buf": buf, "prev": prev, "mask": MASK,
           "u_flat": np.stack([np.asarray(jax.random.uniform(
               jax.random.fold_in(key, r), (1, 2048)))[0] for r in range(N)]),
           "payload": (buf, rng.integers(0, 256, size=(N * 8, 256))
                       .astype(np.uint8))}
    CODECS = {"exact": None, "q4": ModularQuantConfig(bits=4),
              "q8": ModularQuantConfig(), "q16": ModularQuantConfig(bits=16),
              "bf16": make_codec("bf16")}
    tree = {"a": rng.normal(size=(N, 6, 16)).astype(np.float32),
            "b": rng.normal(size=(N, 7)).astype(np.float32),
            "c": rng.normal(size=(N, 3, 5)).astype(np.float32)}
    tprev = {k: (v + 0.01 * rng.normal(size=v.shape)).astype(np.float32)
             for k, v in tree.items()}
    out["tree"], out["tprev"] = tree, tprev
    lkey = jax.random.PRNGKey(5)
    # a key a leaf, split once on each shard: every shard draws the same
    out["u_leaf"] = [np.asarray(jax.random.uniform(
        jax.random.split(sub, 1)[0],
        (-(-int(np.prod(tree[k].shape[1:])) // 256), 256)))
        for k, sub in zip(sorted(tree), jax.random.split(lkey, len(tree)))]


    def flat(name):
        q = CODECS[name]
        for masked in (False, True):
            f = jax.jit(lambda b, pv, k, m: (
                B.gossip_flat_ppermute(b, mesh, AX, PAIRS, quant=q,
                                       prev_buf=pv, rng=k, mask=m),
                B.gossip_flat_ppermute_pool(b, mesh, AX, POOL, POOL_IDX,
                                            quant=q, prev_buf=pv, rng=k,
                                            mask=m)))
            st, po = f(jnp.asarray(buf), jnp.asarray(prev), key,
                       jnp.asarray(MASK) if masked else None)
            out[("flat", name, masked, "static")] = np.asarray(st)
            out[("flat", name, masked, "pool")] = np.asarray(po)
        if q is not None:
            # each shard's wire: the encode of its rows, its key folded
            codec = B.as_codec(q)
            enc = jax.jit(lambda b, pv, k: codec.encode(b, pv, k))
            wires = [jax.device_get(enc(jnp.asarray(buf[r:r + 1]),
                                        jnp.asarray(prev[r:r + 1]),
                                        jax.random.fold_in(key, r)))
                     for r in range(N)]
            out[("wire", name)] = tuple(np.concatenate(g)
                                        for g in zip(*wires))
            out[("bytes", name)] = B.build_layout(
                {"b": jnp.zeros((N, 2048))}).payload_num_bytes(q)


    def permutes():
        st, po = jax.jit(lambda p: (
            B.permute_payload_ppermute(p, mesh, AX, PAIRS, N),
            B.permute_payload_pool(p, mesh, AX, POOL, POOL_IDX, N)))(
                tuple(jnp.asarray(x) for x in out["payload"]))
        out[("permuted", "static")] = jax.device_get(st)
        out[("permuted", "pool")] = jax.device_get(po)


    def per_leaf(name):
        q = None if name == "exact" else ModularQuantConfig()
        specs = {k: P("node", *([None] * (v.ndim - 1)))
                 for k, v in tree.items()}
        r, rp = jax.jit(lambda t_, p_, k_: (
            E.gossip_ppermute(t_, specs, mesh, AX, PAIRS, quant=q, prev=p_,
                              rng=k_),
            E.gossip_ppermute_pool(t_, specs, mesh, AX, POOL, POOL_IDX,
                                   quant=q, prev=p_, rng=k_)))(
            jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, tprev),
            lkey)
        out[("leaf", name, "static")] = jax.device_get(r)
        out[("leaf", name, "pool")] = jax.device_get(rp)


    wcfg = reduced(get_config("transformer-wmt"), n_layers=1, d_model=32)
    MODELS = {
        "linear": (lambda p, mb: 0.5 * jnp.mean((mb["x"] @ p["w"] - mb["y"])
                                                ** 2),
                   lambda k: {"w": jax.random.normal(k, (D,)) * 0.3}),
        "wmt": (lambda p, mb: loss_fn(wcfg, p, mb),
                lambda k: init_params(k, wcfg))}


    def batch_of(model, t):
        r = np.random.default_rng(100 + t)
        if model == "linear":
            return {"x": r.normal(size=(N, H, BATCH, D)).astype(np.float32),
                    "y": r.normal(size=(N, H, BATCH)).astype(np.float32)}
        tok = r.integers(0, wcfg.vocab_size, size=(N, H, BATCH, SEQ + 1))
        return {"tokens": tok[..., :-1].astype(np.int32),
                "targets": tok[..., 1:].astype(np.int32)}


    def engine(case):
        model, codec, mode = case.split("/")
        loss, init = MODELS[model]
        q8 = codec == "q8"
        scfg = SwarmConfig(n_nodes=N, H=H, quantize=q8,
                           quant=ModularQuantConfig(safety=16.0), codec=None,
                           nonblocking=mode != "blocking",
                           overlap=mode == "overlap", gossip_impl="ppermute",
                           average_momentum=mode.endswith("-mom"))
        opt = make_optimizer("sgd", lr=LR, momentum=0.9)
        with mesh:
            state = swarm_init(jax.random.PRNGKey(0), scfg, init, opt.init,
                               same_init=q8)
            step = jax.jit(make_swarm_step(
                scfg, loss, opt.update, lambda s: LR, mesh=mesh,
                node_axes=AX, static_pairs=PAIRS))
            n_pad = B.build_layout(state.params).n_padded
            h = jnp.full((N,), H, jnp.int32)
            for t in range(STEPS):
                before = jax.device_get((state.params, state.opt, state.prev,
                                         state.inflight))
                b = batch_of(model, t)
                skey = jax.random.PRNGKey(1000 + t)
                state, m = step(state, jax.tree.map(jnp.asarray, b),
                                jnp.asarray(PERM), h, skey)
                if mode == "overlap":      # the next payload's encode
                    u = np.asarray(jax.random.uniform(skey, (N, n_pad)))
                else:                      # each shard's, its key folded
                    u = np.stack([np.asarray(jax.random.uniform(
                        jax.random.fold_in(skey, r), (1, n_pad)))[0]
                        for r in range(N)])
                out[("engine", case, t)] = {
                    "state": before, "batch": b, "u": u,
                    "after": jax.device_get(state.params),
                    **{k: float(m[k]) for k in ("loss", "gamma",
                                                "matched_frac")}}


    engines = [lambda c=c: engine(c) for c in sys.argv[2].split(",") if c]
    only_engines = sys.argv[3:] == ["engines"]
    tasks = engines if only_engines else \\
        [lambda n=n: flat(n) for n in CODECS] + [permutes] + \\
        [lambda n=n: per_leaf(n) for n in ("exact", "q8")] + engines
    # the eager run one case at a time: eager shard_map programs run from
    # several threads at once were seen to hang in their collectives
    with ThreadPoolExecutor(1 if only_engines else len(tasks)) as ex:
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
    return tmp_path_factory.mktemp("multishard")


@pytest.fixture(scope="module")
def ref(workdir):
    """The reference's multi-shard run (its own process: the fake device
    count is fixed when JAX starts); the EAGER_ENGINES cases in a second
    process at the same time, with jit disabled."""
    jitted = [c for c in ENGINES if c not in EAGER_ENGINES]
    runs = []
    for name, cases, extra, env in (
            ("ref", jitted, [], {}),
            ("ref_eager", EAGER_ENGINES, ["engines"],
             {"JAX_DISABLE_JIT": "1"})):
        path = workdir / f"{name}.pkl"
        proc = subprocess.Popen(
            [sys.executable, "-c", _REFERENCE, str(path), ",".join(cases)]
            + extra, cwd=ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu",
                                        **env),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        runs.append((path, proc))
    out = {}
    try:
        for path, proc in runs:
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
            with open(path, "rb") as f:
                out.update(pickle.load(f))
    finally:
        for _, proc in runs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    # the ranks read the two runs as one
    with open(workdir / "ref.pkl", "wb") as f:
        pickle.dump(out, f)
    return out


@pytest.fixture(scope="module")
def ranks(ref, workdir):
    """The port's 4 gloo ranks over every case; -> each rank's results."""
    mp.spawn(_rank_main, args=(str(workdir),), nprocs=N, join=True)
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False)
            for r in range(N)]


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_quant(name):
    return {"exact": None, "q4": TS.ModularQuantConfig(bits=4),
            "q8": TS.ModularQuantConfig(),
            "q16": TS.ModularQuantConfig(bits=16),
            "bf16": make_codec("bf16")}[name]


class _P2PLog:
    """Records the point-to-point messages this rank posts ((kind, peer,
    bytes)), what each exchange received, and the local steps (("sgd",))
    in one event list."""

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
                # the planted fault: the decode reads the receive buffers
                # as they were before the transfer landed
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


def _rows(tree, r, n=1):
    return tree_map(lambda a: a[r * n:(r + 1) * n], tree)


def _port_engine(case, mesh, log):
    model, codec, mode = case.split("/")
    q8 = codec == "q8"
    scfg = SwarmConfig(n_nodes=N, H=H, quantize=q8,
                       quant=TS.ModularQuantConfig(safety=16.0),
                       nonblocking=mode != "blocking",
                       overlap=mode == "overlap", gossip_impl="ppermute",
                       average_momentum=mode.endswith("-mom"))
    opt = make_optimizer("sgd", lr=LR, momentum=0.9)
    if model == "linear":
        def loss(p, mb):
            return 0.5 * torch.mean((mb["x"] @ p["w"] - mb["y"]) ** 2)
    else:
        loss = TransformerLM(reduced(get_config("transformer-wmt"),
                                     n_layers=1, d_model=32)).functional_loss

    def update(*a):
        log.events.append(("sgd",))
        return opt.update(*a)
    tr = TE.GossipTransport(N, impl="ppermute", quant=scfg.quant,
                            codec=scfg.make_codec(), static_pairs=PAIRS,
                            mesh=mesh)
    return make_swarm_step(scfg, loss, update, lambda s: LR, transport=tr,
                           mesh=mesh)


def _port_state(np_state, r, t):
    params, opt, prev, infl = np_state
    conv = (lambda x: None if x is None
            else params_from_numpy(_rows(x, r), "cpu"))
    if infl is not None:
        rpn = infl["sbuf"].shape[1] // 256
        infl = {"sbuf": _t(infl["sbuf"][r:r + 1]),
                "prev": _t(infl["prev"][r:r + 1]),
                "wire": tuple(_t(w[r * rpn:(r + 1) * rpn])
                              for w in infl["wire"])}
    return SwarmState(conv(params), conv(opt), conv(prev), t, infl)


def _compress_state_run(mesh=None, rank=0):
    """Two blocking q8 supersteps of the linear model with the comm copy
    kept as the codec's wire (compress_state), from a seeded state, every
    uniform given; on a node `mesh` the rank's node of the same run. ->
    the params after each superstep, packed."""
    rng = np.random.default_rng(21)
    scfg = SwarmConfig(n_nodes=N, H=H, quantize=True, compress_state=True,
                       gossip_impl="ppermute",
                       quant=TS.ModularQuantConfig(safety=16.0))
    opt = make_optimizer("sgd", lr=LR, momentum=0.9)
    params = {"w": _t((0.3 * rng.normal(size=(1, D))
                       + 0.01 * rng.normal(size=(N, D))).astype(np.float32))}
    lay = TB.build_layout(params)
    us = [_t(rng.random((N, lay.n_padded)).astype(np.float32))
          for _ in range(5)]
    batches = [{"x": _t(rng.normal(size=(N, H, 4, D)).astype(np.float32)),
                "y": _t(rng.normal(size=(N, H, 4)).astype(np.float32))}
               for _ in range(2)]
    codec = scfg.make_codec()
    prev = codec.encode_state(TB.pack(lay, params), None, u=us[0])
    n = 1 if mesh is not None else N
    rows = (lambda x: x) if mesh is None else \
        (lambda x: _rows(x, rank, x.shape[0] // N))
    state = SwarmState(tree_map(rows, params),
                       opt.init(tree_map(rows, params)),
                       tuple(rows(w) for w in prev), 0)
    assert tree_leaves(state.params)[0].shape[0] == n
    step = make_swarm_step(
        scfg, lambda p, mb: 0.5 * torch.mean((mb["x"] @ p["w"] - mb["y"])
                                             ** 2),
        opt.update, lambda s: LR, transport=TE.GossipTransport(
            N, impl="ppermute", quant=scfg.quant, codec=codec,
            static_pairs=PAIRS, mesh=mesh), mesh=mesh)
    out = []
    for t in range(2):
        state, _ = step(state, tree_map(rows, batches[t]), PERM,
                        np.full((N,), H), None, u=rows(us[1 + 2 * t]),
                        u_state=rows(us[2 + 2 * t]))
        out.append(TB.pack(TB.build_layout(state.params), state.params))
    return out


def _rank_main(rank, workdir):
    torch.set_num_threads(1)
    mesh = init_node_mesh("cpu", rank=rank, world_size=N,
                          init_method=f"file://{workdir}/rendezvous")
    with open(f"{workdir}/ref.pkl", "rb") as f:
        ref = pickle.load(f)
    log = _P2PLog()
    out = {}
    r1 = slice(rank, rank + 1)
    buf, prev, u = (_t(ref[k][r1]) for k in ("buf", "prev", "u_flat"))
    mask = _t(ref["mask"])
    try:
        for name in CODECS:
            for masked in (False, True):
                for form in FORMS:
                    kw = dict(quant=_port_quant(name), prev_buf=prev, u=u,
                              mask=mask if masked else None, mesh=mesh)
                    got = TB.gossip_flat_ppermute(buf, PAIRS, **kw) \
                        if form == "static" else \
                        TB.gossip_flat_ppermute_pool(buf, POOL, POOL_IDX,
                                                     **kw)
                    ev, rv = log.take()
                    out[("flat", name, masked, form)] = (got, ev, rv)
        # drawn uniforms: the rank's generator folded from the run's
        gen = torch.Generator().manual_seed(7)
        out["drawn"] = (TB.gossip_flat_ppermute(
            buf, PAIRS, quant=TS.ModularQuantConfig(), prev_buf=prev,
            rng=gen, mesh=mesh), gen.get_state())
        log.take()
        p0, p1 = ref["payload"]
        pay = (_t(p0[r1]), _t(p1[rank * 8:(rank + 1) * 8]))
        out[("permuted", "static")] = TB.permute_payload_ppermute(
            pay, PAIRS, N, mesh=mesh)
        out[("permuted", "pool")] = TB.permute_payload_pool(
            pay, POOL, np.full((N,), POOL_IDX), N, mesh=mesh)
        log.take()
        tree = params_from_numpy(_rows(ref["tree"], rank), "cpu")
        tprev = params_from_numpy(_rows(ref["tprev"], rank), "cpu")
        u_leaf = [_t(a)[None] for a in ref["u_leaf"]]
        for name in ("exact", "q8"):
            q = None if name == "exact" else TS.ModularQuantConfig()
            for form in FORMS:
                got = TE.gossip_ppermute(tree, PAIRS, q, tprev, None,
                                         u=u_leaf, mesh=mesh) \
                    if form == "static" else TE.gossip_ppermute_pool(
                        tree, POOL, POOL_IDX, q, tprev, None, u=u_leaf,
                        mesh=mesh)
                out[("leaf", name, form)] = (got, log.take()[0])
        # planted faults on the masked q8 exchange
        q8 = TS.ModularQuantConfig()
        out[("fault", "mask_ignored")] = TB.gossip_flat_ppermute(
            buf, PAIRS, quant=q8, prev_buf=prev, u=u, mesh=mesh)
        shifted = [(s, (d + 1) % N) for s, d in PAIRS]
        out[("fault", "partner_off_by_one")] = TB.gossip_flat_ppermute(
            buf, shifted, quant=q8, prev_buf=prev, u=u, mask=mask,
            mesh=mesh)
        log.missed_wait = True
        out[("fault", "missed_wait")] = TB.gossip_flat_ppermute(
            buf, PAIRS, quant=q8, prev_buf=prev, u=u, mask=mask, mesh=mesh)
        log.missed_wait = False
        log.take()
        # the engine, each superstep restarted from the reference's state
        scales = []
        orig_encode = TB.LatticeCodec.encode

        def encode(codec, b, pv, rng, **kw):
            q_, s_ = orig_encode(codec, b, pv, rng, **kw)
            scales.append(s_.reshape(-1))
            return q_, s_
        TB.LatticeCodec.encode = encode
        for case in ENGINES:
            step = _port_engine(case, mesh, log)
            for t in range(STEPS):
                rr = ref[("engine", case, t)]
                st = _port_state(rr["state"], rank, t)
                b = {k: _t(v[r1]) for k, v in rr["batch"].items()}
                del scales[:]
                st, m = step(st, b, PERM, np.full((N,), H), None,
                             u=_t(rr["u"][r1]))
                out[("engine", case, t)] = {
                    "after": TB.pack(TB.build_layout(st.params), st.params),
                    "scales": scales[0] if scales else None,
                    "events": log.take()[0],
                    **{k: float(m[k]) for k in ("loss", "gamma",
                                                "matched_frac")}}
        TB.LatticeCodec.encode = orig_encode
        out["compress_state"] = _compress_state_run(mesh, rank)
    finally:
        log.undo()
        mesh.close()
    torch.save(out, f"{workdir}/rank{rank}.pt")


# ---------------------------------------------------------------------------
# Helpers of the contract
# ---------------------------------------------------------------------------


def _bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def _np(x):
    """A tensor as numpy, 16-bit codes and bf16 through an int16 view
    (the same bits)."""
    if x.dtype in (torch.uint16, torch.bfloat16):
        return x.view(torch.int16).numpy()
    return x.numpy()


def _within_ulp(got, want, k=4):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return bool(np.all(np.abs(got - want) <= k * np.spacing(np.abs(want))))


def _lattice_readings(got, want, partner_scales):
    """got/want [N, n_padded]; partner_scales [N, rows]: the scale of the
    row each node decoded (its partner's encode)."""
    d = np.abs(np.asarray(got) - np.asarray(want)).reshape(N, -1, 256)
    s = np.asarray(partner_scales).reshape(N, -1, 1)
    finite = np.isfinite(np.asarray(got)).all()
    return {"finite": bool(finite), "max_abs": float(np.nanmax(d)),
            "share_within_2e-5": float((d <= 2e-5).mean()),
            "beyond_one_step": int((~(d <= s + 2e-5)).sum())}


def _lattice_ok(r):
    return r["finite"] and r["beyond_one_step"] == 0 and \
        r["share_within_2e-5"] >= 0.9998


def _pairs_of(form):
    return PAIRS if form == "static" else TB.pairs_from_perm(POOL[POOL_IDX])


def _partner_scales(ref, name, form):
    perm = TB._perm_from_pairs(N, _pairs_of(form))
    s = ref[("wire", name)][1].reshape(N, -1)
    return s[perm]


FLAT_CASES = [(n, m, f) for n in CODECS for m in (False, True)
              for f in FORMS]
FLAT_IDS = [f"{n}-{'masked' if m else 'full'}-{f}" for n, m, f in FLAT_CASES]


# ---------------------------------------------------------------------------
# The flat exchange
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,masked,form", FLAT_CASES, ids=FLAT_IDS)
def test_flat_exchange_matches_jax(ref, ranks, name, masked, form):
    got = _np(torch.cat([r[("flat", name, masked, form)][0] for r in ranks]))
    want = ref[("flat", name, masked, form)]
    if name in ("exact", "bf16"):
        assert _within_ulp(got, want), np.abs(got - want).max()
    else:
        r = _lattice_readings(got, want, _partner_scales(ref, name, form))
        assert _lattice_ok(r), r


@pytest.mark.parametrize("name,masked,form", FLAT_CASES, ids=FLAT_IDS)
def test_flat_exchange_equals_one_shard(ref, ranks, name, masked, form):
    """Multi-shard == the one-shard exchange of the same rows by the
    lifted perm, with the ranks' uniforms concatenated: bitwise."""
    got = torch.cat([r[("flat", name, masked, form)][0] for r in ranks])
    kw = dict(quant=_port_quant(name), prev_buf=_t(ref["prev"]),
              u=_t(ref["u_flat"]), mask=_t(ref["mask"]) if masked else None)
    want = TB.gossip_flat_ppermute(_t(ref["buf"]), PAIRS, **kw) \
        if form == "static" else \
        TB.gossip_flat_ppermute_pool(_t(ref["buf"]), POOL, POOL_IDX, **kw)
    _bits(_np(got), _np(want))


@pytest.mark.parametrize("name", ["q4", "q8", "q16", "bf16"])
def test_wire_crosses_bitwise(ref, ranks, name):
    """Each rank's wire is the reference shard's encode (codes and scales
    bitwise), what its partner received is that wire bit for bit, and the
    bytes posted are the declared payload bytes, the reference's."""
    perm = TB._perm_from_pairs(N, PAIRS)
    sent = [None] * N
    for r, res in enumerate(ranks):
        _, ev, rv = res[("flat", name, False, "static")]
        recv, = rv
        sent[perm[r]] = recv      # rank r received rank perm[r]'s wire
        layout = TB.build_layout({"b": torch.zeros(1, 2048)})
        assert sum(b for k, _, b in ev if k == "isend") == \
            layout.payload_num_bytes(_port_quant(name)) == \
            ref[("bytes", name)]
    for g, want in enumerate(ref[("wire", name)]):
        _bits(_np(torch.cat([w[g] for w in sent])), want)


def test_drawn_uniforms_are_each_ranks_own(ref, ranks):
    """Drawn, the uniforms come from each rank's generator folded from
    the run's (``NodeMesh.fold_generator``): the exchange equals the
    one-shard exchange with those draws concatenated, bitwise, and the
    run's generator moves on alike on every rank."""
    us = []
    for r in range(N):
        g = torch.Generator().manual_seed(7)
        us.append(torch.rand((1, 2048), generator=NodeMesh(
            r, N, torch.device("cpu")).fold_generator(g)))
    assert not torch.equal(us[0], us[1])
    want = TB.gossip_flat_ppermute(_t(ref["buf"]), PAIRS,
                                   quant=TS.ModularQuantConfig(),
                                   prev_buf=_t(ref["prev"]),
                                   u=torch.cat(us))
    _bits(torch.cat([r["drawn"][0] for r in ranks]).numpy(), want.numpy())
    states = [r["drawn"][1] for r in ranks]
    assert all(torch.equal(states[0], s) for s in states)
    assert torch.equal(states[0], g.get_state())


@pytest.mark.parametrize("form", FORMS)
def test_payload_permutes(ref, ranks, form):
    """The in-flight payload's permute: bitwise the reference's (a rank
    the pairs give no source receives zeros, as ``ppermute`` gives), and
    on the matched nodes bitwise the one-shard gather by the lifted perm
    (whose fixed points keep their own rows, never landed)."""
    matched = TB._perm_from_pairs(N, _pairs_of(form)) != np.arange(N)
    one = (TB.permute_payload_ppermute(
        tuple(_t(x) for x in ref["payload"]), PAIRS, N) if form == "static"
        else TB.permute_payload_pool(tuple(_t(x) for x in ref["payload"]),
                                     POOL, torch.tensor([POOL_IDX]), N))
    for i, want in enumerate(ref[("permuted", form)]):
        got = torch.cat([r[("permuted", form)][i] for r in ranks])
        _bits(got.numpy(), want)
        rows = got.reshape(N, -1, *got.shape[1:])
        _bits(rows[matched].numpy(),
              one[i].reshape(rows.shape)[matched].numpy())
        assert not rows[~matched].any()


# ---------------------------------------------------------------------------
# The per-leaf oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("name", ["exact", "q8"])
def test_per_leaf_oracle_matches_jax_and_one_shard(ref, ranks, name, form):
    """The reference's per-leaf shard_map with its unfolded keys (every
    shard the same uniforms): the port's per-leaf oracle on the mesh
    equals it (exact bitwise, q8 within a lattice step), and bitwise the
    one-shard oracle fed those uniforms on every node."""
    got = {k: torch.cat([r[("leaf", name, form)][0][k] for r in ranks])
           for k in ref["tree"]}
    want = ref[("leaf", name, form)]
    for k in sorted(ref["tree"]):
        if name == "exact":
            _bits(got[k].numpy(), want[k])
        else:
            np.testing.assert_allclose(got[k].numpy(), want[k], atol=0.05,
                                       rtol=0)
            assert (np.abs(got[k].numpy() - want[k]) <= 2e-5).mean() \
                >= 0.9998
    q = None if name == "exact" else TS.ModularQuantConfig()
    tree = params_from_numpy(ref["tree"], "cpu")
    tprev = params_from_numpy(ref["tprev"], "cpu")
    u = [_t(a)[None].repeat(N, 1, 1) for a in ref["u_leaf"]]
    one = TE.gossip_ppermute(tree, _pairs_of(form), q, tprev, None, u=u)
    for k in sorted(ref["tree"]):
        _bits(got[k].numpy(), one[k].numpy())


# ---------------------------------------------------------------------------
# Structure: messages per payload, dispatch order
# ---------------------------------------------------------------------------


def _count(ev, kind):
    return sum(1 for e in ev if e[0] == kind)


@pytest.mark.parametrize("name,want", [("exact", 1), ("q4", 2), ("q8", 2),
                                       ("q16", 2), ("bf16", 1)])
def test_one_message_per_payload_tensor(ranks, name, want):
    """The counterpart of ``test_single_ppermute_per_payload_tensor``:
    ONE message per wire tensor each way (1 exact, 2 lattice); a rank the
    pool entry leaves unmatched posts nothing."""
    unmatched = POOL[POOL_IDX] == np.arange(N)
    for r, res in enumerate(ranks):
        ev = res[("flat", name, False, "static")][1]
        assert (_count(ev, "isend"), _count(ev, "irecv")) == (want, want)
        assert {e[1] for e in ev} == {PERM[r]}
        ev = res[("flat", name, False, "pool")][1]
        k = 0 if unmatched[r] else want
        assert (_count(ev, "isend"), _count(ev, "irecv")) == (k, k)


@pytest.mark.parametrize("name,want", [("exact", 3), ("q8", 6)])
def test_per_leaf_oracle_posts_one_message_per_leaf(ranks, name, want):
    for res in ranks:
        ev = res[("leaf", name, "static")][1]
        assert (_count(ev, "isend"), _count(ev, "irecv")) == (want, want)


@pytest.mark.parametrize("mode", ["blocking", "overlap"])
def test_overlapped_step_posts_before_its_local_steps(ranks, mode):
    """The counterpart of
    ``test_pipelined_superstep_dispatches_before_local_loop``: the
    overlapped superstep posts its in-flight exchange (q and s, one
    message each way) before its first local step; the blocking one after
    its last."""
    for res in ranks:
        for t in range(STEPS):
            ev = res[("engine", f"linear/q8/{mode}", t)]["events"]
            kinds = [e[0] for e in ev]
            first_post = kinds.index("isend")
            sgd = [i for i, k in enumerate(kinds) if k == "sgd"]
            assert len(sgd) == H and _count(ev, "isend") == 2
            if mode == "overlap":
                assert first_post < sgd[0]
            else:
                assert first_post > sgd[-1]


# ---------------------------------------------------------------------------
# The engine on the mesh
# ---------------------------------------------------------------------------


def _flat(np_tree):
    t = params_from_numpy(np_tree, "cpu")
    return TB.pack(TB.build_layout(t), t).numpy()


@pytest.mark.parametrize("case", ENGINES)
def test_engine_on_the_mesh_matches_jax(ref, ranks, case):
    """Three supersteps, each restarted from the reference's state: exact
    within 2e-5, q8 within one lattice step of the partner's row and
    >= 99.98% within 2e-5; the loss, Γ and matched_frac the reference's
    global metrics, equal on every rank."""
    _, codec, mode = case.split("/")
    for t in range(STEPS):
        rr = ref[("engine", case, t)]
        got = torch.cat([r[("engine", case, t)]["after"] for r in ranks])
        want = _flat(rr["after"])
        if codec == "exact":
            np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
        else:
            if mode == "overlap":
                s = rr["state"][3]["wire"][1].reshape(N, -1)
            else:
                s = torch.stack([r[("engine", case, t)]["scales"]
                                 for r in ranks]).numpy()
            r = _lattice_readings(got.numpy(), want, s[PERM])
            assert _lattice_ok(r), (t, r)
        for k in ("loss", "gamma", "matched_frac"):
            vals = [r[("engine", case, t)][k] for r in ranks]
            assert len(set(vals)) == 1, (k, vals)
        np.testing.assert_allclose(vals[0], rr["matched_frac"])
        m = ranks[0][("engine", case, t)]
        np.testing.assert_allclose(m["loss"], rr["loss"], rtol=1e-5)
        np.testing.assert_allclose(m["gamma"], rr["gamma"], rtol=1e-4,
                                   atol=1e-9)


def test_compress_state_on_the_mesh_equals_one_shard(ranks):
    """The blocking q8 path with the comm copy kept as the codec's wire
    runs on the mesh (each rank decodes and refreshes its own rows of the
    wire): two supersteps equal the one-shard run of the same state and
    uniforms."""
    want = _compress_state_run()
    for t in range(2):
        got = torch.cat([r["compress_state"][t] for r in ranks])
        np.testing.assert_allclose(got.numpy(), want[t].numpy(), atol=1e-6,
                                   rtol=0)


# ---------------------------------------------------------------------------
# Planted faults
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fault", ["mask_ignored", "partner_off_by_one",
                                   "missed_wait"])
def test_planted_faults_fail(ref, ranks, fault):
    want = ref[("flat", "q8", True, "static")]
    got = torch.cat([r[("fault", fault)] for r in ranks]).numpy()
    r = _lattice_readings(got, want, _partner_scales(ref, "q8", "static"))
    assert not _lattice_ok(r), r
    # the harness itself passes the unplanted run
    ok = torch.cat([r[("flat", "q8", True, "static")][0]
                    for r in ranks]).numpy()
    assert _lattice_ok(_lattice_readings(ok, want, _partner_scales(
        ref, "q8", "static")))


# ---------------------------------------------------------------------------
# Refusals, the mesh, Γ, the generator fold
# ---------------------------------------------------------------------------


def _mesh(rank=0, size=N):
    """A rank's mesh record, no process group (what raises before any
    message is posted)."""
    return NodeMesh(rank, size, torch.device("cpu"))


def _roadmap_queue_a():
    text = (ROOT / "ROADMAP.md").read_text()
    qa = text[text.index("### Queue A"):text.index("### Queue B")]
    return {int(m.group(1)): m.group(2) for m in re.finditer(
        r"^(\d+)\. (.*?)(?=^\d+\. |\Z)", qa, re.S | re.M)}


@pytest.mark.parametrize("what,words", [
    ("gather", ("gather", "global_mean", "matrix_mix")),
    ("scan", ("--scan-chunk", "CUDA graph")),
    ("nodes_per_shard", ("more than one node",))])
def test_refusals_name_their_roadmap_item(what, words):
    """Every refusal names a Queue A item of ROADMAP.md by number, and
    that item is about what is refused; the gather transport and the
    baselines' collectives, and the chunk driver, which a mesh now
    carries, are refused no more and their items are marked done."""
    if what == "gather":
        assert set(TB.NOT_ON_A_MESH) == {"nodes_per_shard"}
        item = next(v for v in _roadmap_queue_a().values()
                    if v.startswith("**gather"))
        assert "done in PR" in item, item[:200]
    elif what == "scan":
        assert "scan" not in TB.NOT_ON_A_MESH
        item = _roadmap_queue_a()[4]
        assert "done in PR" in item, item[:200]
    else:
        m = re.search(r"ROADMAP\.md Queue A (\d+)",
                      TB.NOT_ON_A_MESH[what])
        item = _roadmap_queue_a()[int(m.group(1))]
    for w in words:
        assert w in item, (what, w, item[:200])


def test_refusals_on_a_mesh():
    mesh = _mesh()
    g_pool = [np.arange(N)]
    # gather, the baselines and their chunk drivers build on a mesh; what
    # stays refused there is more than one node a rank (A 6)
    for impl in ("gather", "gather_legacy"):
        assert TE.GossipTransport(N, impl=impl, mesh=mesh).mesh is mesh
        with pytest.raises(ValueError, match="Queue A 6"):
            TE.GossipTransport(2 * N, impl=impl, mesh=mesh)
    from repro_torch.core.graph import make_graph
    extra = {"dpsgd": {"graph": make_graph("complete", N)}}
    for algo in ("allreduce", "localsgd", "dpsgd", "adpsgd", "sgp"):
        assert validate_run_config(algo, n_nodes=N, mesh=mesh) is not None
        assert validate_run_config(algo, n_nodes=N, mesh=mesh,
                                   scan_chunk=4) is not None
        with pytest.raises(ValueError, match="Queue A 6"):
            validate_run_config(algo, n_nodes=2 * N, mesh=mesh)
        step = make_algorithm(algo, loss_fn=lambda p, b: 0.0,
                              opt_update=None, lr_fn=lambda s: LR,
                              n_nodes=N, mesh=mesh, **extra.get(algo, {}))
        assert step.mesh is mesh
        assert make_superstep_scan(step).step is step
        with pytest.raises(ValueError, match="Queue A 6"):
            make_algorithm(algo, loss_fn=lambda p, b: 0.0, opt_update=None,
                           lr_fn=lambda s: LR, n_nodes=2 * N, mesh=mesh,
                           **extra.get(algo, {}))
    assert validate_run_config("swarm", n_nodes=N, mesh=mesh) is not None
    tr = TE.GossipTransport(N, impl="ppermute_pool", matching_pool=g_pool,
                            mesh=mesh)
    for fn in (lambda: tr.global_mean({"w": torch.zeros(2, 3)}),
               lambda: tr.matrix_mix({"w": torch.zeros(2, 3)},
                                     torch.eye(N))):
        with pytest.raises(ValueError, match="Queue A 6"):
            fn()
    # --scan-chunk builds on a mesh
    assert validate_run_config("swarm", gossip_impl="ppermute", mesh=mesh,
                               scan_chunk=4) is not None
    step = make_swarm_step(SwarmConfig(n_nodes=N, gossip_impl="ppermute"),
                           None, None, lambda s: LR,
                           transport=TE.GossipTransport(
                               N, impl="ppermute", static_pairs=PAIRS,
                               mesh=mesh))
    assert make_superstep_scan(step).step is step
    # a residual codec is refused off gather already (the reference's)
    with pytest.raises(ValueError, match="error-feedback"):
        validate_run_config("swarm", gossip_impl="ppermute", quantize=True,
                            codec="topk:0.25", mesh=mesh)
    # one node a rank
    with pytest.raises(ValueError, match="Queue A 6"):
        TE.GossipTransport(8, impl="ppermute", static_pairs=PAIRS, mesh=mesh)
    with pytest.raises(ValueError, match="Queue A 6"):
        make_swarm_step(SwarmConfig(n_nodes=8, gossip_impl="ppermute"),
                        None, None, lambda s: LR, mesh=mesh)
    with pytest.raises(ValueError, match="Queue A 6"):
        swarm_init(torch.Generator(), SwarmConfig(n_nodes=8), None, None,
                   mesh=mesh)
    with pytest.raises(ValueError, match="Queue A 6"):
        TB.gossip_flat_ppermute(torch.zeros(2, 256), PAIRS, mesh=mesh)
    with pytest.raises(ValueError, match="Queue A 6"):
        TE.gossip_ppermute({"w": torch.zeros(2, 3)}, PAIRS, mesh=mesh)
    with pytest.raises(ValueError, match="Queue A 6"):
        TB.permute_payload_ppermute((torch.zeros(1, 8),), PAIRS, 8,
                                    mesh=mesh)
    # a mask of the wrong length, pairs outside the mesh
    with pytest.raises(ValueError, match="mask"):
        TB.gossip_flat_ppermute(torch.zeros(1, 256), PAIRS, mesh=mesh,
                                mask=torch.ones(8, dtype=torch.bool))
    with pytest.raises(ValueError, match="outside"):
        TB.gossip_flat_ppermute(torch.zeros(1, 256), [(0, 5), (5, 0)],
                                mesh=mesh)
    # the transport built on another mesh than the step's
    with pytest.raises(ValueError, match="mesh"):
        make_swarm_step(SwarmConfig(n_nodes=N, gossip_impl="ppermute"),
                        None, None, lambda s: LR,
                        transport=TE.GossipTransport(
                            N, impl="ppermute", static_pairs=PAIRS),
                        mesh=mesh)


def test_mesh_engine_reads_the_host_perm_and_its_own_entries():
    """perm stays the global host vector and must agree with the static
    pairs: a wrong length or another matching raises before anything is
    posted; the state is the rank's one node."""
    mesh = _mesh(rank=1)
    scfg = SwarmConfig(n_nodes=N, H=1, gossip_impl="ppermute")
    opt = make_optimizer("sgd", lr=LR, momentum=0.0)
    step = make_swarm_step(
        scfg, lambda p, mb: torch.mean((mb["x"] @ p["w"]) ** 2), opt.update,
        lambda s: LR, transport=TE.GossipTransport(
            N, impl="ppermute", static_pairs=PAIRS, mesh=mesh))
    state = swarm_init(torch.Generator().manual_seed(0), scfg,
                       lambda g: {"w": torch.randn(3, generator=g)},
                       opt.init, mesh=mesh)
    assert state.params["w"].shape == (1, 3)
    batch = {"x": torch.ones(1, 1, 2, 3)}
    h = np.ones(N, np.int32)
    for perm in (np.array([1, 0, 3, 2]), PERM[:2]):
        with pytest.raises(ValueError, match="perm"):
            step(state, batch, perm, h, None)


def test_gamma_on_a_mesh_is_the_global_one(monkeypatch):
    """Γ on a mesh: one all-reduce of the packed buffer's sum, one scalar
    all-reduce of the distances (stood in for here by the sums over four
    rank trees) gives the one-shard Γ."""
    rng = np.random.default_rng(0)
    tree = {"a": _t(rng.normal(size=(N, 5, 3)).astype(np.float32)),
            "b": _t(rng.normal(size=(N, 7)).astype(np.float32))}
    calls = []
    rank_bufs = [TB.pack(TB.build_layout(_rows(tree, r)), _rows(tree, r))[0]
                 for r in range(N)]
    total = torch.stack(rank_bufs).sum(0)
    dists = [torch.sum(torch.square(b - total / N)) for b in rank_bufs]

    def all_reduce(x, group=None):
        calls.append(x.numel())
        x.copy_(total if x.numel() > 1 else sum(dists).reshape(1))
    monkeypatch.setattr(dist, "all_reduce", all_reduce)
    got = gamma_potential(_rows(tree, 0), mesh=_mesh())
    assert calls == [rank_bufs[0].numel(), 1]
    np.testing.assert_allclose(float(got), float(gamma_potential(tree)),
                               rtol=1e-6)


def test_fold_generator_is_per_rank_and_moves_the_run_on():
    runs = [torch.Generator().manual_seed(3) for _ in range(3)]
    a = torch.rand(8, generator=_mesh(0).fold_generator(runs[0]))
    b = torch.rand(8, generator=_mesh(1).fold_generator(runs[1]))
    a2 = torch.rand(8, generator=_mesh(0).fold_generator(runs[2]))
    assert torch.equal(a, a2) and not torch.equal(a, b)
    assert torch.equal(runs[0].get_state(), runs[1].get_state())
    assert not torch.equal(runs[0].get_state(),
                           torch.Generator().manual_seed(3).get_state())


def test_a_cuda_mesh_without_a_gpu_raises(monkeypatch):
    """No fallback: a mesh on cuda needs a GPU a rank and NCCL."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        init_node_mesh("cuda", rank=0, world_size=1,
                       init_method="tcp://localhost:1")
    with pytest.raises(ValueError, match="cuda .*or cpu"):
        init_node_mesh("meta", rank=0, world_size=1)
