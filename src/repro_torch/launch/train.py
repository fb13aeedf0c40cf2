"""Training driver for the port: SwarmSGD or any of the paper's baselines
on the synthetic LM stream, on the card by default.

  PYTHONPATH=src python -m repro_torch.launch.train --arch transformer-wmt \
      --nodes 8 --H 2 --h-mode geometric --h-max 8 --quantize \
      --nonblocking --overlap --non-iid 0.5 --eval-mean --steps 4 \
      --ckpt ckpts --ckpt-every 2
  PYTHONPATH=src python -m repro_torch.launch.train --nodes 8 \
      --algo dpsgd --graph ring
  PYTHONPATH=src python -m repro_torch.launch.train --nodes 8 --quantize \
      --rate-profile lognormal --rate-sigma 0.8 --straggler 0.25:8
  PYTHONPATH=src python -m repro_torch.launch.train --nodes 8 --quantize \
      --gossip-impl ppermute_pool --pool-size 8 --nonblocking --overlap

``--algo`` is swarm (the default), allreduce, localsgd, dpsgd, adpsgd or
sgp; every combination is checked against the capability matrix
(``repro_torch.algorithms``) before anything is built. ``--codec`` picks
the wire codec of ``--quantize`` (q2..q16, bf16, topk:<frac>; q8 when
unset), ``--compress-state`` keeps the blocking path's comm copy as the
codec's wire, and ``--scan-chunk K`` runs K supersteps per chunk, as
CUDA graphs on the card (``core/scan.py``): bitwise the per-step driver on
the CPU, and on the card when both runs use
``torch.use_deterministic_algorithms`` with one pinned
``CUBLAS_WORKSPACE_CONFIG`` (``chip_smoke.py`` sets both).
``--gossip-impl`` picks the transport, as the reference's: ``gather`` (the
default), ``ppermute`` (one static matching drawn from ``--seed``),
``ppermute_pool`` (a matching a superstep out of ``--pool-size``
precompiled ones) or the ``*_legacy`` per-leaf oracle of each; all nodes
live on the one card, so the ppermute transports permute locally.

``--rate-profile`` drives training from the discrete-event scheduler
(``repro_torch.sched``): per-node Poisson clocks (``uniform_async`` or
``lognormal`` rates, ``--straggler`` slow and failing nodes, ``--avail``
joins, leaves and day/night windows, ``--topology hier:G`` two link tiers)
generate an event trace, which is binned into masked supersteps, each
participant taking its accrued local steps; ``uniform`` is the
synchronous trace, the ``none`` run's matchings. The run prints the
trace's ``{"sched": ...}`` line first and the cost model's
``{"sched_cost": ...}`` (and, two-tier, ``{"link_util": ...}``) line
last, priced with the H100's datasheet figures.

prints one JSON record per logged superstep with the JAX driver's keys
(``step``, ``loss``, ``gamma``, ``wall_s``, and with ``--eval-mean`` the
mean-model losses; a join bin logs ``{"event": "join", ...}``) and writes
checkpoints in the JAX package's format, the scheduler's state in their
metadata. ``--device cpu`` runs the plain kernel versions on the CPU;
without it a machine with no GPU exits non-zero.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.algorithms import (
    ALGORITHMS, AlgoCaps, make_algorithm, validate_run_config,
)
from repro_torch.algorithms.sgp import sgp_debias, sgp_init_state
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config, reduced
from repro_torch.core.exchange import (
    GOSSIP_IMPLS, static_ppermute_matching, transport_from_config,
)
from repro_torch.core.graph import GRAPH_KINDS, make_graph, sample_matching
from repro_torch.core.hier import parse_topology
from repro_torch.core.scan import make_superstep_scan
from repro_torch.core.swarm import (
    SwarmConfig, SwarmState, codec_checkpoint_tree, make_join_step,
    make_mean_model_eval, pipeline_epilogue, retire_nodes, sample_h_counts,
    swarm_init,
)
from repro_torch.data import DataConfig, SyntheticLMDataset, make_node_batches
from repro_torch.models import TransformerLM, init_params, param_split
from repro_torch.optim import make_optimizer
from repro_torch import sched as S

RATE_PROFILES = ("none", "uniform", "uniform_async", "lognormal")


def parse_straggler(spec: Optional[str]) -> S.StragglerConfig:
    """--straggler FRAC:SLOWDOWN[:FAIL_RATE:FAIL_DURATION] -> StragglerConfig.
    e.g. "0.25:10" = slowest quarter of the nodes 10x slower;
    "0.25:10:0.01:5" additionally fails nodes at rate 0.01/unit-time for 5
    units (sched/clocks.py failure injection)."""
    if not spec:
        return S.StragglerConfig()
    parts = [float(x) for x in spec.split(":")]
    if len(parts) not in (2, 4):
        raise ValueError(f"--straggler {spec!r}: want FRAC:SLOWDOWN"
                         "[:FAIL_RATE:FAIL_DURATION]")
    kw = dict(fraction=parts[0], slowdown=parts[1])
    if len(parts) == 4:
        kw.update(fail_rate=parts[2], fail_duration=parts[3])
    return S.StragglerConfig(**kw)


def build_schedule(args, graph, scfg: SwarmConfig, caps=None):
    """--rate-profile plumbing: generate the event trace and compile it to
    a binned engine schedule, as the JAX driver does, draw for draw.
    Returns (schedule, trace, clocks) — clocks is None for the synchronous
    uniform profile, whose trace reproduces the plain driver's matchings
    (and therefore its trajectory) bit-exactly on a complete graph with
    even n. `caps` (the algorithm's capability row) drops the trace's
    local-step accrual to H=1 for the algorithms that interact every step
    (adpsgd/sgp/dpsgd/allreduce). With ``--avail`` the clocks carry an
    AvailabilityModel and the schedule gains join/leave bins. Under
    ``--topology hier:G`` the clocks run on the two-tier union graph with
    edge weights tuned so inter-group events land at ``inter_frac``; the
    per-event tier labels ride trace.meta and split the bins tier-pure so
    each bin prices on ONE link class."""
    topo = parse_topology(getattr(args, "topology", None), scfg.n_nodes)
    tseed = args.trace_seed if args.trace_seed is not None else args.seed
    H_eff = args.H if caps is None or caps.local_H else 1
    if scfg.gossip_impl not in ("gather", "gather_legacy"):
        raise ValueError(
            "--rate-profile drives the engine through arbitrary per-bin "
            "matchings, which only the gather transports accept from the "
            "driver; the ppermute/pool transports run heterogeneous traces "
            "via sched.bridge (pool_edges/static pairs restriction)")
    avail = None
    if getattr(args, "avail", None):
        if args.rate_profile in ("none", "uniform"):
            raise ValueError(
                "--avail rides the asynchronous Poisson clocks "
                "(join/leave events are quantized to clock rings) — use "
                "--rate-profile uniform_async or lognormal")
        avail = S.parse_avail(args.avail, args.nodes, tseed)
    if args.rate_profile == "uniform":
        if topo is not None and topo.n_groups > 1:
            raise ValueError(
                "--topology hier needs an asynchronous --rate-profile "
                "(uniform_async or lognormal): the synchronous uniform "
                "trace has no per-event tier coin, so inter-group "
                "exchanges would never fire")
        if graph.name != "complete" or graph.n % 2:
            # bit-exactness with the unscheduled driver needs every
            # sampled matching to be PERFECT (unmatched nodes still run
            # H local steps in the plain engine but accrue none in the
            # event model) — only complete graphs with even n guarantee
            # that. The schedule itself is still valid.
            print(json.dumps({"sched_warning":
                              "uniform profile is bit-exact with "
                              "--rate-profile none only on a complete "
                              f"graph with even n (got {graph.name}, "
                              f"n={graph.n})"}), flush=True)
        rng = np.random.default_rng(tseed)
        trace = S.synchronous_trace(graph, args.steps, H=H_eff, rng=rng)
        # the matching stream's rng, so a resumed run continues the SAME
        # matching sequence (sched_checkpoint_meta)
        trace.meta["matching_rng"] = rng.bit_generator.state
        clocks = None
    else:
        kind = "uniform" if args.rate_profile == "uniform_async" \
            else args.rate_profile
        profile = S.RateProfile(kind, sigma=args.rate_sigma)
        straggler = parse_straggler(args.straggler)
        event_graph, ew = graph, None
        if topo is not None and topo.n_groups > 1:
            # two-tier clocks: the union graph carries both edge classes,
            # weighted so P(inter event) ≈ inter_frac (core/hier.py)
            event_graph, ew = topo.union_graph(), topo.edge_weights()
        clocks = S.PoissonClocks(event_graph,
                                 profile.make_rates(args.nodes, tseed),
                                 tseed, straggler, edge_weights=ew,
                                 avail=avail)
        n_events = args.steps * max(1, args.nodes // 2)
        trace = S.generate_trace(event_graph, profile, n_events, H=H_eff,
                                 h_max=scfg.h_max if H_eff > 1 else 1,
                                 h_mode="rate", seed=tseed, clocks=clocks)
    tiers = None
    if topo is not None and topo.n_groups > 1:
        tiers = topo.tier_of_pairs(trace.pairs)
        trace.meta["tiers"] = tiers
    return S.bin_trace(trace, tiers=tiers), trace, clocks


def sched_checkpoint_meta(args, trace, clocks) -> dict:
    """JSON-serializable scheduler state for checkpoint metadata, in the
    JAX driver's format: restoring `clocks` via PoissonClocks.from_state +
    `last_t` into generate_trace continues the exact event sequence, in
    either package."""
    avail = clocks.avail if clocks is not None else None
    return {
        "profile": args.rate_profile,
        "rate_sigma": args.rate_sigma,
        "trace_seed": args.trace_seed if args.trace_seed is not None
        else args.seed,
        "straggler": args.straggler,
        "n_nodes": args.nodes,
        "n_events_done": int(trace.n_events),
        "clocks": clocks.state_dict() if clocks is not None else None,
        "last_t": trace.meta.get("last_t"),
        "matching_rng": trace.meta.get("matching_rng"),
        # the availability model embeds its own intervals/phases, so a
        # resume needs neither the spec nor the original trace file
        "avail": avail.state_dict() if avail is not None else None,
    }


def restore_sched_clocks(meta: dict, graph):
    """Inverse of `sched_checkpoint_meta` (either driver's): rebuild the
    event source so a continued run generates the SAME sequence the
    uninterrupted run would have. Returns (clocks, last_t, matching_rng):
    asynchronous profiles get (PoissonClocks, last_t, None) — feed both to
    `generate_trace(..., clocks=..., last_t=...)`; the synchronous uniform
    profile gets (None, None, rng) — feed the rng to
    `synchronous_trace(..., rng=...)`."""
    if meta.get("clocks") is None:
        rng = None
        if meta.get("matching_rng") is not None:
            rng = np.random.default_rng(int(meta["trace_seed"]))
            rng.bit_generator.state = meta["matching_rng"]
        return None, None, rng
    kind = "uniform" if meta["profile"] == "uniform_async" \
        else meta["profile"]
    profile = S.RateProfile(kind, sigma=meta.get("rate_sigma", 0.5))
    seed = int(meta["trace_seed"])
    rates = profile.make_rates(int(meta["n_nodes"]), seed)
    avail = S.AvailabilityModel.from_state(meta["avail"]) \
        if meta.get("avail") is not None else None
    clocks = S.PoissonClocks.from_state(
        meta["clocks"], graph, rates, seed,
        straggler=parse_straggler(meta.get("straggler")), avail=avail)
    last_t = np.asarray(meta["last_t"]) if meta.get("last_t") is not None \
        else None
    return clocks, last_t, None


def sample_gossip_perm(scfg: SwarmConfig, graph, rng_np, seed: int = 0,
                       topo=None) -> np.ndarray:
    """Per-superstep `perm` input, as the JAX driver draws it: a fresh
    matching for the gather transports, the pool index broadcast to
    [n_nodes] for ppermute_pool, or for the plain ppermute transports the
    one static matching of `seed` (the transport's, ``transport_from_config``
    with the same seed), drawing nothing. A `topo` (``core/hier.py``
    HierTopology) draws through the tier coin (`sample_event` /
    `sample_pool_index`), bitwise the flat draw for one group; the static
    ppermute matching cannot carry two tiers and raises."""
    impl = scfg.gossip_impl
    if topo is not None:
        if impl.startswith("ppermute_pool"):
            idx, _tier = topo.sample_pool_index(rng_np, scfg.pool_size)
            return np.full((scfg.n_nodes,), idx, np.int32)
        if impl.startswith("ppermute"):
            raise ValueError(
                "hier topology cannot ride the single static ppermute "
                "matching (one compiled matching carries one tier) — use "
                "gather or ppermute_pool")
        perm, _tier = topo.sample_event(rng_np)
        return perm
    if impl.startswith("ppermute_pool"):
        idx = int(rng_np.integers(scfg.pool_size))
        return np.full((scfg.n_nodes,), idx, np.int32)
    if impl.startswith("ppermute"):
        return static_ppermute_matching(graph, seed)
    return sample_matching(graph, rng_np)


def presample_inputs(scfg: SwarmConfig, graph, rng_np, n_steps: int,
                     uses_matching: bool = True, topo=None, seed: int = 0):
    """The whole run's (perm, h) streams as [n_steps, n_nodes] int32,
    drawn from `rng_np` in the JAX driver's order (perm, then h, step by
    step), so a seed gives the JAX driver's matchings and counts (`seed`
    names the ppermute transport's static matching). An algorithm that
    ignores the matching still draws one each step, as the reference
    does, so its h stream is the reference's too."""
    perms = np.empty((n_steps, scfg.n_nodes), np.int32)
    hs = np.empty((n_steps, scfg.n_nodes), np.int32)
    for t in range(n_steps):
        perms[t] = (sample_gossip_perm(scfg, graph, rng_np, seed, topo)
                    if uses_matching else sample_matching(graph, rng_np))
        hs[t] = sample_h_counts(scfg, rng_np)
    return perms, hs


def sched_cost(args, cfg, caps, graph, schedule, trace) -> dict:
    """The cost model's price of the run's trace on the H100 (datasheet
    figures, ``repro_torch/hardware.py``): pairwise algorithms replay per
    event in every mode (`predict_all_modes`), bulk-synchronous ones pay
    a global rendezvous + collective per bin (`predict_bsp_walltime`)."""
    cp = S.cost_params_from_model(cfg, seq_len=args.seq,
                                  local_batch=args.batch,
                                  quantize=args.quantize, codec=args.codec,
                                  topology=args.topology)
    if caps.pricing == "pairwise":
        return S.predict_all_modes(trace, cp, tiers=trace.meta.get("tiers"))
    return S.predict_bsp_walltime(
        trace, schedule, cp,
        payload_factor=S.bsp_payload_factor(args.algo, graph))


def use_expandable_segments() -> None:
    """Turn on the caching allocator's expandable segments unless the
    caller chose an allocator setting: with fixed segments the 8-node
    overlapped commands fragment past the card (on one H100 80GB, the
    overlapped scheduled command alone stopped with 55.12 GiB allocated
    and 19.71 GiB reserved but free). Takes effect only before the first
    CUDA allocation of the process, so the entry points call it first."""
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")


def resolve_device(name: str, prog: str = "repro_torch.launch.train"
                   ) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{prog}: no CUDA device is available; pass "
                         "--device cpu to run the plain kernel versions on "
                         "the CPU")
    if dev.type == "cuda":
        # D-PSGD's mixing product is fp32, as the reference's: never TF32
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", default="transformer-wmt")
    ap.add_argument("--algo", default="swarm", choices=sorted(ALGORITHMS))
    ap.add_argument("--graph", default="complete", choices=GRAPH_KINDS,
                    help="interaction graph of the matchings (and of "
                         "D-PSGD's mixing)")
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--H", type=int, default=2)
    ap.add_argument("--h-mode", default="fixed",
                    choices=["fixed", "geometric"])
    ap.add_argument("--h-max", type=int, default=8,
                    help="local-step loop bound of the variable h modes "
                         "(geometric sampling, scheduler traces)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4,
                    help="per node per local step")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--quantize", action="store_true",
                    help="codec-compressed gossip (the q8 lattice, "
                         "quantize_mod + decode_avg, unless --codec)")
    ap.add_argument("--codec", default=None,
                    help="wire codec of --quantize: q2..q16 (lattice), "
                         "bf16 (cast) or topk:<frac> (top-k with error "
                         "feedback); default q8")
    ap.add_argument("--compress-state", action="store_true",
                    help="keep the comm copy as the codec's wire, encoded "
                         "against zeros (blocking --quantize with a "
                         "lattice codec)")
    ap.add_argument("--nonblocking", action="store_true",
                    help="Algorithm 2: average the superstep-start models")
    ap.add_argument("--overlap", action="store_true",
                    help="pipelined non-blocking superstep: the in-flight "
                         "payload's permute runs under the local steps "
                         "(implies --nonblocking)")
    ap.add_argument("--gossip-impl", default=None, choices=GOSSIP_IMPLS,
                    help="gossip transport: gather (default; the sampled "
                         "matching), ppermute (one static matching), "
                         "ppermute_pool (a matching a superstep out of "
                         "--pool-size precompiled ones), each on the flat "
                         "buffer, or its *_legacy per-leaf oracle")
    ap.add_argument("--pool-size", type=int, default=8,
                    help="K precompiled matchings of ppermute_pool")
    ap.add_argument("--rate-profile", default="none",
                    choices=RATE_PROFILES,
                    help="drive training from a discrete-event scheduler "
                         "trace: per-node Poisson clocks at uniform_async "
                         "or lognormal rates binned into masked "
                         "supersteps; 'uniform' is the synchronous trace "
                         "(bitwise 'none' on a complete graph with even n)")
    ap.add_argument("--rate-sigma", type=float, default=0.5,
                    help="lognormal rate-profile shape")
    ap.add_argument("--straggler", default=None,
                    help="FRAC:SLOWDOWN[:FAIL_RATE:FAIL_DURATION] straggler "
                         "and transient-failure injection, e.g. 0.25:10")
    ap.add_argument("--trace-seed", type=int, default=None,
                    help="scheduler clock seed (default: --seed)")
    ap.add_argument("--avail", default=None,
                    help="elastic membership: 'day_night:period=P,duty=D"
                         "[,join=F:T0:T1][,leave=F:T0:T1][,seed=S]' or "
                         "'trace:FILE' (node t_start t_end rows); needs an "
                         "asynchronous --rate-profile")
    ap.add_argument("--topology", default=None,
                    help="'hier:G[:inter_frac]': groups of G nodes, an "
                         "inter_frac (default 0.25) share of events "
                         "crossing groups on the slow link tier; 'flat' or "
                         "unset = one tier. 'hier:G' with G = nodes is "
                         "bitwise the flat path")
    ap.add_argument("--non-iid", type=float, default=None,
                    help="Dirichlet alpha for per-node data skew")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale variant of the arch")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--scan-chunk", type=int, default=0,
                    help="K supersteps per chunk, replayed as CUDA graphs "
                         "on the card (core/scan.py); bitwise the per-step "
                         "driver on the CPU, and on the card under "
                         "torch.use_deterministic_algorithms with a pinned "
                         "CUBLAS_WORKSPACE_CONFIG; chunk boundaries are the "
                         "checkpointable points. 0 = per-step driver")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--eval-mean", action="store_true",
                    help="also evaluate the true average model μ (paper §5)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint every N steps into --ckpt (a directory "
                         "of step_NNNNNN checkpoints); 0 = one final "
                         "checkpoint at --ckpt")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="json metrics path")
    return ap


@dataclass
class Trainer:
    """Everything a run needs, built from the parsed flags."""
    args: argparse.Namespace
    device: torch.device
    cfg: object               # model config
    caps: AlgoCaps            # the algorithm's capability row
    scfg: SwarmConfig
    step: Callable            # the superstep (algorithms registry)
    state: SwarmState
    ds: SyntheticLMDataset
    perms: np.ndarray         # [steps, nodes] matchings
    hs: np.ndarray            # [steps, nodes] local-step counts
    enc_gen: torch.Generator  # uniforms of the q8 encode
    evaluate: Optional[Callable] = None   # --eval-mean
    graph: object = None      # the interaction graph
    # --rate-profile: the bins' participation masks [steps, nodes], the
    # binned schedule, its trace and clocks (None for the uniform profile)
    masks: Optional[np.ndarray] = None
    schedule: Optional[S.BinnedSchedule] = None
    trace: Optional[S.Trace] = None
    clocks: Optional[S.PoissonClocks] = None
    join: Optional[Callable] = None       # --avail: the join bootstrap
    chunker: Optional[Callable] = None    # --scan-chunk: the chunk driver
    mesh: object = None       # a node mesh (launch/mesh.py): this rank's node
    # a mesh with a model axis: the parameters' split (param_split)
    param_specs: object = None

    @property
    def h_max(self) -> int:
        return self.scfg.h_loop_bound

    @property
    def n_steps(self) -> int:
        """Supersteps of the run: --steps, or the schedule's bins."""
        return len(self.perms)

    @property
    def churn(self) -> bool:
        return self.schedule is not None and self.schedule.kinds is not None

    def is_join(self, t: int) -> bool:
        return self.churn and self.schedule.kinds[t] == S.EVENT_JOIN

    def retire(self, t: int) -> None:
        """Retire the nodes whose permanent leave takes effect before bin
        t (t = n_steps: after the last bin)."""
        if self.churn and self.schedule.retire[t].any():
            self.state = retire_nodes(self.state, self.schedule.retire[t],
                                      mesh=self.mesh)

    def join_bin(self, t: int) -> dict:
        """Run the exclusive join bin t: the joiner bootstraps from its
        donor's packed model (no batch, no encode); -> its record."""
        self.state = self.join(self.state, self.perms[t], self.masks[t])
        joiner = int(np.nonzero(self.masks[t])[0][0])
        return {"step": t, "event": "join", "joiner": joiner,
                "donor": int(self.perms[t][joiner])}

    def node_batches(self, t: int) -> dict:
        """Superstep t's batch as numpy [nodes, h_max * batch, seq]."""
        return make_node_batches(self.ds, t, self.args.batch * self.h_max)

    def node_rows(self, v: np.ndarray) -> np.ndarray:
        """A numpy batch of every node -> [nodes, h_max, batch, seq], or on
        a node mesh the rank's row, [1, h_max, batch, seq]."""
        a = self.args
        v = v.reshape(a.nodes, self.h_max, a.batch, a.seq)
        return v if self.mesh is None else \
            v[self.mesh.rank:self.mesh.rank + 1]

    def batch(self, t: int, nb: Optional[dict] = None) -> dict:
        """Superstep t's batch on the device: [nodes, h_max, batch, seq]
        (a node mesh: the rank's row)."""
        nb = self.node_batches(t) if nb is None else nb
        return {k: torch.from_numpy(self.node_rows(v)).to(self.device)
                for k, v in nb.items()}

    def superstep(self, t: int, nb: Optional[dict] = None) -> dict:
        mask = None if self.masks is None else self.masks[t]
        self.state, m = self.step(self.state, self.batch(t, nb),
                                  self.perms[t], self.hs[t], self.enc_gen,
                                  mask)
        return m

    def chunk(self, t: int, n: int, nbs: list) -> dict:
        """Supersteps t .. t+n-1 as one chunk (``core/scan.py``) from their
        numpy batches `nbs`; -> the metrics, numpy [n] each (read once)."""
        if self.chunker is None:
            self.chunker = make_superstep_scan(
                self.step, with_mask=self.masks is not None)
        batch = {k: torch.from_numpy(np.stack(
            [self.node_rows(nb[k]) for nb in nbs])).to(self.device)
            for k in nbs[0]}
        masks = None if self.masks is None else self.masks[t:t + n]
        self.state, ms = self.chunker(self.state, self.enc_gen, batch,
                                      self.perms[t:t + n], self.hs[t:t + n],
                                      masks)
        return {k: v.cpu().numpy() for k, v in ms.items()}

    def eval_mean(self, nb: dict) -> dict:
        """The mean-model losses on node 0's batch of the step, as the JAX
        driver evaluates them."""
        seq = self.args.seq
        # at a chunk boundary the graphs' pool holds their temporaries'
        # free blocks: the evaluation allocates there, and frees it all
        # before the next replay
        borrow = self.chunker.borrow_pool() if self.chunker is not None \
            else contextlib.nullcontext()
        with borrow:
            eb = {k: torch.from_numpy(nb[k][0].reshape(-1, seq))
                  .to(self.device) for k in ("tokens", "targets")}
            params = self.state.params
            if self.args.algo == "sgp":
                # the push-sum payload evaluates at the de-biased X / w
                params = sgp_debias(params)
            out = {k: float(v) for k, v in self.evaluate(params, eb).items()}
            del eb, params
        return out

    def write_ckpt(self, path: str, step_no: int) -> None:
        """One checkpoint-writing path for final and periodic saves, with
        the JAX driver's metadata. A quantized run saves its codec state
        beside the params; an overlapped one drains it first through
        `pipeline_epilogue` on a copy, the training state flowing on."""
        a = self.args
        meta = {"arch": self.cfg.name, "algo": a.algo, "steps": a.steps,
                "nodes": a.nodes, "step": step_no}
        if self.schedule is not None:
            meta["sched"] = sched_checkpoint_meta(a, self.trace, self.clocks)
        ck_state = self.state
        if a.quantize:
            if self.scfg.overlap:
                ck_state = pipeline_epilogue(self.scfg, ck_state)
            tree = codec_checkpoint_tree(ck_state)
            # compress_state changes the saved prev's shape (the wire
            # tuple), so a reader needs the flag to build its template
            meta["codec"] = {"spec": a.codec or "q8", "state": sorted(tree),
                             "compress_state": bool(self.scfg.compress_state)}
            save_checkpoint(path, tree, meta, mesh=self.mesh,
                            split=None if self.param_specs is None else
                            {k: self.param_specs for k in tree})
        else:
            save_checkpoint(path, ck_state.params, meta, mesh=self.mesh,
                            split=self.param_specs)


def build(args, cfg=None, mesh=None, graph=None) -> Trainer:
    """The trainer the flags describe; `cfg`, when given, is the model
    config in place of the one --arch / --reduced name, and `graph` the
    interaction graph in place of --graph's. One construction
    path for every algorithm: the capability matrix validates the flags,
    one transport is built, and the step comes from `make_algorithm`.
    Under --rate-profile the run's (perm, h, mask) rows are the binned
    schedule's, and the trace's ``{"sched": ...}`` line is printed. On a
    node `mesh` (``launch/mesh.py``, library only: --nodes its size, each
    rank calls this with the same flags) the transport, step, state, join,
    retirement, mean-model evaluation and checkpoints are the mesh's, and
    each rank holds and feeds its own node. On a mesh with a model axis
    (``init_node_mesh(..., model_parallel=K)``) each rank holds its slices
    of its node (``models/transformer.py`` ``param_split``), drawn as the
    whole model's slices, and takes its node's batch; what that axis does
    not carry yet raises before anything is built."""
    caps = validate_run_config(args.algo, gossip_impl=args.gossip_impl,
                               quantize=args.quantize,
                               nonblocking=args.nonblocking,
                               overlap=args.overlap,
                               rate_profile=args.rate_profile,
                               codec=args.codec, avail=args.avail,
                               topology=args.topology,
                               compress_state=args.compress_state,
                               n_nodes=args.nodes, mesh=mesh,
                               scan_chunk=args.scan_chunk)
    device = resolve_device(args.device)
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = reduced(cfg, n_layers=args.layers, d_model=args.d_model)
    tp = None if mesh is None else mesh.model_shard
    specs = None if tp is None else param_split(cfg, tp.size)
    ds = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=args.seq, seed=args.seed,
                                       non_iid_alpha=args.non_iid),
                            n_nodes=args.nodes)
    graph = graph or make_graph(args.graph, args.nodes)
    opt = make_optimizer("sgd", lr=args.lr, momentum=0.9,
                         state_dtype=cfg.opt_state_dtype)
    sched_on = args.rate_profile != "none"
    # algorithms that interact every step take exactly one batch slot; the
    # h-consuming ones (swarm, localsgd) keep the variable h modes, and
    # under an asynchronous trace take the bridge's per-node counts
    H, h_mode = (args.H, args.h_mode) if caps.local_H else (1, "fixed")
    if sched_on and args.rate_profile != "uniform" and caps.local_H:
        h_mode = "trace"
    scfg = SwarmConfig(n_nodes=args.nodes, H=H, h_mode=h_mode,
                       h_max=args.h_max,
                       nonblocking=args.nonblocking or args.overlap,
                       overlap=args.overlap, quantize=args.quantize,
                       codec=args.codec,
                       compress_state=args.compress_state,
                       gossip_impl=args.gossip_impl or "gather",
                       pool_size=args.pool_size, topology=args.topology)
    model = TransformerLM(cfg, tp=tp)
    kw = dict(loss_fn=model.functional_loss, opt_update=opt.update,
              lr_fn=lambda s: args.lr, n_nodes=args.nodes,
              transport=transport_from_config(scfg, graph, args.seed,
                                              mesh=mesh), mesh=mesh)
    if args.algo == "swarm":
        kw["scfg"] = scfg
        if specs is not None:
            kw["param_specs"] = specs
    else:
        if args.algo == "localsgd":
            kw.update(H=args.H, h_max=scfg.h_loop_bound)
        if args.algo == "dpsgd":
            kw["graph"] = graph
        if caps.quantized:
            kw["quantize"] = args.quantize
        if "nonblocking" in caps.modes:
            kw["nonblocking"] = args.nonblocking
    step = make_algorithm(args.algo, **kw)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    state = swarm_init(gen, scfg,
                       lambda g: init_params(g, cfg, device, tp=tp),
                       opt.init, mesh=mesh)
    if args.algo == "sgp":
        state = sgp_init_state(state, args.nodes, args.quantize, mesh=mesh)
    enc_gen = torch.Generator(device=device)
    enc_gen.manual_seed(args.seed + 1)
    sched = {}
    if sched_on:
        schedule, trace, clocks = build_schedule(args, graph, scfg, caps)
        # the schedule's rows, shipped as they are: a join bin's row is
        # the bootstrap's (perm, mask), every other row a masked superstep
        perms, hs, masks = schedule.perms, schedule.h, schedule.mask
        sched = dict(masks=masks, schedule=schedule, trace=trace,
                     clocks=clocks)
        if schedule.kinds is not None:
            sched["join"] = make_join_step(scfg, mesh=mesh)
        print(json.dumps({"sched": {
            "profile": args.rate_profile, "n_events": trace.n_events,
            "n_supersteps": schedule.n_supersteps,
            "density": schedule.density(),
            **{k: v for k, v in S.trace_stats(trace).items()
               if not isinstance(v, list)}}}), flush=True)
    else:
        perms, hs = presample_inputs(
            scfg, graph, np.random.default_rng(args.seed), args.steps,
            caps.uses_matching, topo=parse_topology(args.topology,
                                                    args.nodes),
            seed=args.seed)
    evaluate = make_mean_model_eval(model.functional_loss, mesh=mesh) \
        if args.eval_mean else None
    return Trainer(args, device, cfg, caps, scfg, step, state, ds, perms, hs,
                   enc_gen, evaluate, graph, mesh=mesh, param_specs=specs,
                   **sched)


def check_args(ap: argparse.ArgumentParser, args) -> None:
    """The JAX driver's command-line refusals of flag combinations."""
    if args.avail and args.rate_profile in ("none", "uniform"):
        ap.error("--avail rides the asynchronous Poisson clocks; use "
                 "--rate-profile uniform_async or lognormal")
    if args.avail and args.scan_chunk:
        ap.error("--avail schedules contain join bins, which branch per "
                 "superstep (join-bootstrap vs gossip) — the fused scan "
                 "driver replays gossip bins only; drop --scan-chunk "
                 "(DESIGN.md §Churn)")
    if args.scan_chunk < 0:
        ap.error("--scan-chunk takes K >= 0 (0 = per-step driver)")


def run(args, tr: Optional[Trainer] = None) -> list:
    """Train as `args` says (with the trainer `tr` when given, else the
    one `build` makes); -> the logged records. Under a churn schedule a
    leave retires its node before the bin it precedes (or after the last)
    and a join bin runs the bootstrap in place of a superstep."""
    tr = tr or build(args)
    history = []
    n_steps = tr.n_steps

    written = None

    def periodic_ckpt(step_no):
        nonlocal written
        os.makedirs(args.ckpt, exist_ok=True)
        tr.write_ckpt(os.path.join(args.ckpt, f"step_{step_no:06d}"),
                      step_no)
        written = step_no

    def log(rec):
        history.append(rec)
        print(json.dumps(rec), flush=True)

    t0 = time.time()
    if args.scan_chunk > 0:
        # K supersteps a chunk; the metrics are read once a chunk, the
        # mean model is evaluated and checkpoints land at chunk boundaries
        # (the checkpointable points), as in the reference's scan driver
        for t in range(0, n_steps, args.scan_chunk):
            k = min(args.scan_chunk, n_steps - t)
            nbs = [tr.node_batches(s) for s in range(t, t + k)]
            ms = tr.chunk(t, k, nbs)
            em = tr.eval_mean(nbs[-1]) if args.eval_mean else None
            for i in range(k):
                s = t + i
                boundary = em is not None and i == k - 1
                if s % args.log_every == 0 or s == n_steps - 1 or boundary:
                    rec = {"step": s, "loss": float(ms["loss"][i]),
                           "gamma": float(ms["gamma"][i])
                           if "gamma" in ms else 0.0,
                           "wall_s": time.time() - t0}
                    if boundary:
                        rec.update(em)
                    log(rec)
            if args.ckpt and args.ckpt_every and \
                    (t + k) // args.ckpt_every > t // args.ckpt_every:
                periodic_ckpt(t + k)
    else:
        for t in range(n_steps):
            tr.retire(t)
            if tr.is_join(t):
                rec = tr.join_bin(t)
                rec["wall_s"] = time.time() - t0
                log(rec)
                continue
            nb = tr.node_batches(t)
            m = tr.superstep(t, nb)
            if t % args.log_every == 0 or t == n_steps - 1:
                rec = {"step": t, "loss": float(m["loss"]),
                       "gamma": float(m.get("gamma", 0.0)),
                       "wall_s": time.time() - t0}
                if args.eval_mean:
                    rec.update(tr.eval_mean(nb))
                log(rec)
            if args.ckpt and args.ckpt_every and (t + 1) % args.ckpt_every == 0:
                periodic_ckpt(t + 1)
    tr.retire(n_steps)
    predicted = None
    if tr.schedule is not None:
        predicted = sched_cost(args, tr.cfg, tr.caps, tr.graph, tr.schedule,
                               tr.trace)
        print(json.dumps({"sched_cost": predicted}), flush=True)
        if tr.trace.meta.get("tiers") is not None \
                and isinstance(predicted.get("blocking"), dict):
            # per-tier link utilization at a glance (the full per-mode
            # breakdown is inside sched_cost["<mode>"]["tiers"])
            print(json.dumps({"link_util": {
                "topology": args.topology,
                **predicted["blocking"]["tiers"]}}), flush=True)
    if args.ckpt:
        if args.ckpt_every:
            path = os.path.join(args.ckpt, f"step_{n_steps:06d}")
            if written != n_steps:        # else the loop wrote it
                periodic_ckpt(n_steps)
        else:
            path = args.ckpt
            tr.write_ckpt(path, n_steps)
        print("checkpoint ->", path, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"args": vars(args), "history": history,
                       "hs": tr.hs.tolist(), "sched_cost": predicted}, f,
                      indent=1)
    return history


def main(argv=None) -> list:
    use_expandable_segments()
    ap = build_parser()
    args = ap.parse_args(argv)
    check_args(ap, args)
    return run(args)


if __name__ == "__main__":
    main(sys.argv[1:])
