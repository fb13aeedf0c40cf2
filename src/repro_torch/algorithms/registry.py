"""Algorithm registry and capability matrix (counterpart of
``repro/algorithms/registry.py``).

Every algorithm — SwarmSGD included — is built through
``make_algorithm(name, loss_fn=..., opt_update=..., lr_fn=...,
n_nodes=..., ...)`` and returns a superstep with the uniform signature
``step(state, batch, perm, h_counts, rng, mask=None, *, u=None)``.

:data:`CAPABILITIES` is the JAX package's matrix, row for row: which
(transport, execution mode, quantization, codec, scheduler) combination
each algorithm supports. `validate_run_config` raises wherever the
reference's raises; on one shard nowhere else. On a node mesh
(``launch/mesh.py``; ``make_algorithm(name, mesh=...)`` builds any
algorithm there, and ``--scan-chunk`` chunks it) it also refuses what
the mesh does not carry yet — more than one node a rank — naming its
ROADMAP.md item (``core/bucket.py`` NOT_ON_A_MESH).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

from repro_torch.algorithms import adpsgd, allreduce, dpsgd, localsgd, sgp
from repro_torch.core.bucket import NOT_ON_A_MESH
from repro_torch.core.swarm import check_model_axis_run
from repro_torch.quant.codecs import make_codec


@dataclass(frozen=True)
class AlgoCaps:
    """What one algorithm supports on the unified exchange layer (the
    field meanings are the reference's: transports — accepted base gossip
    impls; modes — blocking / nonblocking / overlap; quantized — codec
    gossip; codecs — accepted codec families; sched — runs under
    scheduler traces; uses_matching — consumes `perm` as a matching;
    local_H — takes H > 1 local steps; pricing — cost-model family;
    churn — elastic membership; hier — two-tier topologies)."""
    transports: Tuple[str, ...]
    modes: Tuple[str, ...]
    quantized: bool
    codecs: Tuple[str, ...]
    sched: bool
    uses_matching: bool
    local_H: bool
    pricing: str
    why: str
    churn: bool = False
    hier: bool = False


#: every lattice/cast family — the codecs with no cross-superstep state
_STATELESS_CODECS = ("q8", "q4", "q16", "bf16")

CAPABILITIES = {
    "swarm": AlgoCaps(
        ("gather", "ppermute", "ppermute_pool"),
        ("blocking", "nonblocking", "overlap"), True,
        _STATELESS_CODECS + ("topk",), True, True, True, "pairwise",
        "the paper's method: pairwise matchings, H local steps, all "
        "transports, modes and codecs (the superstep carries the "
        "error-feedback residual slot; top-k itself is gather-only and "
        "blocking/nonblocking-only — the residual neither threads "
        "through shard_map nor learns the matched mask in time under "
        "the overlap pipeline); elastic membership via the join-bootstrap "
        "step and residual retirement (gather transport, no overlap — "
        "join pairs are dynamic and an in-flight payload would predate "
        "membership)", churn=True, hier=True),
    "adpsgd": AlgoCaps(
        ("gather", "ppermute", "ppermute_pool"),
        ("blocking", "nonblocking"), True, _STATELESS_CODECS + ("topk",),
        True, True, False, "pairwise",
        "= SwarmSGD with H=1: same matchings, same pairwise average "
        "(stale variant = the original asynchronous AD-PSGD), same codec "
        "family incl. the error-feedback residual; no overlap pipeline "
        "(nothing to hide one grad step under)", hier=True),
    "sgp": AlgoCaps(
        ("gather",), ("blocking",), True, _STATELESS_CODECS,
        True, False, False, "pairwise",
        "directed time-varying one-peer graph: the cyclic-shift perm "
        "changes every step, so the static ppermute matchings cannot "
        "carry it; push-sum (X, w) rides the payload as an extra row "
        "group and composes with every stateless codec — but not top-k: "
        "the EF residual holds back mass between interactions, which "
        "breaks the (X, w) joint linear dynamics the de-biasing relies "
        "on"),
    "localsgd": AlgoCaps(
        ("gather",), ("blocking",), False, (), True, False, True, "bsp",
        "global resync (masked participants-mean under a schedule): a "
        "mean has no pairwise permute form and no receiver-side decode "
        "reference, so no codec applies"),
    "dpsgd": AlgoCaps(
        ("gather",), ("blocking",), False, (), True, False, False, "bsp",
        "dense doubly-stochastic W-mixing over the node axis (masked "
        "Metropolis under a schedule); not pairwise, not quantizable"),
    "allreduce": AlgoCaps(
        ("gather",), ("blocking",), False, (), True, False, False, "bsp",
        "global gradient mean applied everywhere (backup-workers drop "
        "straggler gradients under a schedule); fully synchronous upper "
        "bound"),
}


def _make_swarm(loss_fn, opt_update, lr_fn, n_nodes, H: int = 2, scfg=None,
                track_potential: bool = None, transport=None, mesh=None,
                param_specs=None, **swarm_kw):
    """Route 'swarm' through the baselines' factory signature: pass a full
    SwarmConfig via `scfg`, or let one be built from (n_nodes, H) plus any
    SwarmConfig field given as a keyword; `mesh` and `param_specs` pass
    through to `make_swarm_step`."""
    from repro_torch.core.swarm import SwarmConfig, make_swarm_step
    if scfg is None:
        if track_potential is not None:
            swarm_kw["track_potential"] = track_potential
        scfg = SwarmConfig(n_nodes=n_nodes, H=H, **swarm_kw)
    elif swarm_kw or track_potential is not None:
        extra = sorted(swarm_kw) + (["track_potential"]
                                    if track_potential is not None else [])
        raise TypeError(f"pass either scfg or SwarmConfig fields, not both: "
                        f"{extra}")
    return make_swarm_step(scfg, loss_fn, opt_update, lr_fn,
                           transport=transport, mesh=mesh,
                           param_specs=param_specs)


ALGORITHMS = {
    "swarm": _make_swarm,          # the paper's method (core/swarm.py)
    "allreduce": allreduce.make_step,
    "localsgd": localsgd.make_step,
    "dpsgd": dpsgd.make_step,
    "adpsgd": adpsgd.make_step,
    "sgp": sgp.make_step,
}


def make_algorithm(name: str, **kw) -> Callable:
    """The superstep of algorithm `name` from its factory's keywords; a
    `mesh` keyword (``launch/mesh.py``) builds it on that node mesh."""
    if name not in ALGORITHMS:
        raise ValueError(f"unknown algorithm {name!r}; known: "
                         f"{sorted(ALGORITHMS)}")
    mesh = kw.get("mesh")
    if mesh is not None and mesh.model_size > 1 and name != "swarm":
        check_model_axis_run(algo=name)
    return ALGORITHMS[name](**kw)


def validate_run_config(algo: str, *, gossip_impl: str = None,
                        quantize: bool = False, nonblocking: bool = False,
                        overlap: bool = False, rate_profile: str = "none",
                        codec: str = None, avail: str = None,
                        topology: str = None, compress_state: bool = False,
                        n_nodes: int = None, mesh=None,
                        scan_chunk: int = 0) -> AlgoCaps:
    """Config-time validation of a run against the capability matrix.

    Raises ValueError with the algorithm's matrix row where the reference
    does (``--gossip-impl``, ``--rate-profile``, ``--avail``,
    ``--topology``, ``--codec`` and ``--compress-state`` included). There
    is no environment default: None means gather, the q8 lattice, no
    topology, no availability profile. On a node `mesh` it also raises,
    naming the ROADMAP.md item, for `n_nodes` other than the mesh's size
    (ValueError: one node a rank); `--scan-chunk` (`scan_chunk`) runs
    there as on one shard. On a mesh with a model axis it raises for what
    that axis does not carry yet (``core/swarm.py``
    ``check_model_axis_run``, naming ROADMAP.md Queue A 15). Returns the
    AlgoCaps row otherwise."""
    if algo not in CAPABILITIES:
        raise ValueError(f"unknown algorithm {algo!r}; known: "
                         f"{sorted(CAPABILITIES)}")
    caps = CAPABILITIES[algo]

    def reject(what):
        raise ValueError(
            f"--algo {algo} does not support {what}: {algo} supports "
            f"transports={list(caps.transports)}, modes={list(caps.modes)}, "
            f"quantized={caps.quantized}, codecs={list(caps.codecs)}, "
            f"sched={caps.sched} ({caps.why})")

    gossip_impl = gossip_impl or "gather"
    base = gossip_impl[:-len("_legacy")] \
        if gossip_impl.endswith("_legacy") else gossip_impl
    if mesh is not None:
        if n_nodes is not None and n_nodes != mesh.size:
            raise ValueError(f"n_nodes={n_nodes} on a node mesh of "
                             f"{mesh.size} ranks: "
                             f"{NOT_ON_A_MESH['nodes_per_shard']}")
        if mesh.model_size > 1:
            check_model_axis_run(
                algo=algo, gossip_impl=gossip_impl, quantize=quantize,
                codec=codec, compress_state=compress_state,
                rate_profile=rate_profile,
                avail=avail, topology=topology, scan_chunk=scan_chunk)
    if base not in caps.transports:
        reject(f"--gossip-impl {gossip_impl}")
    mode = "overlap" if overlap else \
        ("nonblocking" if nonblocking else "blocking")
    if mode not in caps.modes:
        reject(f"the {mode} execution mode")
    if quantize and not caps.quantized:
        reject("--quantize (codec-compressed gossip)")
    if rate_profile not in (None, "none") and not caps.sched:
        reject(f"--rate-profile {rate_profile}")
    if avail is not None:
        if not caps.churn:
            reject(f"--avail {avail} (elastic membership)")
        if base != "gather":
            reject(f"--avail {avail} with --gossip-impl {gossip_impl} "
                   "(join pairs are dynamic — the static-matching "
                   "transports cannot carry them)")
        if overlap:
            reject(f"--avail {avail} with the overlap pipeline (an "
                   "in-flight payload packed before a join predates the "
                   "joiner's membership)")
    family = None
    if quantize:
        # the transport's own parser: a bogus spec raises with the grammar
        c = make_codec(codec)
        family, residual = c.family, c.carries_residual
        if family not in caps.codecs:
            reject(f"--codec {codec}")
        if residual:
            if base != "gather":
                reject(f"--codec {codec} with --gossip-impl {gossip_impl} "
                       "(error-feedback residuals run on the gather "
                       "transport)")
            if overlap:
                reject(f"--codec {codec} with the overlap pipeline")
    if n_nodes is not None:
        from repro_torch.core.hier import parse_topology
        parse_topology(topology, n_nodes)
    hier = topology is not None and \
        str(topology).strip() not in ("", "flat", "none")
    if hier:
        if n_nodes is None and not str(topology).startswith("hier:"):
            # grammar-only check when the caller has no node count
            raise ValueError(f"unknown topology spec {topology!r}")
        if not caps.hier:
            reject(f"--topology {topology} (two-tier hierarchical gossip)")
        if base == "ppermute":
            reject(f"--topology {topology} with --gossip-impl {gossip_impl} "
                   "(ONE static matching cannot carry both tiers — use "
                   "gather or ppermute_pool)")
        if avail is not None:
            reject(f"--topology {topology} with --avail (hier traces do "
                   "not carry join/leave events yet)")
    if compress_state:
        if algo != "swarm":
            reject("--compress-state (the wire-compressed comm copy lives "
                   "in SwarmState)")
        if not quantize:
            reject("--compress-state without --quantize")
        if family is not None and family not in ("q4", "q8", "q16"):
            reject(f"--compress-state with --codec {codec}")
        if nonblocking or overlap:
            reject("--compress-state outside the blocking path")
        if gossip_impl.endswith("_legacy"):
            reject(f"--compress-state with --gossip-impl {gossip_impl}")
        if avail is not None:
            reject("--compress-state with --avail")
    return caps
