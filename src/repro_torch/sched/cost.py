"""Wall-clock cost model: price an event trace end-to-end (counterpart of
``repro/sched/cost.py``).

The paper's headline systems claim is *wall-clock* speedup on a machine
with non-uniform node speeds. This module predicts that number for any
(algorithm, quantization, rate profile) configuration by pricing each
trace event:

* compute — seconds per local SGD step from the analytic model
  (``roofline/analytic.py``: FLOPs and HBM bytes for one node's one local
  step) against the H100's datasheet peaks (``repro_torch/hardware.py``),
  divided by the node's relative speed;
* communication — the bucketed transport's EXACT packed payload bytes
  (``BucketLayout.payload_num_bytes``, fp32 or the lattice codec's
  declared layout) over link bandwidth, plus a fixed per-message latency.
  Tier 0 (intra-group) is NVLink 4, tier 1 (inter-group) one NDR
  InfiniBand port.

Two predictions are reported:

* `predict_walltime` — a discrete-event replay over the actual trace: each
  node carries a ready-time; a blocking interaction rendezvouses both
  endpoints (`max`) then pays the exchange; a non-blocking one lets each
  endpoint continue after its own send (no rendezvous — Algorithm 2's
  point); overlap additionally hides the exchange under the next local
  steps, paying only what the compute cannot cover. This is the
  "simulated" wall-clock.
* `analytic_walltime` — a closed-form estimate from trace statistics only
  (total work / parallelism, plus the rendezvous penalty for blocking).

Given the same `CostParams`, every ``predict_*`` function here returns
the reference's dict exactly; only the defaults (the card) and the way
`cost_params_from_model` reads the parameter shapes (meta tensors, never
an allocated model) differ.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from repro_torch import hardware as HW
from repro_torch.sched.avail import EVENT_JOIN, EVENT_LEAVE
from repro_torch.sched.trace import Trace

# the card's datasheet peaks (NVIDIA H100 80GB HBM3, 700 W; hardware.py)
_DEFAULTS = {"peak_flops": HW.PEAK_FLOPS_BF16, "hbm_bw": HW.HBM_BW,
             "link_bw": HW.NVLINK_BW}


@dataclass(frozen=True)
class CostParams:
    """Per-event pricing inputs. Build via `cost_params_from_model` (the
    roofline/bucket bridge) or construct directly for what-if sweeps."""
    flops_per_step: float          # one node, one local SGD step
    hbm_bytes_per_step: float
    payload_bytes: int             # wire bytes per direction per interaction
    peak_flops: float = _DEFAULTS["peak_flops"]
    hbm_bw: float = _DEFAULTS["hbm_bw"]
    link_bw: float = _DEFAULTS["link_bw"]
    link_latency_s: float = 5e-6   # per-message fixed cost
    # bandwidth tiers: `link_bw` prices tier 0 (intra-group, NVLink);
    # inter-group events (tier 1 in a hier trace) price against the slower
    # `inter_link_bw` when set (InfiniBand) — like the paper's
    # supercomputer, where cross-node links are ~an order of magnitude
    # behind intra-node ones. None = single-tier (flat) pricing.
    inter_link_bw: Optional[float] = None
    inter_link_latency_s: Optional[float] = None
    meta: Dict = field(default_factory=dict)

    def step_time_s(self, speed: float = 1.0) -> float:
        """Roofline max(compute, memory) for one local step at `speed`×
        the reference node (speed < 1 = straggler)."""
        base = max(self.flops_per_step / self.peak_flops,
                   self.hbm_bytes_per_step / self.hbm_bw)
        return base / max(speed, 1e-12)

    def comm_time_s(self, tier: int = 0) -> float:
        """Seconds for one payload over the tier's link (0 = intra/fast,
        1 = inter/slow; tier 1 falls back to tier 0 when no inter tier is
        configured — flat pricing)."""
        if tier and self.inter_link_bw is not None:
            lat = self.link_latency_s if self.inter_link_latency_s is None \
                else self.inter_link_latency_s
            return lat + self.payload_bytes / self.inter_link_bw
        return self.link_latency_s + self.payload_bytes / self.link_bw


def model_layout(cfg, block: int = 256, n_nodes: int = 1):
    """The flat-buffer layout of `n_nodes` stacked copies of `cfg`'s
    parameters, built from meta tensors of the parameter template: shapes
    only, nothing is allocated."""
    import torch

    from repro_torch.core import bucket as B
    from repro_torch.models import param_template
    from repro_torch.tree import tree_map
    dtype = getattr(torch, cfg.dtype)
    meta = tree_map(lambda i: torch.empty((n_nodes,) + tuple(i.shape),
                                          dtype=dtype, device="meta"),
                    param_template(cfg))
    return B.build_layout(meta, block=block)


def cost_params_from_model(cfg, *, seq_len: int, local_batch: int,
                           quantize: bool = False, quant=None,
                           codec=None, link_latency_s: float = 5e-6,
                           link_bw: Optional[float] = None,
                           topology=None,
                           inter_link_bw: Optional[float] = None,
                           inter_link_latency_s: Optional[float] = None
                           ) -> CostParams:
    """Price one node's local step + one gossip payload for a model config.

    FLOPs/bytes come from the analytic model evaluated for ONE node's ONE
    local step (`train_flops` / `train_bytes_full` are global
    per-superstep: all nodes × H — divide back out); payload bytes come
    from the bucket layout of the parameter shapes (`model_layout`: meta
    tensors, no model is allocated) priced through the wire codec's
    declared layout — exactly what ``core/bucket.py`` would ship (`codec`
    is a ``--codec`` spec string or a WireCodec; None follows `quant` =
    the q8 lattice).

    `topology` (a ``--topology`` spec string or HierTopology, or None)
    switches on two-tier pricing: intra-group payloads ride `link_bw`
    (NVLink) and inter-group ones `inter_link_bw` (default: one NDR
    InfiniBand port), matching how the trace's tier labels are priced
    downstream.
    """
    from repro_torch.configs.base import InputShape
    from repro_torch.quant.codecs import WireCodec, make_codec
    from repro_torch.quant.schemes import ModularQuantConfig
    from repro_torch.roofline.analytic import train_bytes_full, train_flops

    qcfg = quant or ModularQuantConfig()
    wire = codec if isinstance(codec, WireCodec) else make_codec(codec, qcfg)
    # one node, one local step == a "superstep" of 1 node × H=1
    shape = InputShape("sched_step", seq_len=seq_len,
                       global_batch=local_batch, kind="train")
    flops = train_flops(cfg, shape, H=1)
    hbm = train_bytes_full(cfg, shape, n_nodes=1, H=1)
    layout = model_layout(cfg, wire.block)
    payload = layout.payload_num_bytes(wire if quantize else None)
    topo_spec = getattr(topology, "spec", topology)
    hier = topo_spec is not None and str(topo_spec) not in ("", "flat",
                                                            "none")
    if hier and inter_link_bw is None:
        inter_link_bw = HW.IB_NDR_BW
    return CostParams(
        flops_per_step=flops, hbm_bytes_per_step=hbm, payload_bytes=payload,
        peak_flops=HW.PEAK_FLOPS_BF16, hbm_bw=HW.HBM_BW,
        link_bw=link_bw or HW.NVLINK_BW, link_latency_s=link_latency_s,
        inter_link_bw=inter_link_bw if hier else None,
        inter_link_latency_s=inter_link_latency_s if hier else None,
        meta={"arch": getattr(cfg, "name", "?"), "seq_len": seq_len,
              "local_batch": local_batch, "quantize": quantize,
              "codec": wire.name if quantize else "fp32",
              "n_padded": layout.n_padded,
              **({"topology": str(topo_spec)} if hier else {})})


def predict_walltime(trace: Trace, cost: CostParams, *,
                     mode: str = "blocking",
                     speeds: Optional[np.ndarray] = None,
                     tiers: Optional[np.ndarray] = None) -> Dict:
    """Discrete-event replay of the trace under the cost model.

    mode: blocking (Algorithm 1 — rendezvous + exchange on the critical
    path), nonblocking (Algorithm 2 — no rendezvous, each endpoint pays
    only its own exchange), overlap (non-blocking with the exchange hidden
    under the local steps — pays only the uncovered remainder).
    `speeds` defaults to the trace's clock rates: a node that rings slowly
    computes slowly (the straggler model of trace.py).

    `tiers` ([n_events] int, 0 intra / 1 inter — `HierTopology
    .tier_of_pairs(trace.pairs)`) prices each event against its tier's
    link (`CostParams.comm_time_s(tier)`); None prices everything on the
    fast tier, bitwise the pre-hier behavior. The result then carries a
    per-tier link-utilization breakdown under ``"tiers"``.

    Elastic membership (traces with `kinds`): a LEAVE prices zero — the
    left node simply stops accruing events, and a node whose availability
    window is closed has no events at all, so down time prices zero
    compute and zero bytes by construction. A JOIN prices exactly ONE
    payload: the donor pushes its packed model (fire-and-forget, like a
    non-blocking send) and the joiner cannot proceed before it arrives —
    ready[joiner] = max(ready[joiner], ready[donor]) + comm.
    """
    if mode not in ("blocking", "nonblocking", "overlap"):
        raise ValueError(mode)
    n = trace.n_nodes
    speeds = trace.rates if speeds is None else np.asarray(speeds, np.float64)
    step_t = np.asarray([cost.step_time_s(s) for s in speeds])
    comm_by_tier = (cost.comm_time_s(0), cost.comm_time_s(1))

    def tier_of(e):
        return 0 if tiers is None else int(tiers[e])

    ready = np.zeros(n, np.float64)
    busy = np.zeros(n, np.float64)         # compute-busy seconds per node
    wait = np.zeros(n, np.float64)         # rendezvous wait per node
    comm_total = 0.0
    join_comm = 0.0
    tier_events = [0, 0]
    tier_bytes = [0, 0]
    tier_seconds = [0.0, 0.0]
    n_joins = n_leaves = 0
    for e in range(trace.n_events):
        i, j = int(trace.pairs[e, 0]), int(trace.pairs[e, 1])
        comm_t = comm_by_tier[tier_of(e)]
        if trace.kinds is not None and int(trace.kinds[e]) != 0:
            if int(trace.kinds[e]) == EVENT_JOIN:
                comm_total += comm_t
                join_comm += comm_t
                tier_events[tier_of(e)] += 1
                tier_bytes[tier_of(e)] += cost.payload_bytes
                tier_seconds[tier_of(e)] += comm_t
                ready[i] = max(ready[i], ready[j]) + comm_t
                n_joins += 1
            else:
                n_leaves += 1
            continue
        hi, hj = int(trace.h[e, 0]), int(trace.h[e, 1])
        ci, cj = hi * step_t[i], hj * step_t[j]
        ti, tj = ready[i] + ci, ready[j] + cj
        busy[i] += ci
        busy[j] += cj
        comm_total += 2 * comm_t
        tier_events[tier_of(e)] += 1
        tier_bytes[tier_of(e)] += 2 * cost.payload_bytes
        tier_seconds[tier_of(e)] += 2 * comm_t
        if mode == "blocking":
            meet = max(ti, tj)
            wait[i] += meet - ti
            wait[j] += meet - tj
            ready[i] = ready[j] = meet + comm_t
        elif mode == "nonblocking":
            ready[i] = ti + comm_t
            ready[j] = tj + comm_t
        else:  # overlap: comm hides under the steps just taken
            ready[i] = ti + max(0.0, comm_t - ci)
            ready[j] = tj + max(0.0, comm_t - cj)
    total = float(ready.max()) if n else 0.0
    churn = {} if trace.kinds is None else \
        {"n_joins": n_joins, "n_leaves": n_leaves,
         "join_comm_s": join_comm}
    tier_table = {} if tiers is None else {"tiers": {
        name: {"events": tier_events[t], "bytes": tier_bytes[t],
               "seconds": tier_seconds[t], "comm_time_s": comm_by_tier[t]}
        for t, name in enumerate(("intra", "inter"))}}
    return {
        **churn,
        **tier_table,
        "mode": mode,
        "total_s": total,
        "events_per_s": trace.n_events / total if total > 0 else 0.0,
        "compute_busy_s": busy.tolist(),
        "rendezvous_wait_s": wait.tolist(),
        "wait_frac": float(wait.sum() / max(busy.sum() + wait.sum(), 1e-30)),
        "comm_total_s": comm_total,
        "step_time_s": step_t.tolist(),
        "comm_time_s": comm_by_tier[0],
    }


def analytic_walltime(trace: Trace, cost: CostParams, *,
                      mode: str = "blocking",
                      speeds: Optional[np.ndarray] = None,
                      tiers: Optional[np.ndarray] = None) -> float:
    """Closed-form envelope (no event replay): per-node serial work from
    the trace's aggregate step counts, evenly overlapped — the system
    finishes no sooner than its busiest node and no sooner than the mean
    load. Blocking adds the two-sample rendezvous penalty: each exchange
    waits E|T_i − T_j| ≈ the gap between the pair's expected accrued-work
    times, approximated from the speed spread. `tiers` prices each
    event's payload on its own link tier (see `predict_walltime`); None
    keeps the single-tier closed form bitwise."""
    n = trace.n_nodes
    speeds = trace.rates if speeds is None else np.asarray(speeds, np.float64)
    step_t = np.asarray([cost.step_time_s(s) for s in speeds])
    comm_t = cost.comm_time_s()
    comm_by_tier = (cost.comm_time_s(0), cost.comm_time_s(1))
    def kind_of(e):
        return 0 if trace.kinds is None else int(trace.kinds[e])

    work = np.zeros(n, np.float64)
    part = np.zeros(n, np.int64)
    comm_acc = np.zeros(n, np.float64)   # per-node tier-priced comm seconds
    for e in range(trace.n_events):
        k = kind_of(e)
        ct = comm_by_tier[0 if tiers is None else int(tiers[e])]
        if k == EVENT_LEAVE:
            continue                     # a leave prices nothing
        if k == EVENT_JOIN:
            part[trace.pairs[e, 0]] += 1  # joiner waits for one payload
            comm_acc[trace.pairs[e, 0]] += ct
            continue
        for s in range(2):
            i = int(trace.pairs[e, s])
            work[i] += int(trace.h[e, s]) * step_t[i]
            comm_acc[i] += ct
        part[trace.pairs[e, 0]] += 1
        part[trace.pairs[e, 1]] += 1
    if mode == "overlap":
        per_node = work  # comm fully hidden (first-order)
    elif tiers is None:
        per_node = work + part * comm_t   # the pre-hier closed form, bitwise
    else:
        per_node = work + comm_acc
    lower = float(max(per_node.max(), per_node.mean()))
    if mode != "blocking":
        return lower
    # rendezvous penalty: mean |per-interaction work gap| between endpoints
    per_int = np.divide(work, np.maximum(part, 1))
    gaps = []
    for e in range(trace.n_events):
        if kind_of(e) != 0:
            continue
        i, j = int(trace.pairs[e, 0]), int(trace.pairs[e, 1])
        gaps.append(abs(per_int[i] - per_int[j]))
    return lower + 0.5 * float(np.sum(gaps)) / max(n, 1)


def bsp_payload_factor(algo: str, graph=None) -> float:
    """Per-round wire multiplier for the bulk-synchronous baselines: ring
    all-reduce moves ~2x the payload per node (reduce-scatter +
    all-gather); D-PSGD exchanges one payload per graph neighbor."""
    if algo == "dpsgd":
        return float(graph.r) if graph is not None else 4.0
    return 2.0


def predict_bsp_walltime(trace: Trace, sched, cost: CostParams, *,
                         speeds: Optional[np.ndarray] = None,
                         payload_factor: float = 2.0) -> Dict:
    """Wall-clock replay for the BULK-SYNCHRONOUS baselines (LocalSGD /
    D-PSGD / AllReduce) on a bridged schedule: each bin is one global
    round — participants run their accrued local steps, the round closes
    with a global collective (`payload_factor` x payload over link_bw +
    latency), and the next round cannot start before the SLOWEST
    participant arrives. The global rendezvous is what the paper's
    asynchronous pairwise process removes; pricing both from the same
    trace makes the comparison direct.

    `sched` is the `BinnedSchedule` the engine actually executed (its h /
    mask arrays define each round's work); `speeds` defaults to the
    trace's clock rates, as in `predict_walltime`.
    """
    n = trace.n_nodes
    speeds = trace.rates if speeds is None else np.asarray(speeds, np.float64)
    step_t = np.asarray([cost.step_time_s(s) for s in speeds])
    comm_t = cost.link_latency_s + \
        payload_factor * cost.payload_bytes / cost.link_bw
    busy = np.zeros(n, np.float64)
    wait = np.zeros(n, np.float64)
    total = 0.0
    for s in range(sched.n_supersteps):
        work = sched.h[s] * step_t * sched.mask[s]
        round_compute = float(work.max()) if n else 0.0
        busy += work
        wait += (round_compute - work) * sched.mask[s]
        total += round_compute + comm_t
    return {
        "mode": "bsp",
        "total_s": total,
        # closed-form envelope (no replay): the busiest node's serial work
        # plus every round's collective — the BSP analogue of
        # `analytic_walltime`, reported alongside the replay
        "analytic_s": float(busy.max() if n else 0.0) +
        comm_t * sched.n_supersteps,
        "rounds": int(sched.n_supersteps),
        "events_per_s": trace.n_events / total if total > 0 else 0.0,
        "compute_busy_s": busy.tolist(),
        "rendezvous_wait_s": wait.tolist(),
        "wait_frac": float(wait.sum() / max(busy.sum() + wait.sum(), 1e-30)),
        "comm_total_s": comm_t * sched.n_supersteps,
        "step_time_s": step_t.tolist(),
        "comm_time_s": comm_t,
        "payload_factor": payload_factor,
    }


def predict_all_modes(trace: Trace, cost: CostParams,
                      speeds: Optional[np.ndarray] = None,
                      tiers: Optional[np.ndarray] = None) -> Dict:
    """Replay + closed form for all three execution modes — the
    predicted-vs-simulated table of the driver's ``sched_cost`` line.
    `tiers` switches on two-tier pricing and adds the per-tier
    link-utilization breakdown to each mode's row."""
    out = {}
    for mode in ("blocking", "nonblocking", "overlap"):
        rep = predict_walltime(trace, cost, mode=mode, speeds=speeds,
                               tiers=tiers)
        out[mode] = {
            "simulated_s": rep["total_s"],
            "predicted_s": analytic_walltime(trace, cost, mode=mode,
                                             speeds=speeds, tiers=tiers),
            "wait_frac": rep["wait_frac"],
            "events_per_s": rep["events_per_s"],
            **({"tiers": rep["tiers"]} if tiers is not None else {}),
        }
        out[mode]["predicted_over_simulated"] = (
            out[mode]["predicted_s"] / out[mode]["simulated_s"]
            if out[mode]["simulated_s"] > 0 else float("nan"))
    if out["nonblocking"]["simulated_s"] > 0:
        out["speedup_nonblocking_vs_blocking"] = \
            out["blocking"]["simulated_s"] / out["nonblocking"]["simulated_s"]
        out["speedup_overlap_vs_blocking"] = \
            out["blocking"]["simulated_s"] / out["overlap"]["simulated_s"]
    return out
