"""Virtual-time event traces: the scheduler's unit of exchange (numpy copy
of ``repro/sched/trace.py``).

A `Trace` is a finite sequence of timed pairwise interactions (t, i, j)
with, per participant, the number of local SGD steps it accrued since ITS
previous interaction — the paper's asynchronous process made concrete as
data. Traces are generated once (host-side numpy, deterministic per seed),
then either replayed sequentially (`core/simulator.py` oracles), compiled
into batched supersteps for the engine (`sched/bridge.py`), or priced
by the wall-clock cost model (`sched/cost.py`).

Local-step accrual (`h_mode`):
  fixed      — h = H at every interaction (the paper's fixed-H regime on an
               asynchronous clock);
  geometric  — h ~ Geom(1/H) clipped to [1, h_max] (Thm 4.1's H_i);
  rate       — h ~ 1 + Poisson(μ_i · gap_i): steps accumulate at the node's
               own compute rate μ_i over the virtual-time gap since its last
               interaction — the heterogeneous-compute regime of Even et al.
               μ_i is calibrated so the rate-weighted mean h ≈ H, and μ is
               proportional to the node's clock rate (slow clock = slow
               compute: a straggler interacts rarely AND steps slowly).

All h are clipped to [1, h_max] (the engine's static loop bound); the clip
count is reported in `trace_stats` so a profile that saturates h_max is
visible rather than silently distorted.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from repro_torch.core.graph import Graph, sample_matching
from repro_torch.sched.avail import (AvailabilityModel, EVENT_JOIN, EVENT_LEAVE,
                               EVENT_MIX)
from repro_torch.sched.clocks import (PoissonClocks, RateProfile, StragglerConfig,
                                participation_rates)


@dataclass
class Trace:
    n_nodes: int
    times: np.ndarray        # [E] float64 — virtual event times, increasing
    pairs: np.ndarray        # [E, 2] int32 — (i, j) interaction endpoints
    h: np.ndarray            # [E, 2] int32 — local steps accrued by i and j
    rates: np.ndarray        # [n] float64 — effective per-node clock rates
    h_max: int
    meta: Dict = field(default_factory=dict)
    # elastic membership (avail.py); None for fixed-membership traces
    kinds: Optional[np.ndarray] = None  # [E] int8 — EVENT_MIX/JOIN/LEAVE
    alive: Optional[np.ndarray] = None  # [E, n] bool — members AFTER event e

    @property
    def n_events(self) -> int:
        return len(self.times)

    def validate(self):
        E = self.n_events
        assert self.pairs.shape == (E, 2) and self.h.shape == (E, 2)
        assert np.all(np.diff(self.times) >= 0), "times must be sorted"
        assert np.all(self.pairs >= 0) and np.all(self.pairs < self.n_nodes)
        assert np.all(self.h >= 0) and np.all(self.h <= self.h_max)
        if self.kinds is None:
            assert np.all(self.pairs[:, 0] != self.pairs[:, 1]), "self-loops"
        else:
            assert self.kinds.shape == (E,)
            assert self.alive is not None \
                and self.alive.shape == (E, self.n_nodes)
            mix = self.kinds == EVENT_MIX
            join = self.kinds == EVENT_JOIN
            pairish = mix | join
            assert np.all(self.pairs[pairish, 0] != self.pairs[pairish, 1]), \
                "self-loops in mix/join events"
            leave = self.kinds == EVENT_LEAVE
            assert np.all(self.pairs[leave, 0] == self.pairs[leave, 1]), \
                "leave events carry (i, i)"
            assert np.all(self.h[join | leave] == 0), \
                "membership events accrue no local steps"
            assert np.all(self.h[mix] >= 1), "mix events accrue h >= 1"
        return self


def _accrue_h(rng, mode: str, H: int, h_max: int, mu: float, gap: float
              ) -> int:
    if mode == "fixed":
        h = H
    elif mode == "geometric":
        h = int(rng.geometric(1.0 / H))
    elif mode == "rate":
        h = 1 + int(rng.poisson(mu * gap))
    else:
        raise ValueError(f"unknown h_mode {mode!r}")
    return int(np.clip(h, 1, h_max))


def generate_trace(graph: Graph, profile: RateProfile, n_events: int, *,
                   H: int = 2, h_max: int = 8, h_mode: str = "rate",
                   seed: int = 0,
                   straggler: StragglerConfig = StragglerConfig(),
                   edge_weights: Optional[np.ndarray] = None,
                   edges: Optional[np.ndarray] = None,
                   clocks: Optional[PoissonClocks] = None,
                   last_t: Optional[np.ndarray] = None,
                   avail: Optional[AvailabilityModel] = None) -> Trace:
    """Asynchronous Poisson trace: `n_events` surviving interactions.

    Pass a pre-built (possibly checkpoint-restored) `clocks` to continue an
    existing event stream; otherwise one is constructed from (profile,
    straggler, seed). The h-sampling rng IS the clock's rng stream, so
    trace generation as a whole is resumable from
    `PoissonClocks.state_dict()` plus the per-node accrual state `last_t`
    (each node's last interaction time, returned in `meta["last_t"]`).

    With an availability model (`avail=`, or a `clocks` built with one),
    the trace carries elastic membership: `kinds` marks join/leave events
    (which accrue h = 0) and `alive[e]` is the member set after event e.
    Rate-mode h accrual then uses each node's UP-time within its gap, not
    wall gap — a node off-duty overnight is not credited overnight steps.
    """
    if clocks is None:
        rates = profile.make_rates(graph.n, seed)
        clocks = PoissonClocks(graph, rates, seed, straggler,
                               edge_weights=edge_weights, edges=edges,
                               avail=avail)
    n = clocks.n
    churn = clocks.avail is not None
    # rate-mode calibration: node i participates at rate part_i; steps
    # accrue at μ_i = (H - 1) · part_i so E[h_i] = 1 + μ_i · E[gap_i] ≈ H
    part = participation_rates(clocks)
    mu = (max(H - 1, 0)) * part
    last_t = np.full(n, clocks.t, np.float64) if last_t is None \
        else np.asarray(last_t, np.float64).copy()
    times = np.empty(n_events, np.float64)
    pairs = np.empty((n_events, 2), np.int32)
    hs = np.empty((n_events, 2), np.int32)
    kinds = np.zeros(n_events, np.int8) if churn else None
    alive = np.zeros((n_events, n), bool) if churn else None
    clipped = n_joins = n_leaves = 0
    for e in range(n_events):
        if churn:
            t, kind, i, j = clocks.next_any_event()
        else:
            t, i, j = clocks.next_event()
            kind = EVENT_MIX
        times[e] = t
        pairs[e] = (i, j)
        if kind == EVENT_MIX:
            for k, node in enumerate((i, j)):
                gap = clocks.avail.uptime(node, last_t[node], t) if churn \
                    else t - last_t[node]
                hs[e, k] = _accrue_h(clocks._rng, h_mode, H, h_max,
                                     mu[node], gap)
                last_t[node] = t
            clipped += int(hs[e, 0] == h_max) + int(hs[e, 1] == h_max)
        else:
            hs[e] = (0, 0)
            if kind == EVENT_JOIN:
                last_t[i] = t  # joiner starts accruing from its join
                n_joins += 1
            else:
                n_leaves += 1
        if churn:
            kinds[e] = kind
            alive[e] = clocks.member_mask()
    tr = Trace(n, times, pairs, hs, clocks.rates.copy(), h_max, meta={
        "kind": "poisson", "profile": profile.kind, "h_mode": h_mode,
        "H": H, "seed": seed, "n_thinned": clocks.n_thinned,
        "straggler_mask": clocks.straggler_mask.tolist(),
        "h_at_max": clipped, "last_t": last_t.tolist(),
        "n_joins": n_joins, "n_leaves": n_leaves,
    }, kinds=kinds, alive=alive)
    return tr.validate()


def synchronous_trace(graph: Graph, n_rounds: int, *, H: int = 2,
                      seed: int = 0,
                      rng: Optional[np.random.Generator] = None) -> Trace:
    """The superstep idealization AS a trace: every round, one uniformly
    sampled maximal matching of G at unit virtual-time spacing, h = H for
    every participant. On a complete graph with even n the matchings are
    perfect, so binning this trace (bridge.py) reproduces today's
    synchronous engine schedule exactly — the uniform-rate anchor that the
    heterogeneous profiles are measured against. Pass the SAME `rng` stream
    the plain driver uses for `sample_matching` to get its exact matchings.
    """
    rng = rng or np.random.default_rng(seed)
    times, pairs = [], []
    h_max = H
    for s in range(n_rounds):
        perm = sample_matching(graph, rng)
        for i in range(graph.n):
            j = int(perm[i])
            if i < j:
                times.append(float(s + 1))
                pairs.append((i, j))
    E = len(times)
    tr = Trace(graph.n, np.asarray(times), np.asarray(pairs, np.int32),
               np.full((E, 2), H, np.int32), np.ones(graph.n), h_max,
               meta={"kind": "sync", "profile": "uniform", "h_mode": "fixed",
                     "H": H, "seed": seed, "n_rounds": n_rounds})
    return tr.validate()


def trace_stats(trace: Trace) -> Dict:
    """Distributional summary: per-node participation, interaction-gap
    distribution (virtual time), effective H, h_max saturation."""
    n, E = trace.n_nodes, trace.n_events
    part = np.zeros(n, np.int64)
    steps = np.zeros(n, np.int64)
    gaps = []
    last_t = np.full(n, np.nan)
    mix_sel = np.ones(E, bool) if trace.kinds is None \
        else trace.kinds == EVENT_MIX
    for e in range(E):
        if not mix_sel[e]:
            continue  # membership events: no participation / h accounting
        t = trace.times[e]
        for k in range(2):
            i = int(trace.pairs[e, k])
            part[i] += 1
            steps[i] += int(trace.h[e, k])
            if np.isfinite(last_t[i]):
                gaps.append(t - last_t[i])
            last_t[i] = t
    gaps = np.asarray(gaps) if gaps else np.zeros(1)
    h_flat = trace.h[mix_sel].reshape(-1).astype(np.float64)
    if len(h_flat) == 0:
        h_flat = np.zeros(1)
    churn_stats = {} if trace.kinds is None else {
        "n_mix": int(mix_sel.sum()),
        "n_joins": int(np.sum(trace.kinds == EVENT_JOIN)),
        "n_leaves": int(np.sum(trace.kinds == EVENT_LEAVE)),
        "alive_final": int(trace.alive[-1].sum()) if E else n,
        "alive_min": int(trace.alive.sum(axis=1).min()) if E else n,
    }
    return {
        **churn_stats,
        "n_events": E,
        "n_nodes": n,
        "participation": part.tolist(),
        "participation_min": int(part.min()),
        "participation_max": int(part.max()),
        "participation_cv": float(part.std() / max(part.mean(), 1e-12)),
        "local_steps_total": steps.tolist(),
        "effective_H": float(h_flat.mean()),
        "h_at_max_frac": float(np.mean(h_flat == trace.h_max)),
        "gap_mean": float(gaps.mean()),
        "gap_p50": float(np.percentile(gaps, 50)),
        "gap_p95": float(np.percentile(gaps, 95)),
        "gap_max": float(gaps.max()),
        "virtual_span": float(trace.times[-1] - trace.times[0]) if E else 0.0,
        "rate_min": float(trace.rates.min()),
        "rate_max": float(trace.rates.max()),
    }
