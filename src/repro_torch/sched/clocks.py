"""Per-node Poisson clocks with heterogeneous rates (the paper's §2 model);
numpy copy of ``repro/sched/clocks.py`` that draws from its generator in
exactly the reference's order, so a seed gives the same event stream.

The paper's asynchronous gossip process gives every node an independent
Poisson clock; when node i's clock rings it picks a neighbor j and the pair
interacts. The convergence analysis lives in exactly this model, and the
headline systems claim — end-to-end wall-clock speedup on a machine with
*non-uniform* node speeds — only exists when the clocks are heterogeneous
(Even et al., "Asynchronous SGD on Graphs", analyze the same regime; DIGEST
shows local-update methods win or lose on the straggler profile).

This module generates the event stream: `RateProfile` builds per-node rates
(uniform / lognormal / explicit), `StragglerConfig` injects slow nodes and
transient node failures, and `PoissonClocks` is the deterministic-per-seed
generator. Implementation is the standard superposition + thinning
construction: one global exponential clock at rate Λ = Σλ_i; each ring picks
the initiator i w.p. λ_i/Λ and a partner j from i's (weighted) neighbor
distribution; rings at nodes that are down (failure injection) are thinned.
Thinning keeps the construction exact — discarding a candidate ring does not
bias the surviving process — and keeps generation O(1) state so the clock
can be checkpointed and resumed bit-exactly (`state_dict`/`from_state`).

Everything here is host-side numpy: the scheduler *generates traces*; the
engine replays them (see `sched/bridge.py`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core.graph import Graph
from repro_torch.sched.avail import (AvailabilityModel, EVENT_JOIN, EVENT_LEAVE,
                               EVENT_MIX)


@dataclass(frozen=True)
class RateProfile:
    """Per-node Poisson clock rates λ_i.

    kind:
      uniform    — all nodes ring at the same rate (the homogeneous ideal;
                   with `sync` trace generation this reproduces today's
                   superstep engine bit-exactly — see trace.py);
      lognormal  — λ_i ~ LogNormal(0, sigma), the standard heavy-tailed
                   node-speed model for clusters (FLGo's responsiveness
                   profiles; DIGEST's straggler sweeps);
      explicit   — caller-provided rates (supercomputer speed measurements,
                   adversarial profiles, ...).

    Rates are normalized to mean 1 so virtual time has the same scale across
    profiles (one unit ≈ one expected ring per node).
    """
    kind: str = "uniform"
    sigma: float = 0.5                       # lognormal shape
    rates: Optional[Tuple[float, ...]] = None  # explicit per-node rates

    def make_rates(self, n: int, seed: int = 0) -> np.ndarray:
        if self.kind == "uniform":
            r = np.ones(n, np.float64)
        elif self.kind == "lognormal":
            rng = np.random.default_rng(seed)
            r = rng.lognormal(0.0, self.sigma, size=n)
        elif self.kind == "explicit":
            if self.rates is None:
                raise ValueError("explicit RateProfile needs rates=")
            r = np.asarray(self.rates, np.float64)
            if r.shape != (n,):
                raise ValueError(f"rates shape {r.shape} != ({n},)")
        else:
            raise ValueError(f"unknown rate profile kind {self.kind!r}")
        if not np.all(np.isfinite(r)) or np.any(r <= 0):
            raise ValueError("rates must be finite and positive")
        return r / r.mean()


@dataclass(frozen=True)
class StragglerConfig:
    """Straggler + transient-failure injection on top of a rate profile.

    fraction/slowdown: the slowest `fraction` of nodes get their clock (and
    compute speed) divided by `slowdown` — the deterministic straggler of
    the paper's supercomputer experiments (some nodes are just slower).
    Which nodes straggle is seed-deterministic.

    fail_rate/fail_duration: each node independently fails at Poisson rate
    `fail_rate` (per unit virtual time) and stays down for `fail_duration`;
    a down node neither rings nor accepts partners (its candidate events
    are thinned), modeling transient node loss — SwarmSGD's fault story is
    that the survivors keep gossiping instead of blocking on a dead peer.
    """
    fraction: float = 0.0
    slowdown: float = 10.0
    fail_rate: float = 0.0
    fail_duration: float = 0.0

    def apply(self, rates: np.ndarray, seed: int = 0
              ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (adjusted rates, straggler bool mask). The SLOWEST `fraction`
        of nodes by base rate straggle (seeded random tie-break, so the
        uniform profile still gets a deterministic-per-seed subset)."""
        if not 0.0 <= self.fraction < 1.0:
            raise ValueError(f"straggler fraction {self.fraction} not in [0,1)")
        if self.slowdown < 1.0:
            raise ValueError("slowdown must be >= 1")
        mask = np.zeros(len(rates), bool)
        if self.fraction > 0.0:
            k = max(1, int(round(self.fraction * len(rates))))
            tiebreak = np.random.default_rng(seed).random(len(rates))
            mask[np.lexsort((tiebreak, rates))[:k]] = True
        out = rates.copy()
        out[mask] /= self.slowdown
        return out, mask


class PoissonClocks:
    """Deterministic-per-seed generator of timed pairwise interactions.

    Yields (t, i, j): at virtual time t, node i's clock rang and it chose
    neighbor j. Superposition over nodes, neighbor choice from per-node
    edge weights, thinning for failure injection. The full generator state
    (rng bit-generator state, virtual time, failure windows, counters) is
    JSON-serializable via `state_dict()` so a checkpointed run resumes the
    exact same event sequence (`from_state`).
    """

    def __init__(self, graph: Graph, rates: np.ndarray, seed: int = 0,
                 straggler: StragglerConfig = StragglerConfig(),
                 edge_weights: Optional[np.ndarray] = None,
                 edges: Optional[np.ndarray] = None,
                 avail: Optional[AvailabilityModel] = None):
        self.n = graph.n
        base = np.asarray(rates, np.float64)
        if base.shape != (self.n,):
            raise ValueError(f"rates shape {base.shape} != ({self.n},)")
        self.straggler = straggler
        self.rates, self.straggler_mask = straggler.apply(base, seed)
        # interaction edge set: the graph's, or a restriction (e.g. the
        # union of a matching pool — see bridge.pool_edges)
        self.edges = np.asarray(graph.edges if edges is None else edges,
                                np.int64)
        if self.edges.ndim != 2 or self.edges.shape[1] != 2 \
                or len(self.edges) == 0:
            raise ValueError("edges must be a nonempty [m, 2] array")
        if edge_weights is None:
            edge_weights = np.ones(len(self.edges), np.float64)
        w = np.asarray(edge_weights, np.float64)
        if w.shape != (len(self.edges),):
            raise ValueError(
                f"edge_weights shape {w.shape} != ({len(self.edges)},)")
        if not np.all(np.isfinite(w)) or np.any(w < 0) or w.sum() <= 0:
            raise ValueError("edge_weights must be finite, >= 0, not all 0")
        # per-node neighbor tables: nbr[i] = (partner ids, sampling probs)
        self._nbrs, self._nbr_p = [], []
        for i in range(self.n):
            sel_a = self.edges[:, 0] == i
            sel_b = self.edges[:, 1] == i
            partners = np.concatenate([self.edges[sel_a, 1],
                                       self.edges[sel_b, 0]])
            pw = np.concatenate([w[sel_a], w[sel_b]])
            if len(partners) == 0 or pw.sum() <= 0:
                raise ValueError(
                    f"node {i} has no positively-weighted neighbors")
            self._nbrs.append(partners)
            self._nbr_p.append(pw / pw.sum())
        self._node_p = self.rates / self.rates.sum()
        self._total_rate = float(self.rates.sum())
        self._rng = np.random.default_rng(seed)
        self.t = 0.0
        self.n_events = 0
        self.n_thinned = 0
        self._down_until = np.zeros(self.n, np.float64)
        self._next_fail = np.full(self.n, np.inf)
        if straggler.fail_rate > 0.0:
            self._next_fail = self._rng.exponential(
                1.0 / straggler.fail_rate, size=self.n)
        # elastic membership (avail.py): joined/left flags, join queue, and
        # a FIFO of emitted events (membership events + the surviving mix
        # event of the current ring) drained by next_any_event()
        self.avail = avail
        if avail is not None:
            if avail.n != self.n:
                raise ValueError(f"avail.n {avail.n} != graph.n {self.n}")
            self._joined = avail.join_time <= 0.0
            self._left = np.zeros(self.n, bool)
            self._pending: List[int] = sorted(
                np.nonzero(~self._joined)[0].tolist(),
                key=lambda i: (avail.join_time[i], i))
        else:
            self._joined = np.ones(self.n, bool)
            self._left = np.zeros(self.n, bool)
            self._pending = []
        self._mq: List[Tuple[float, int, int, int]] = []

    def _advance_failures(self):
        # drain EVERY due failure (a long inter-event gap can contain
        # several fail/recover cycles for one node; a single pass would
        # bias the failure process low at high fail_rate)
        while True:
            due = np.nonzero(self._next_fail <= self.t)[0]
            if len(due) == 0:
                return
            for i in due:
                self._down_until[i] = self._next_fail[i] + \
                    self.straggler.fail_duration
                self._next_fail[i] = self._down_until[i] + \
                    self._rng.exponential(1.0 / self.straggler.fail_rate)

    def _alive(self, i: int) -> bool:
        if self._down_until[i] > self.t:
            return False
        if self.avail is not None:
            if not self._joined[i] or self._left[i]:
                return False
            if not self.avail.window_up(i, self.t):
                return False
        return True

    def member_mask(self) -> np.ndarray:
        """[n] bool — current members (joined and not permanently left)."""
        return self._joined & ~self._left

    def _process_membership(self):
        """Emit due LEAVE and eligible JOIN events at the current time.

        Leaves first: a node past its leave_time is retired before it can
        donate to a joiner. A pending joiner joins at the first ring where
        its window is open and it has an alive member neighbor; the donor
        is drawn from the joiner's (weighted) neighbor distribution,
        restricted to alive members, on the same rng stream — so the whole
        construction stays deterministic-per-seed and resumable.
        """
        av = self.avail
        due = np.nonzero(self._joined & ~self._left
                         & (av.leave_time <= self.t))[0]
        for i in due:
            self._left[i] = True
            # stamped at the detecting ring (not leave_time itself) so the
            # emitted stream stays time-sorted
            self._mq.append((self.t, EVENT_LEAVE, int(i), int(i)))
        still: List[int] = []
        for i in self._pending:
            if av.join_time[i] <= self.t and av.window_up(i, self.t):
                nbrs, p = self._nbrs[i], self._nbr_p[i]
                ok = np.asarray([self._alive(int(j)) for j in nbrs])
                if ok.any():
                    w = p * ok
                    donor = int(self._rng.choice(nbrs, p=w / w.sum()))
                    self._joined[i] = True
                    self._mq.append((self.t, EVENT_JOIN, int(i), donor))
                    continue
            still.append(i)
        self._pending = still

    def next_event(self) -> Tuple[float, int, int]:
        """Next surviving interaction (t, i, j); advances the clock.

        Only valid without an availability model — membership events would
        be silently dropped; churn consumers use `next_any_event()`.
        """
        if self.avail is not None:
            raise RuntimeError(
                "PoissonClocks has an availability model; use "
                "next_any_event() so join/leave events are not dropped")
        while True:
            self.t += self._rng.exponential(1.0 / self._total_rate)
            if self.straggler.fail_rate > 0.0:
                self._advance_failures()
            i = int(self._rng.choice(self.n, p=self._node_p))
            j = int(self._rng.choice(self._nbrs[i], p=self._nbr_p[i]))
            if self._alive(i) and self._alive(j):
                self.n_events += 1
                return self.t, i, j
            self.n_thinned += 1

    def next_any_event(self) -> Tuple[float, int, int, int]:
        """Next event including membership: (t, kind, i, j) with kind one
        of EVENT_MIX / EVENT_JOIN (i=joiner, j=donor) / EVENT_LEAVE (i=j).
        Membership changes are checked at every ring of the global clock,
        so join/leave times are quantized to the event stream — the same
        discretization the availability thinning already implies.
        """
        while True:
            if self._mq:
                t, kind, i, j = self._mq.pop(0)
                self.n_events += 1
                return t, kind, i, j
            self.t += self._rng.exponential(1.0 / self._total_rate)
            if self.straggler.fail_rate > 0.0:
                self._advance_failures()
            if self.avail is not None:
                self._process_membership()
            i = int(self._rng.choice(self.n, p=self._node_p))
            j = int(self._rng.choice(self._nbrs[i], p=self._nbr_p[i]))
            if self._alive(i) and self._alive(j):
                self._mq.append((self.t, EVENT_MIX, i, j))
            else:
                self.n_thinned += 1

    def __iter__(self) -> Iterator[Tuple[float, int, int]]:
        while True:
            yield self.next_event()

    # -- checkpointable state (JSON-serializable; bit-exact resume) --------

    def state_dict(self) -> dict:
        d = {
            "rng": self._rng.bit_generator.state,
            "t": self.t,
            "n_events": self.n_events,
            "n_thinned": self.n_thinned,
            "down_until": self._down_until.tolist(),
            "next_fail": [None if not np.isfinite(x) else float(x)
                          for x in self._next_fail],
        }
        if self.avail is not None:
            d["joined"] = self._joined.tolist()
            d["left"] = self._left.tolist()
            d["pending"] = list(self._pending)
            d["mq"] = [[float(t), int(k), int(i), int(j)]
                       for (t, k, i, j) in self._mq]
        return d

    def load_state(self, state: dict) -> "PoissonClocks":
        self._rng.bit_generator.state = state["rng"]
        self.t = float(state["t"])
        self.n_events = int(state["n_events"])
        self.n_thinned = int(state["n_thinned"])
        self._down_until = np.asarray(state["down_until"], np.float64)
        self._next_fail = np.asarray(
            [np.inf if x is None else x for x in state["next_fail"]],
            np.float64)
        if self.avail is not None:
            self._joined = np.asarray(state["joined"], bool)
            self._left = np.asarray(state["left"], bool)
            self._pending = [int(i) for i in state["pending"]]
            self._mq = [(float(t), int(k), int(i), int(j))
                        for (t, k, i, j) in state.get("mq", [])]
        return self

    @classmethod
    def from_state(cls, state: dict, graph: Graph, rates: np.ndarray,
                   seed: int = 0, straggler: StragglerConfig = StragglerConfig(),
                   edge_weights: Optional[np.ndarray] = None,
                   edges: Optional[np.ndarray] = None,
                   avail: Optional[AvailabilityModel] = None
                   ) -> "PoissonClocks":
        """Rebuild a clock (same construction args) and restore its state."""
        return cls(graph, rates, seed, straggler, edge_weights,
                   edges, avail=avail).load_state(state)


def participation_rates(clocks: PoissonClocks) -> np.ndarray:
    """Expected interactions per unit virtual time PER NODE: node i
    participates when its own clock rings (rate λ_i) or a neighbor j rings
    and picks it (rate λ_j · p_j(i)). Used to calibrate local-step accrual
    so the effective H matches the configured H (trace.py)."""
    part = clocks.rates.copy()
    for j in range(clocks.n):
        for i, p in zip(clocks._nbrs[j], clocks._nbr_p[j]):
            part[int(i)] += clocks.rates[j] * float(p)
    return part
