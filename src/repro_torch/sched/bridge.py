"""Trace → superstep compiler: run asynchronous traces on the engine (numpy
copy of ``repro/sched/bridge.py``; the bins are host arrays, which the
driver ships to the device once).

The engine (`core/swarm.py`) executes synchronous supersteps: one matching,
all nodes, vectorized. An asynchronous trace is a *sequence of single
events*. The bridge reconciles the two by greedy time-ordered binning:
consecutive events are packed into a bin as long as the bin stays a
matching (each node at most once); the bin becomes one engine superstep
with a *participation mask* (who interacted this bin), an involution perm
(who with whom), and *per-node h counts* (each participant's accrued local
steps). Non-participants are masked out of both the local-step loop
(h = 0) and the gossip average — the engine keeps its node-stacked shape, idle
lanes just carry masked work.

Why binning is exact (not an approximation): events within a bin are
node-disjoint, and a node's state only changes at its own local steps and
interactions, so any two events in one bin commute — the binned execution
computes the same values as the sequential event process, in both blocking
and non-blocking (superstep-start staleness) semantics. This is asserted
against the reference's sequential oracle
(`repro/core/simulator.py::run_events_oracle`).

Transport constraints: the `gather` transport (the only one the port runs
so far) takes any per-bin involution; the pool and static-pair
restrictions below are kept for the multi-GPU transports.
The `ppermute` transport's pairs are compiled in — bins must be subsets of
that one static matching (generate the trace with `edges=static pairs`).
The `ppermute_pool` transport switches between K compiled matchings — each
bin must be a subset of ONE pool matching; `bin_trace(pool=...)` tracks the
set of still-compatible pool indices per bin and closes the bin when it
would become empty (generate the trace with `edges=pool_edges(pool)` so
every single event is representable).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.sched.avail import EVENT_JOIN, EVENT_LEAVE, EVENT_MIX
from repro_torch.sched.trace import Trace


@dataclass
class BinnedSchedule:
    """Compiled engine schedule: one row per superstep (bin).

    Elastic membership (traces with `kinds`) adds three columns:
      kinds  [S]    — bin kind: EVENT_MIX bins are ordinary supersteps;
                      an EVENT_JOIN bin is *exclusive* (one joiner/donor
                      pair, h = 0, mask marks the joiner only) and the
                      driver runs the join-bootstrap step instead of a
                      gossip superstep;
      alive  [S, n] — the member set while bin s executes;
      retire [S+1, n] — retire[s] marks nodes whose permanent leave takes
                      effect BEFORE bin s executes (retire[S]: after the
                      last bin); the driver calls `core/swarm.retire_nodes`.
    Leaves never occupy a bin — a left node simply stops appearing in
    masks, so retirement is a state-bookkeeping step, not a superstep.
    """
    perms: np.ndarray            # [S, n] int32 involutions (identity off-bin)
    h: np.ndarray                # [S, n] int32, 0 at non-participants
    mask: np.ndarray             # [S, n] bool participation
    event_bin: np.ndarray        # [E] int32 — bin id of each trace event
    pool_idx: Optional[np.ndarray] = None   # [S] int32 (pool transport only)
    kinds: Optional[np.ndarray] = None      # [S] int8 (churn only)
    alive: Optional[np.ndarray] = None      # [S, n] bool (churn only)
    retire: Optional[np.ndarray] = None     # [S+1, n] bool (churn only)
    # hierarchical traces only (core/hier.py): the
    # link tier each bin schedules against (0 intra / 1 inter). Bins are
    # tier-PURE — `bin_trace(tiers=...)` closes the open bin on a tier
    # change — so a whole superstep prices against one link class and the
    # inter bins are exactly the ones that ride the slow tier.
    tiers: Optional[np.ndarray] = None      # [S] int8 (hier only)

    @property
    def n_supersteps(self) -> int:
        return len(self.perms)

    @property
    def n_nodes(self) -> int:
        return self.perms.shape[1]

    def validate(self) -> "BinnedSchedule":
        S, n = self.perms.shape
        idx = np.arange(n)
        for s in range(S):
            p = self.perms[s]
            assert (p[p] == idx).all(), f"bin {s}: perm not an involution"
            m = p != idx
            if self.kinds is not None and self.kinds[s] == EVENT_JOIN:
                assert m.sum() == 2, f"join bin {s}: exactly one pair"
                assert (self.h[s] == 0).all(), f"join bin {s}: h must be 0"
                assert self.mask[s].sum() == 1 and (self.mask[s] <= m).all(), \
                    f"join bin {s}: mask marks exactly the joiner"
            else:
                assert (self.mask[s] == m).all(), f"bin {s}: mask != matched"
                assert ((self.h[s] > 0) == m).all(), \
                    f"bin {s}: h>0 must be exactly the participants"
            if self.alive is not None:
                assert (self.mask[s] <= self.alive[s]).all(), \
                    f"bin {s}: participants must be members"
        if self.retire is not None:
            assert self.retire.shape == (S + 1, n)
        if self.tiers is not None:
            assert self.tiers.shape == (S,), \
                f"tiers shape {self.tiers.shape} != ({S},)"
        return self

    def density(self) -> float:
        """Mean fraction of nodes active per superstep — the
        utilization the engine gets out of this trace (1.0 = today's fully
        synchronous supersteps)."""
        return float(self.mask.mean()) if self.mask.size else 0.0


def _pairs_of(pool_perm: np.ndarray) -> set:
    return {(int(min(i, j)), int(max(i, j)))
            for i, j in enumerate(pool_perm) if i < pool_perm[i]}


def pool_edges(pool: Sequence[np.ndarray]) -> np.ndarray:
    """Union of a matching pool's pairs as an edge array — the interaction
    edge set to generate pool-transport traces on (every event is then in
    at least one pool matching)."""
    es = set()
    for p in pool:
        es |= _pairs_of(np.asarray(p))
    return np.asarray(sorted(es), np.int64)


def bin_trace(trace: Trace, *, pool: Optional[Sequence[np.ndarray]] = None,
              static_pairs: Optional[Sequence] = None,
              tiers: Optional[np.ndarray] = None) -> BinnedSchedule:
    """Greedy time-ordered binning of a trace into engine supersteps.

    An event opens a new bin when its endpoints collide with the current
    bin, or (pool mode) when no single pool matching contains the bin plus
    the event, or (hier mode: `tiers` = per-EVENT link tier from
    `HierTopology.tier_of_pairs`) when the event's tier differs from the
    open bin's — bins stay tier-pure, so inter-group supersteps schedule
    against the slow link as one unit. Preserves event order within each
    node, total interaction count, and per-node step counts exactly
    (as the reference's property tests hold it).
    """
    n, E = trace.n_nodes, trace.n_events
    if tiers is not None:
        tiers = np.asarray(tiers)
        if tiers.shape != (E,):
            raise ValueError(f"tiers shape {tiers.shape} != ({E},): one "
                             "tier per trace event")
    if pool is not None and static_pairs is not None:
        raise ValueError("pool and static_pairs are mutually exclusive")
    churn = trace.kinds is not None
    if churn and (pool is not None or static_pairs is not None):
        raise ValueError(
            "elastic-membership traces need the gather transport — join "
            "pairs are dynamic and cannot be compiled into static matchings")
    pool_sets: Optional[List[set]] = None
    static_set = None
    if pool is not None:
        pool_sets = [_pairs_of(np.asarray(p)) for p in pool]
    if static_pairs is not None:
        static_set = {(min(int(a), int(b)), max(int(a), int(b)))
                      for a, b in static_pairs if int(a) != int(b)}

    perms: List[np.ndarray] = []
    hs: List[np.ndarray] = []
    masks: List[np.ndarray] = []
    bin_kinds: List[int] = []
    bin_alive: List[np.ndarray] = []
    bin_tiers: List[int] = []
    retires: List = []  # (effect bin idx at record time, node)
    pool_ids: List[int] = []
    event_bin = np.empty(E, np.int32)

    # membership BEFORE event 0 (trace.alive[e] is the set AFTER event e)
    if churn:
        member = trace.alive[0].copy() if E else np.ones(n, bool)
        if E and trace.kinds[0] == EVENT_JOIN:
            member[int(trace.pairs[0, 0])] = False
        elif E and trace.kinds[0] == EVENT_LEAVE:
            member[int(trace.pairs[0, 0])] = True
    else:
        member = np.ones(n, bool)

    cur_perm = np.arange(n, dtype=np.int32)
    cur_h = np.zeros(n, np.int32)
    cur_used = np.zeros(n, bool)
    cur_alive = member.copy()
    cur_cand = list(range(len(pool_sets))) if pool_sets is not None else None
    cur_count = 0
    cur_tier = 0

    def close():
        nonlocal cur_perm, cur_h, cur_used, cur_cand, cur_count, cur_alive
        if cur_count == 0:
            return
        perms.append(cur_perm)
        hs.append(cur_h)
        masks.append(cur_perm != np.arange(n))
        bin_kinds.append(EVENT_MIX)
        bin_alive.append(cur_alive)
        bin_tiers.append(cur_tier)
        if pool_sets is not None:
            pool_ids.append(cur_cand[0])
        cur_perm = np.arange(n, dtype=np.int32)
        cur_h = np.zeros(n, np.int32)
        cur_used = np.zeros(n, bool)
        cur_alive = member.copy()
        cur_cand = list(range(len(pool_sets))) if pool_sets is not None \
            else None
        cur_count = 0

    for e in range(E):
        i, j = int(trace.pairs[e, 0]), int(trace.pairs[e, 1])
        kind = int(trace.kinds[e]) if churn else EVENT_MIX
        if kind == EVENT_LEAVE:
            # no bin: retirement takes effect after the currently open bin
            # (the leave follows node i's last interaction in time order)
            effect = len(perms) + (1 if cur_count > 0 else 0)
            retires.append((effect, i))
            event_bin[e] = effect
            member[i] = False
            continue
        if kind == EVENT_JOIN:
            # exclusive bin: the engine runs the join-bootstrap step for
            # this (joiner, donor) pair instead of a gossip superstep
            close()
            member[i] = True
            p = np.arange(n, dtype=np.int32)
            p[i], p[j] = j, i
            m = np.zeros(n, bool)
            m[i] = True
            perms.append(p)
            hs.append(np.zeros(n, np.int32))
            masks.append(m)
            bin_kinds.append(EVENT_JOIN)
            bin_alive.append(member.copy())
            bin_tiers.append(0 if tiers is None else int(tiers[e]))
            event_bin[e] = len(perms) - 1
            cur_alive = member.copy()
            continue
        key = (min(i, j), max(i, j))
        if static_set is not None and key not in static_set:
            raise ValueError(
                f"event {e} pair {key} is not in the static ppermute "
                "matching — generate the trace with edges=static pairs")
        if pool_sets is not None:
            if not any(key in ps for ps in pool_sets):
                raise ValueError(
                    f"event {e} pair {key} is in no pool matching — "
                    "generate the trace with edges=pool_edges(pool)")
            new_cand = [k for k in cur_cand if key in pool_sets[k]]
        else:
            new_cand = None
        tier_e = 0 if tiers is None else int(tiers[e])
        if cur_used[i] or cur_used[j] or (new_cand is not None
                                          and not new_cand) \
                or (cur_count > 0 and tier_e != cur_tier):
            close()
            if pool_sets is not None:
                new_cand = [k for k in range(len(pool_sets))
                            if key in pool_sets[k]]
        if cur_count == 0:
            cur_alive = member.copy()  # membership as of bin open
            cur_tier = tier_e
        cur_perm[i], cur_perm[j] = j, i
        cur_h[i], cur_h[j] = trace.h[e, 0], trace.h[e, 1]
        cur_used[i] = cur_used[j] = True
        if new_cand is not None:
            cur_cand = new_cand
        event_bin[e] = len(perms)
        cur_count += 1
    close()

    S = len(perms)
    retire = None
    if churn:
        retire = np.zeros((S + 1, n), bool)
        for effect, node in retires:
            retire[min(effect, S), node] = True
    sched = BinnedSchedule(
        perms=np.stack(perms) if perms else np.zeros((0, n), np.int32),
        h=np.stack(hs) if hs else np.zeros((0, n), np.int32),
        mask=np.stack(masks) if masks else np.zeros((0, n), bool),
        event_bin=event_bin,
        pool_idx=np.asarray(pool_ids, np.int32) if pool_sets is not None
        else None,
        kinds=np.asarray(bin_kinds, np.int8) if churn else None,
        alive=np.stack(bin_alive) if churn and bin_alive
        else (np.zeros((0, n), bool) if churn else None),
        retire=retire,
        tiers=np.asarray(bin_tiers, np.int8) if tiers is not None else None,
    )
    return sched.validate()


def engine_inputs(sched: BinnedSchedule, s: int, gossip_impl: str = "gather"):
    """(perm, h, mask) arrays for superstep `s`, in the form the engine's
    `superstep(state, batch, perm, h, rng, mask=...)` expects: the pool
    transport takes the broadcast pool index as `perm` (its switch
    selects the compiled matching) with the bin's participation mask
    gating which of that matching's pairs actually land."""
    n = sched.n_nodes
    if gossip_impl.startswith("ppermute_pool"):
        assert sched.pool_idx is not None, \
            "schedule was not binned with pool=...; cannot drive the pool " \
            "transport"
        perm = np.full((n,), sched.pool_idx[s], np.int32)
    else:
        perm = sched.perms[s]
    return perm, sched.h[s], sched.mask[s]


def stacked_engine_inputs(sched: BinnedSchedule, lo: int = 0,
                          hi: Optional[int] = None,
                          gossip_impl: str = "gather"):
    """[K, n] stacked (perm, h, mask) for supersteps [lo, hi) — the scan
    driver's xs (core/scan.py): row t is exactly `engine_inputs(sched,
    lo + t, gossip_impl)`, so one host->device transfer ships the whole
    chunk's schedule and the steady-state loop touches the host only at
    chunk boundaries."""
    hi = sched.n_supersteps if hi is None else hi
    n = sched.n_nodes
    if sched.kinds is not None and np.any(sched.kinds[lo:hi] != EVENT_MIX):
        raise ValueError(
            "supersteps [%d, %d) contain join bins — the scan driver only "
            "replays gossip supersteps; churn schedules use the per-step "
            "driver" % (lo, hi))
    if gossip_impl.startswith("ppermute_pool"):
        assert sched.pool_idx is not None, \
            "schedule was not binned with pool=...; cannot drive the pool " \
            "transport"
        perm = np.repeat(sched.pool_idx[lo:hi, None], n,
                         axis=1).astype(np.int32)
    else:
        perm = sched.perms[lo:hi]
    return perm, sched.h[lo:hi], sched.mask[lo:hi]
