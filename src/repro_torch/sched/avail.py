"""Availability profiles and elastic membership (join / leave / day-night);
numpy copy of ``repro/sched/avail.py``, draw for draw.

The paper's process assumes a fixed node set; the north-star deployment —
millions of unreliable user devices — does not. This module models the
difference as an *availability state layer* on top of the Poisson clocks:

  window availability — a node that is "down" (off-duty in its day/night
      cycle, or outside one of its trace-file uptime intervals) neither
      rings nor accepts partners. Candidate events touching it are thinned,
      exactly like the transient-failure injection in `clocks.py`, so the
      surviving process stays an exact Poisson construction.

  join — a node with `join_time > 0` is not a member at t=0. At the first
      clock ring at which its availability window is open AND it has an
      alive neighbor, it joins: the scheduler emits an `EVENT_JOIN`
      (joiner, donor) event and the engine bootstraps the joiner from the
      donor's packed payload (one collective on the flat buffer — see
      `core/swarm.make_join_step`).

  leave — a node with finite `leave_time` leaves PERMANENTLY at that time:
      the scheduler emits `EVENT_LEAVE` and the engine retires the node's
      error-feedback residual (`core/swarm.retire_nodes`); its parameters
      are frozen and it is never matched again.

Two profile kinds (`parse_avail` grammar, CLI `--avail`; the port reads
no environment default):

  day_night:period=P,duty=D[,join=F:T0:T1][,leave=F:T0:T1][,seed=S]
      Each node is up for the first D·P of every period P, with a
      seed-deterministic per-node phase uniform in [0, P) (so the swarm
      thins gradually rather than synchronously). `join=F:T0:T1` makes a
      fraction F of nodes late joiners with eligibility times uniform in
      [T0, T1]; `leave=F:T0:T1` likewise for permanent leavers.

  trace:FILE
      FLGo-style availability-from-data: whitespace-separated rows
      `node t_start t_end` (t_end may be `inf`), '#' comments and blank
      lines ignored. A node's first interval start > 0 is a join; a finite
      last interval end is a permanent leave. Malformed rows raise
      ValueError naming the line.

The model is checkpointable: `state_dict()` embeds everything (including
parsed trace intervals, so resume does not need the original file) and
`from_state` reconstructs bit-exactly.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

# Event kinds carried by Trace.kinds ([E] int8) when churn is enabled.
EVENT_MIX = 0    # ordinary pairwise gossip interaction (i, j)
EVENT_JOIN = 1   # (joiner, donor): joiner bootstraps from donor's payload
EVENT_LEAVE = 2  # (i, i): node i leaves permanently


class AvailabilityModel:
    """Per-node availability windows + join/leave times.

    Construct via `parse_avail` (spec string) or `from_state` (checkpoint).
    All per-node arrays have length n:

      join_time  [n] float64 — node is eligible to join from this time on
                  (<= 0 means founding member). The actual join happens at
                  the first clock ring with the window open and a donor
                  available, so this is a lower bound.
      leave_time [n] float64 — node leaves permanently at this time
                  (np.inf means never).
    """

    def __init__(self, kind: str, n: int, join_time: np.ndarray,
                 leave_time: np.ndarray, *,
                 period: float = 0.0, duty: float = 1.0,
                 phase: Optional[np.ndarray] = None,
                 intervals: Optional[List[np.ndarray]] = None,
                 spec: str = ""):
        if kind not in ("day_night", "trace"):
            raise ValueError(f"unknown availability kind {kind!r}")
        self.kind = kind
        self.n = int(n)
        self.spec = spec
        self.join_time = np.asarray(join_time, np.float64)
        self.leave_time = np.asarray(leave_time, np.float64)
        if self.join_time.shape != (n,) or self.leave_time.shape != (n,):
            raise ValueError("join_time/leave_time must have shape (n,)")
        if np.any(self.leave_time <= np.maximum(self.join_time, 0.0)):
            raise ValueError("each leave_time must exceed the join_time")
        self.period = float(period)
        self.duty = float(duty)
        self.phase = (np.zeros(n, np.float64) if phase is None
                      else np.asarray(phase, np.float64))
        # trace kind: per-node [k, 2] sorted non-overlapping up-intervals
        self.intervals = intervals
        if kind == "trace" and intervals is None:
            raise ValueError("trace availability needs intervals")
        # elastic membership needs a viable swarm at t=0: at least two
        # founding members that never leave (pairwise gossip + join donors)
        core = (self.join_time <= 0.0) & ~np.isfinite(self.leave_time)
        if core.sum() < 2:
            raise ValueError(
                "availability profile must keep >= 2 founding members that "
                f"never leave (got {int(core.sum())}) — lower the join/leave "
                "fractions or fix the trace file")

    # -- window queries ----------------------------------------------------

    def window_up(self, i: int, t: float) -> bool:
        """Is node i's availability window open at time t? (Membership —
        joined yet / already left — is layered on top by the clocks.)"""
        if t < self.join_time[i] or t >= self.leave_time[i]:
            return False
        if self.kind == "day_night":
            if self.duty >= 1.0 or self.period <= 0.0:
                return True
            return ((t + self.phase[i]) % self.period) < self.duty * self.period
        iv = self.intervals[i]
        k = np.searchsorted(iv[:, 0], t, side="right") - 1
        return k >= 0 and t < iv[k, 1]

    def uptime(self, i: int, t0: float, t1: float) -> float:
        """Measure of node i's up-time within [t0, t1] — used for h accrual
        so a node does not get credited local steps for hours it was off."""
        if t1 <= t0:
            return 0.0
        t0 = max(t0, float(max(self.join_time[i], 0.0)))
        t1 = min(t1, float(self.leave_time[i]))
        if t1 <= t0:
            return 0.0
        if self.kind == "day_night":
            if self.duty >= 1.0 or self.period <= 0.0:
                return t1 - t0
            P, up = self.period, self.duty * self.period
            a, b = t0 + self.phase[i], t1 + self.phase[i]

            def cum(x: float) -> float:  # up-time in [0, x)
                full, frac = divmod(x, P)
                return full * up + min(frac, up)
            return cum(b) - cum(a)
        total = 0.0
        for s, e in self.intervals[i]:
            lo, hi = max(t0, float(s)), min(t1, float(e))
            if hi > lo:
                total += hi - lo
        return total

    def duty_cycle(self, i: int) -> float:
        """Long-run up fraction of node i's availability window (within its
        membership lifetime); analytic for day_night, measured for trace."""
        if self.kind == "day_night":
            return min(self.duty, 1.0)
        iv = self.intervals[i]
        lo = float(max(self.join_time[i], 0.0))
        hi = float(self.leave_time[i])
        if not np.isfinite(hi):
            hi = max(float(iv[-1, 0]) + self.period if self.period > 0
                     else float(iv[-1, 0]) + 1.0,
                     lo + 1.0)
        span = hi - lo
        return self.uptime(i, lo, hi) / span if span > 0 else 1.0

    # -- checkpointable state ---------------------------------------------

    def state_dict(self) -> Dict:
        d = {
            "kind": self.kind, "n": self.n, "spec": self.spec,
            "join_time": [None if not np.isfinite(x) else float(x)
                          for x in self.join_time],
            "leave_time": [None if not np.isfinite(x) else float(x)
                           for x in self.leave_time],
            "period": self.period, "duty": self.duty,
            "phase": self.phase.tolist(),
        }
        if self.intervals is not None:
            d["intervals"] = [
                [[float(s), None if not np.isfinite(e) else float(e)]
                 for s, e in iv] for iv in self.intervals]
        return d

    @classmethod
    def from_state(cls, state: Dict) -> "AvailabilityModel":
        def arr(xs):
            return np.asarray([np.inf if x is None else x for x in xs],
                              np.float64)
        intervals = None
        if state.get("intervals") is not None:
            intervals = [arr([v for row in iv for v in row]).reshape(-1, 2)
                         for iv in state["intervals"]]
        return cls(state["kind"], int(state["n"]), arr(state["join_time"]),
                   arr(state["leave_time"]), period=float(state["period"]),
                   duty=float(state["duty"]),
                   phase=np.asarray(state["phase"], np.float64),
                   intervals=intervals, spec=state.get("spec", ""))


def _parse_frac_window(val: str, what: str, spec: str):
    parts = val.split(":")
    if len(parts) != 3:
        raise ValueError(
            f"--avail {spec!r}: {what} must be FRACTION:T0:T1, got {val!r}")
    try:
        f, t0, t1 = float(parts[0]), float(parts[1]), float(parts[2])
    except ValueError:
        raise ValueError(
            f"--avail {spec!r}: {what} fields must be numbers, got {val!r}")
    if not 0.0 <= f < 1.0 or t0 < 0 or t1 < t0:
        raise ValueError(
            f"--avail {spec!r}: {what} needs 0<=F<1 and 0<=T0<=T1")
    return f, t0, t1


def _parse_day_night(body: str, n: int, seed: int, spec: str
                     ) -> AvailabilityModel:
    kv = {}
    for field in filter(None, body.split(",")):
        if "=" not in field:
            raise ValueError(
                f"--avail {spec!r}: expected key=value fields, got {field!r}")
        k, v = field.split("=", 1)
        kv[k.strip()] = v.strip()
    unknown = set(kv) - {"period", "duty", "join", "leave", "seed"}
    if unknown:
        raise ValueError(f"--avail {spec!r}: unknown fields {sorted(unknown)}")
    period = float(kv.get("period", 24.0))
    duty = float(kv.get("duty", 0.75))
    aseed = int(kv.get("seed", seed))
    if period <= 0 or not 0.0 < duty <= 1.0:
        raise ValueError(
            f"--avail {spec!r}: need period>0 and 0<duty<=1")
    rng = np.random.default_rng(aseed)
    phase = rng.uniform(0.0, period, size=n)
    join_time = np.zeros(n, np.float64)
    leave_time = np.full(n, np.inf)
    order = rng.permutation(n)  # one seeded order assigns both roles
    if "join" in kv:
        f, t0, t1 = _parse_frac_window(kv["join"], "join", spec)
        k = int(round(f * n))
        joiners = order[:k]
        join_time[joiners] = rng.uniform(t0, t1, size=k)
    else:
        k = 0
    if "leave" in kv:
        f, t0, t1 = _parse_frac_window(kv["leave"], "leave", spec)
        m = int(round(f * n))
        # leavers drawn from the tail of the same order, disjoint from the
        # joiners when possible; a joiner-leaver gets leave > join + period
        leavers = order[max(k, n - m):]
        if len(leavers) < m:
            leavers = order[n - m:]
        leave_time[leavers] = rng.uniform(t0, t1, size=len(leavers))
        leave_time = np.maximum(
            leave_time, np.where(join_time > 0, join_time + period, 0.0))
    return AvailabilityModel("day_night", n, join_time, leave_time,
                             period=period, duty=duty, phase=phase, spec=spec)


def _parse_trace_file(path: str, n: int, spec: str) -> AvailabilityModel:
    rows: List[List] = []
    try:
        with open(path) as fh:
            lines = fh.readlines()
    except OSError as e:
        raise ValueError(f"--avail {spec!r}: cannot read {path}: {e}")
    for lineno, raw in enumerate(lines, 1):
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        cols = line.split()
        if len(cols) != 3:
            raise ValueError(
                f"{path}:{lineno}: expected 'node t_start t_end' "
                f"(3 columns), got {len(cols)}: {raw.strip()!r}")
        try:
            node = int(cols[0])
        except ValueError:
            raise ValueError(
                f"{path}:{lineno}: node must be an integer, got {cols[0]!r}")
        if not 0 <= node < n:
            raise ValueError(
                f"{path}:{lineno}: node {node} out of range [0, {n})")
        try:
            t0 = float(cols[1])
            t1 = np.inf if cols[2].lower() in ("inf", "+inf") \
                else float(cols[2])
        except ValueError:
            raise ValueError(
                f"{path}:{lineno}: t_start/t_end must be numbers, "
                f"got {cols[1]!r} {cols[2]!r}")
        if t0 < 0 or t1 <= t0:
            raise ValueError(
                f"{path}:{lineno}: need 0 <= t_start < t_end, "
                f"got [{t0}, {t1})")
        rows.append([node, t0, t1, lineno])
    seen = {r[0] for r in rows}
    missing = sorted(set(range(n)) - seen)
    if missing:
        raise ValueError(
            f"{path}: no availability rows for nodes {missing} "
            f"(every node 0..{n - 1} needs at least one interval)")
    intervals: List[np.ndarray] = []
    join_time = np.zeros(n, np.float64)
    leave_time = np.full(n, np.inf)
    for i in range(n):
        ivs = sorted((r for r in rows if r[0] == i), key=lambda r: r[1])
        for a, b in zip(ivs, ivs[1:]):
            if b[1] < a[2]:
                raise ValueError(
                    f"{path}:{b[3]}: node {i} interval [{b[1]}, {b[2]}) "
                    f"overlaps [{a[1]}, {a[2]}) from line {a[3]}")
        iv = np.asarray([[r[1], r[2]] for r in ivs], np.float64)
        intervals.append(iv)
        join_time[i] = iv[0, 0]
        leave_time[i] = iv[-1, 1]  # inf if the last interval never closes
    return AvailabilityModel("trace", n, join_time, leave_time,
                             intervals=intervals, spec=spec)


def parse_avail(spec: str, n: int, seed: int = 0) -> AvailabilityModel:
    """Parse an `--avail` spec into an AvailabilityModel (see module doc)."""
    if ":" not in spec:
        raise ValueError(
            f"--avail {spec!r}: expected 'day_night:key=value,...' "
            "or 'trace:FILE'")
    kind, body = spec.split(":", 1)
    if kind == "day_night":
        return _parse_day_night(body, n, seed, spec)
    if kind == "trace":
        return _parse_trace_file(body, n, spec)
    raise ValueError(
        f"--avail {spec!r}: unknown kind {kind!r} (day_night | trace)")
