"""Serving metrics (copy of ``repro/serve/metrics.py``; pure Python).

Collected host-side by the engine, zero device traffic:

* throughput       — committed tokens / serving wall time;
* in-flight token latency — the gap between a lane's consecutive token
  COMMITS (p50/p99 over the run). Gap-based on purpose: a decode-step
  wall time would miss the head-of-line stall a blocking admission
  inserts BETWEEN dispatches, which is exactly what chunked prefill
  removes;
* TTFT             — submit -> first committed token, per sequence
  (prefill cost lives HERE, not in the decode latency series — recording
  blocking-prefill wall time as a decode-step latency was a bug);
* queue wait       — submit -> admission, per sequence (the other half
  of TTFT: scheduling delay vs prefill compute);
* queue depth      — sampled at every admission decision, plus the reject
  counter (bounded queue = the backpressure signal);
* paged-KV pool    — pages in use (peak), admissions deferred on pool
  exhaustion, and pool vs dense-bank device bytes (serve/paged.py);
* freshness        — time-to-fresh-model: checkpoint-lands (the source's
  ``t_landed``) -> first token COMMITTED from a sequence admitted under
  that generation. The serving-side half of the paper's asynchrony story:
  how long until users see the swarm's newest average.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


def percentile(xs: List[float], p: float) -> float:
    """Nearest-rank percentile; 0.0 on empty input."""
    if not xs:
        return 0.0
    s = sorted(xs)
    k = min(len(s) - 1, max(0, int(round(p / 100.0 * (len(s) - 1)))))
    return s[k]


@dataclass
class ServeMetrics:
    token_latencies_s: List[float] = field(default_factory=list)
    ttft_s: List[float] = field(default_factory=list)
    queue_wait_s: List[float] = field(default_factory=list)
    step_times_s: List[float] = field(default_factory=list)
    queue_depths: List[int] = field(default_factory=list)
    tokens_committed: int = 0
    rejected: int = 0
    submitted: int = 0
    completed: int = 0
    dropped_in_flight: int = 0          # must stay 0: the swap contract
    # distinct shape signatures dispatched to the decode / chunk step,
    # minus one: what jit would compile again (serve/engine.py)
    decode_cache_misses: int = 0        # must stay 0 after warmup
    prefill_cache_misses: int = 0       # chunked prefill: must stay 0 too
    swaps_adopted: int = 0
    # paged KV pool (all 0 when the engine runs dense)
    pool_deferrals: int = 0             # admissions deferred: no pages
    pool_pages_peak: int = 0
    kv_pool_pages: int = 0
    kv_bytes: int = 0                   # device bytes of the KV layout
    kv_dense_bytes: int = 0             # what the dense bank would cost
    t_start: Optional[float] = None
    t_end: Optional[float] = None
    # gen -> (t_landed, t_first_token_committed)
    _fresh_landed: Dict[int, float] = field(default_factory=dict)
    _fresh_first: Dict[int, float] = field(default_factory=dict)

    # -- recording ---------------------------------------------------------

    def record_step(self, dt_s: float, n_tokens: int):
        """Wall time of one decode dispatch (diagnostic series only —
        per-token latency is commit-gap based, see module docstring)."""
        if n_tokens > 0:
            self.step_times_s.append(dt_s)

    def record_token_gap(self, dt_s: float):
        self.token_latencies_s.append(dt_s)

    def record_ttft(self, dt_s: float):
        self.ttft_s.append(dt_s)

    def record_queue_wait(self, dt_s: float):
        self.queue_wait_s.append(dt_s)

    def record_queue(self, depth: int):
        self.queue_depths.append(depth)

    def record_pool(self, pages_in_use: int):
        self.pool_pages_peak = max(self.pool_pages_peak, pages_in_use)

    def record_adoption(self, gen: int, t_landed: float):
        self.swaps_adopted += 1
        self._fresh_landed[gen] = t_landed

    def record_first_token(self, gen: int, t: float):
        self._fresh_first.setdefault(gen, t)

    # -- summary -----------------------------------------------------------

    def freshness_s(self) -> List[float]:
        """time-to-fresh-model per adopted generation (landed -> first
        token committed from it); generations still waiting are omitted."""
        return [self._fresh_first[g] - t for g, t in
                self._fresh_landed.items() if g in self._fresh_first]

    def summary(self) -> dict:
        wall = (self.t_end - self.t_start) \
            if self.t_start is not None and self.t_end is not None else 0.0
        fresh = self.freshness_s()
        lat_ms = [1e3 * x for x in self.token_latencies_s]
        ttft_ms = [1e3 * x for x in self.ttft_s]
        qw_ms = [1e3 * x for x in self.queue_wait_s]
        return {
            "tokens": self.tokens_committed,
            "wall_s": round(wall, 4),
            "tokens_per_s": round(self.tokens_committed / wall, 2)
            if wall > 0 else 0.0,
            "latency_p50_ms": round(percentile(lat_ms, 50), 3),
            "latency_p99_ms": round(percentile(lat_ms, 99), 3),
            "ttft_p50_ms": round(percentile(ttft_ms, 50), 3),
            "ttft_p99_ms": round(percentile(ttft_ms, 99), 3),
            "queue_wait_p50_ms": round(percentile(qw_ms, 50), 3),
            "queue_wait_p99_ms": round(percentile(qw_ms, 99), 3),
            "queue_depth_max": max(self.queue_depths, default=0),
            "queue_depth_mean": round(
                sum(self.queue_depths) / len(self.queue_depths), 3)
            if self.queue_depths else 0.0,
            "submitted": self.submitted,
            "completed": self.completed,
            "rejected": self.rejected,
            "dropped_in_flight": self.dropped_in_flight,
            "decode_cache_misses": self.decode_cache_misses,
            "prefill_cache_misses": self.prefill_cache_misses,
            "pool_deferrals": self.pool_deferrals,
            "kv_pool_pages": self.kv_pool_pages,
            "pool_pages_peak": self.pool_pages_peak,
            "kv_bytes": self.kv_bytes,
            "kv_dense_bytes": self.kv_dense_bytes,
            "swaps_adopted": self.swaps_adopted,
            "time_to_fresh_s": [round(x, 4) for x in fresh],
            "time_to_fresh_max_s": round(max(fresh), 4) if fresh else None,
        }
