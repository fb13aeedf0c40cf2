"""Hierarchical two-tier gossip topology (numpy copy of
``repro/core/hier.py``).

The paper's headline deployment is a supercomputer where intra-node links
are an order of magnitude faster than inter-node links. This
module models that as a two-level node axis: `n_nodes` split into groups of
`group_size` (G). Most interactions are *intra-group* — a matching sampled
inside one group's complete graph, exchanged over the fast tier — and a
configured fraction `inter_frac` of events instead run an *inter-group*
exchange: groups are matched pairwise and every node swaps with its
lane-aligned peer (node c*G+i partners with c'*G+i), one payload over the
slow tier per node exactly like any other matching.

Everything downstream treats a hier event as an ordinary involution perm
plus a tier label (0 = intra, 1 = inter): the engine's exchange math is
unchanged, and only the scheduler bridge (tier-pure bins) and the cost
model (per-tier link bandwidth) read the label.

Degenerate contract (held bitwise against the reference by the port's
tests): `hier:G` with a
single group (G == n_nodes) reproduces the flat path EXACTLY — the intra
graph's sorted edge list equals `complete(n)`'s, `sample_event` draws no
tier coin, and the matching pool consumes the same rng stream as
`make_matching_pool`, so perms, pool indices and therefore trajectories are
bitwise identical to a run with no topology at all.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.graph import Graph, _finalize, sample_matching

INTRA, INTER = 0, 1
TIER_NAMES = ("intra", "inter")
DEFAULT_INTER_FRAC = 0.25


@dataclass(frozen=True)
class HierTopology:
    """Groups of `group_size` nodes; `inter_frac` of events cross groups."""
    n_nodes: int
    group_size: int
    inter_frac: float = DEFAULT_INTER_FRAC

    def __post_init__(self):
        n, g = self.n_nodes, self.group_size
        if not (2 <= g <= n):
            raise ValueError(f"hier group size {g} must be in [2, n={n}]")
        if n % g:
            raise ValueError(f"hier: n_nodes={n} not divisible by G={g}")
        if not (0.0 < self.inter_frac < 1.0) and self.n_groups > 1:
            raise ValueError(f"hier inter_frac={self.inter_frac} must be in"
                             " (0, 1) when there is more than one group")

    @property
    def n_groups(self) -> int:
        return self.n_nodes // self.group_size

    @property
    def spec(self) -> str:
        return f"hier:{self.group_size}:{self.inter_frac:g}"

    def group_of(self, node: int) -> int:
        return node // self.group_size

    # -- graphs -------------------------------------------------------------

    def intra_graph(self) -> Graph:
        """Disjoint union of per-group complete graphs. For a single group
        the sorted edge list is identical to `complete(n)`'s — the root of
        the degenerate bitwise contract."""
        g = self.group_size
        es = []
        for c in range(self.n_groups):
            base = c * g
            es += [(base + i, base + j)
                   for i in range(g) for j in range(i + 1, g)]
        return _finalize(f"hier_intra{self.n_groups}x{g}", self.n_nodes, es)

    def union_graph(self) -> Graph:
        """Intra edges plus every lane-aligned cross-group pair — the
        support of all hier events, handed to PoissonClocks so the trace
        generator can realize both tiers."""
        g = self.group_size
        es = []
        for c in range(self.n_groups):
            base = c * g
            es += [(base + i, base + j)
                   for i in range(g) for j in range(i + 1, g)]
        for c in range(self.n_groups):
            for c2 in range(c + 1, self.n_groups):
                es += [(c * g + i, c2 * g + i) for i in range(g)]
        return _finalize(f"hier{self.n_groups}x{g}", self.n_nodes, es)

    def edge_weights(self) -> np.ndarray:
        """Per-edge weights over `union_graph().edges` (same order) making a
        Poisson-clock partner draw land on an inter edge with probability
        `inter_frac`: each node has (G-1) intra edges at weight 1 and
        (n_groups-1) inter edges sharing total mass
        inter_frac/(1-inter_frac)·(G-1)."""
        graph = self.union_graph()
        tiers = self.tier_of_pairs(graph.edges)
        w = np.ones(graph.m, np.float64)
        if self.n_groups > 1:
            mass = self.inter_frac / (1.0 - self.inter_frac) \
                * (self.group_size - 1)
            w[tiers == INTER] = mass / (self.n_groups - 1)
        return w

    # -- event sampling -----------------------------------------------------

    def tier_of_pairs(self, pairs) -> np.ndarray:
        """[m, 2] node pairs -> int tier per pair (0 intra / 1 inter)."""
        p = np.asarray(pairs)
        if p.size == 0:
            return np.zeros((0,), np.int64)
        g = self.group_size
        return (p[..., 0] // g != p[..., 1] // g).astype(np.int64)

    def inter_group_perm(self, rng: np.random.Generator) -> np.ndarray:
        """One inter-group event: match groups pairwise (uniform matching on
        the complete group graph), then expand lane-aligned — node c*G+i
        partners with partner(c)*G+i, so the perm is a full involution and
        the exchange is ONE payload per node over the slow tier."""
        assert self.n_groups > 1, "inter event needs more than one group"
        gperm = sample_matching(_group_complete(self.n_groups), rng)
        g = self.group_size
        perm = np.arange(self.n_nodes, dtype=np.int32)
        for c in range(self.n_groups):
            base, pbase = c * g, int(gperm[c]) * g
            perm[base:base + g] = np.arange(pbase, pbase + g, dtype=np.int32)
        return perm

    def sample_event(self, rng: np.random.Generator
                     ) -> Tuple[np.ndarray, int]:
        """Sample one gossip event -> (involution perm [n], tier). With a
        single group no tier coin is drawn and the call reduces to
        `sample_matching(complete(n), rng)` — bitwise-identical rng
        consumption to the flat path."""
        if self.n_groups == 1:
            return sample_matching(self.intra_graph(), rng), INTRA
        if rng.random() < self.inter_frac:
            return self.inter_group_perm(rng), INTER
        return sample_matching(self.intra_graph(), rng), INTRA

    # -- matching pools (ppermute_pool transport) ---------------------------

    def inter_pool_size(self, pool_size: int) -> int:
        """Number of inter-group perms appended to a size-`pool_size` intra
        pool; 0 for the degenerate single group."""
        if self.n_groups == 1:
            return 0
        return max(1, int(round(pool_size * self.inter_frac)))

    def matching_pool(self, pool_size: int, seed: int):
        """Static pool: `pool_size` intra matchings followed by
        `inter_pool_size` inter perms. The intra prefix consumes the SAME
        rng stream as `make_matching_pool(intra_graph, pool_size, seed)`,
        so a single-group pool is element-wise identical to the flat one.
        Returns (pool, tiers[int per entry])."""
        rng = np.random.default_rng(seed)
        graph = self.intra_graph()
        pool = [sample_matching(graph, rng) for _ in range(pool_size)]
        tiers = [INTRA] * pool_size
        for _ in range(self.inter_pool_size(pool_size)):
            pool.append(self.inter_group_perm(rng))
            tiers.append(INTER)
        return pool, np.asarray(tiers, np.int64)

    def sample_pool_index(self, rng: np.random.Generator,
                          pool_size: int) -> Tuple[int, int]:
        """Draw (pool index, tier) for one event against a
        `matching_pool(pool_size, ...)` pool. Degenerate single group draws
        exactly `rng.integers(pool_size)` — the flat driver's call."""
        if self.n_groups == 1:
            return int(rng.integers(pool_size)), INTRA
        if rng.random() < self.inter_frac:
            q = self.inter_pool_size(pool_size)
            return pool_size + int(rng.integers(q)), INTER
        return int(rng.integers(pool_size)), INTRA


def _group_complete(n_groups: int) -> Graph:
    from repro_torch.core.graph import complete
    return complete(n_groups)


def parse_topology(spec: Optional[str],
                   n_nodes: int) -> Optional[HierTopology]:
    """Parse `--topology`: None/''/'flat' -> None (the flat
    single-tier path), 'hier:G' or 'hier:G:inter_frac' -> HierTopology."""
    if spec is None:
        return None
    s = str(spec).strip()
    if s in ("", "flat", "none"):
        return None
    parts = s.split(":")
    if parts[0] != "hier" or len(parts) not in (2, 3):
        raise ValueError(
            f"unknown topology spec {spec!r}: expected 'flat' or"
            " 'hier:G[:inter_frac]' (e.g. hier:4 or hier:32:0.1)")
    g = int(parts[1])
    frac = float(parts[2]) if len(parts) == 3 else DEFAULT_INTER_FRAC
    return HierTopology(n_nodes=n_nodes, group_size=g, inter_frac=frac)
