"""Interaction graphs and the matching samplers (numpy copy of
``repro/core/graph.py``): the same kind, size and seed give the same edge
set, degree and λ₂, and the same seed the same matchings, as the JAX
package.

``random_regular`` carries its own copy of networkx's pairing algorithm
(``networkx.random_regular_graph``, Steger–Wormald) driven by
``random.Random(seed)`` the way networkx wraps an int seed, and a BFS
connectivity check for the reseed loop, so the port needs no networkx.
"""
from __future__ import annotations

import random
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

GRAPH_KINDS = ("complete", "ring", "torus", "hypercube", "random_regular",
               "hierarchical")


@dataclass(frozen=True)
class Graph:
    name: str
    n: int
    edges: np.ndarray          # [m, 2] int32, i < j
    r: int                     # degree (max degree when irregular)
    lambda2: float             # 2nd smallest Laplacian eigenvalue
    degrees: Optional[np.ndarray] = field(default=None, compare=False)
    # per-node degrees; only carried for irregular graphs (None == regular)

    @property
    def m(self) -> int:
        return len(self.edges)

    @property
    def is_regular(self) -> bool:
        return self.degrees is None


def _finalize(name: str, n: int, edge_set, *,
              require_regular: bool = True) -> Graph:
    edges = np.array(sorted({(min(a, b), max(a, b)) for a, b in edge_set
                             if a != b}), np.int32)
    deg = np.zeros(n, np.int64)
    for a, b in edges:
        deg[a] += 1
        deg[b] += 1
    regular = bool((deg == deg[0]).all()) if n else True
    if not regular and require_regular:
        raise ValueError(
            f"{name}: graph not regular (degrees {sorted(set(deg.tolist()))})."
            " The uniform matching sampler assumes an r-regular G; build an"
            " irregular graph with irregular_graph(...)")
    if np.any(deg == 0):
        raise ValueError(f"{name}: isolated node(s) {np.nonzero(deg == 0)[0]}"
                         " — every node needs at least one gossip partner")
    L = np.zeros((n, n))
    L[np.arange(n), np.arange(n)] = deg
    for a, b in edges:
        L[a, b] -= 1
        L[b, a] -= 1
    ev = np.linalg.eigvalsh(L)
    return Graph(name, n, edges, int(deg.max()), float(ev[1]),
                 None if regular else deg)


def irregular_graph(name: str, n: int, edge_set) -> Graph:
    """A heterogeneous (non-regular) interaction graph; carries per-node
    `degrees`."""
    return _finalize(name, n, edge_set, require_regular=False)


def complete(n: int) -> Graph:
    return _finalize("complete", n,
                     [(i, j) for i in range(n) for j in range(i + 1, n)])


def ring(n: int) -> Graph:
    return _finalize("ring", n, [(i, (i + 1) % n) for i in range(n)])


def torus2d(a: int, b: int) -> Graph:
    es = []
    for i in range(a):
        for j in range(b):
            u = i * b + j
            es.append((u, i * b + (j + 1) % b))
            es.append((u, ((i + 1) % a) * b + j))
    return _finalize(f"torus{a}x{b}", a * b, es)


def hypercube(log_n: int) -> Graph:
    n = 1 << log_n
    es = [(u, u ^ (1 << k)) for u in range(n) for k in range(log_n)]
    return _finalize(f"hypercube{log_n}", n, es)


def hierarchical(n: int, n_clusters: int, inter_degree: int = 1) -> Graph:
    """Complete graph inside each of `n_clusters` clusters plus a regular
    inter-cluster ring of `inter_degree` matchings."""
    if n % n_clusters:
        raise ValueError(f"hierarchical: n={n} is not a multiple of "
                         f"n_clusters={n_clusters}")
    m = n // n_clusters
    es = []
    for c in range(n_clusters):
        base = c * m
        es += [(base + i, base + j) for i in range(m) for j in range(i + 1, m)]
    for k in range(inter_degree):
        for c in range(n_clusters):
            nc = (c + 1) % n_clusters
            for i in range(m):
                es.append((c * m + i, nc * m + (i + k) % m))
    return _finalize(f"hier{n_clusters}x{m}", n, es)


def _pairing_edges(d: int, n: int, rng: random.Random) -> set:
    """networkx ``random_regular_graph(d, n, seed)``'s edge set: shuffle
    n*d stubs, pair them off, keep the pairs that are neither loops nor
    repeats and reshuffle the rest until none is left; start over when no
    suitable pair remains. Same calls on `rng` in the same order, so one
    seed gives networkx's graph."""
    if (n * d) % 2 != 0:
        raise ValueError("random_regular: n * d must be even")
    if not 0 <= d < n:
        raise ValueError("random_regular: the 0 <= d < n inequality must "
                         "be satisfied")
    if d == 0:
        return set()

    def suitable(edges, potential_edges):
        if not potential_edges:
            return True
        for s1 in potential_edges:
            for s2 in potential_edges:
                if s1 == s2:
                    break
                if s1 > s2:
                    s1, s2 = s2, s1
                if (s1, s2) not in edges:
                    return True
        return False

    def try_creation():
        edges = set()
        stubs = list(range(n)) * d
        while stubs:
            potential_edges = defaultdict(lambda: 0)
            rng.shuffle(stubs)
            stubiter = iter(stubs)
            for s1, s2 in zip(stubiter, stubiter):
                if s1 > s2:
                    s1, s2 = s2, s1
                if s1 != s2 and ((s1, s2) not in edges):
                    edges.add((s1, s2))
                else:
                    potential_edges[s1] += 1
                    potential_edges[s2] += 1
            if not suitable(edges, potential_edges):
                return None
            stubs = [node for node, potential in potential_edges.items()
                     for _ in range(potential)]
        return edges

    edges = try_creation()
    while edges is None:
        edges = try_creation()
    return edges


def _connected(n: int, edges) -> bool:
    """BFS from node 0 reaches every node (networkx raises on n == 0)."""
    if n == 0:
        raise ValueError("connectivity is undefined for the null graph")
    adj = [[] for _ in range(n)]
    for a, b in edges:
        adj[a].append(b)
        adj[b].append(a)
    seen = {0}
    todo = deque([0])
    while todo:
        for v in adj[todo.popleft()]:
            if v not in seen:
                seen.add(v)
                todo.append(v)
    return len(seen) == n


def random_regular(n: int, r: int, seed: int = 0) -> Graph:
    edges = _pairing_edges(r, n, random.Random(seed))
    if not _connected(n, edges):  # resample until connected (a.s. for r>=3)
        for s in range(seed + 1, seed + 50):
            edges = _pairing_edges(r, n, random.Random(s))
            if _connected(n, edges):
                break
    return _finalize(f"rr{r}", n, list(edges))


def make_graph(kind: str, n: int, *, r: int = 4, seed: int = 0) -> Graph:
    if kind == "complete":
        return complete(n)
    if kind == "ring":
        return ring(n)
    if kind == "torus":
        a = int(np.sqrt(n))
        while n % a:
            a -= 1
        return torus2d(a, n // a)
    if kind == "hypercube":
        log_n = int(np.log2(n))
        if (1 << log_n) != n:
            raise ValueError("hypercube needs power-of-two n")
        return hypercube(log_n)
    if kind == "random_regular":
        return random_regular(n, r, seed)
    if kind == "hierarchical":
        return hierarchical(n, n_clusters=max(2, n // 16))
    raise ValueError(f"unknown graph kind {kind!r}")


def sample_matching(graph: Graph, rng: np.random.Generator,
                    fraction: float = 1.0,
                    dead: "np.ndarray | None" = None) -> np.ndarray:
    """Uniform random (partial) matching of G as an involution perm [n]:
    greedy over a shuffled edge order; `fraction` < 1 keeps that share of
    the pairs; `dead` nodes are never matched."""
    perm = np.arange(graph.n, dtype=np.int32)
    order = rng.permutation(len(graph.edges))
    used = np.zeros(graph.n, bool)
    if dead is not None:
        used |= np.asarray(dead, bool)
    pairs = []
    for e in order:
        a, b = graph.edges[e]
        if not used[a] and not used[b]:
            used[a] = used[b] = True
            pairs.append((a, b))
    if fraction < 1.0 and pairs:
        k = max(1, int(round(fraction * len(pairs))))
        idx = rng.choice(len(pairs), size=k, replace=False)
        pairs = [pairs[i] for i in idx]
    for a, b in pairs:
        perm[a], perm[b] = b, a
    return perm


def sample_weighted_matching(graph: Graph, rng: np.random.Generator,
                             edge_weights: np.ndarray,
                             dead: "np.ndarray | None" = None) -> np.ndarray:
    """Non-uniform (weight-proportional) random matching — the degree- and
    rate-tolerant sampler for heterogeneous graphs and schedules.

    Greedy over a weighted random edge order (Efraimidis–Spirakis keys:
    sorting by u^(1/w) samples without replacement with probability
    proportional to w), so heavier edges enter the matching first — the
    matching-level analogue of the scheduler's weighted partner choice
    (`sched/clocks.py`), usable on irregular graphs where the uniform
    sampler's equal-marginal argument (which needs regularity) breaks.
    With uniform weights this reduces to `sample_matching`'s distribution.
    The keys and their sort stay numpy, as in the reference, so ties break
    in the same order.
    """
    w = np.asarray(edge_weights, np.float64)
    if w.shape != (graph.m,):
        raise ValueError(f"edge_weights shape {w.shape} != ({graph.m},): one"
                         " weight per graph edge (graph.edges order)")
    if not np.all(np.isfinite(w)) or np.any(w < 0):
        raise ValueError("edge_weights must be finite and >= 0")
    if w.sum() <= 0:
        raise ValueError("edge_weights sum to 0 — no edge can be sampled")
    keys = np.where(w > 0, rng.random(graph.m) ** (1.0 / np.maximum(w, 1e-300)),
                    -1.0)
    order = np.argsort(-keys)
    perm = np.arange(graph.n, dtype=np.int32)
    used = np.zeros(graph.n, bool)
    if dead is not None:
        used |= np.asarray(dead, bool)
    for e in order:
        if keys[e] < 0:        # zero-weight edges never match
            break
        a, b = graph.edges[e]
        if not used[a] and not used[b]:
            used[a] = used[b] = True
            perm[a], perm[b] = b, a
    return perm
