"""Interaction graphs and the uniform matching sampler (numpy copy of the
parts of ``repro/core/graph.py`` the slice uses): the same seed gives the
same matchings as the JAX package."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class Graph:
    name: str
    n: int
    edges: np.ndarray          # [m, 2] int32, i < j
    r: int                     # degree (max degree when irregular)
    lambda2: float             # 2nd smallest Laplacian eigenvalue
    degrees: Optional[np.ndarray] = field(default=None, compare=False)

    @property
    def m(self) -> int:
        return len(self.edges)


def _finalize(name: str, n: int, edge_set) -> Graph:
    edges = np.array(sorted({(min(a, b), max(a, b)) for a, b in edge_set
                             if a != b}), np.int32)
    deg = np.zeros(n, np.int64)
    for a, b in edges:
        deg[a] += 1
        deg[b] += 1
    if not (deg == deg[0]).all():
        raise ValueError(f"{name}: graph not regular")
    if np.any(deg == 0):
        raise ValueError(f"{name}: isolated node(s)")
    L = np.zeros((n, n))
    L[np.arange(n), np.arange(n)] = deg
    for a, b in edges:
        L[a, b] -= 1
        L[b, a] -= 1
    ev = np.linalg.eigvalsh(L)
    return Graph(name, n, edges, int(deg.max()), float(ev[1]))


def complete(n: int) -> Graph:
    return _finalize("complete", n,
                     [(i, j) for i in range(n) for j in range(i + 1, n)])


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
