"""Deterministic synthetic LM data (numpy copy of
``repro/data/synthetic.py``): tokens follow a hidden bigram Markov chain,
fully determined by (seed, node, step), so both packages draw identical
batches. ``non_iid_alpha`` skews each node's mixture over the hidden chains
(a Dirichlet draw per node, the non-iid setting of Theorem 4.2)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    seed: int = 0
    # non-iid: Dirichlet-mixture of k hidden chains per node (alpha<inf skews)
    non_iid_alpha: Optional[float] = None
    n_chains: int = 8
    branch: int = 4   # out-degree of the bigram chain (lower = easier)


class SyntheticLMDataset:
    """Host-side generator producing per-node token batches."""

    def __init__(self, cfg: DataConfig, n_nodes: int):
        self.cfg = cfg
        self.n_nodes = n_nodes
        rng = np.random.default_rng(cfg.seed)
        v, b = cfg.vocab_size, cfg.branch
        self.succ = rng.integers(0, v, size=(cfg.n_chains, v, b), dtype=np.int64)
        # the mixture is drawn AFTER the tables, from the same generator,
        # as the JAX package does: either order change moves both
        if cfg.non_iid_alpha is not None:
            self.mix = rng.dirichlet([cfg.non_iid_alpha] * cfg.n_chains,
                                     size=n_nodes)
        else:
            self.mix = np.full((n_nodes, cfg.n_chains), 1.0 / cfg.n_chains)

    def batch(self, node: int, step: int, batch_size: int) -> np.ndarray:
        """[batch, seq_len+1] tokens; inputs = [:, :-1], targets = [:, 1:]."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + node * 7919 + step) % (2**63))
        chains = rng.choice(cfg.n_chains, size=batch_size, p=self.mix[node])
        out = np.empty((batch_size, cfg.seq_len + 1), np.int64)
        out[:, 0] = rng.integers(0, cfg.vocab_size, size=batch_size)
        choices = rng.integers(0, cfg.branch, size=(batch_size, cfg.seq_len))
        for t in range(cfg.seq_len):
            out[:, t + 1] = self.succ[chains, out[:, t], choices[:, t]]
        return out


def make_node_batches(ds: SyntheticLMDataset, step: int,
                      per_node_batch: int) -> dict:
    """Stacked [n_nodes, per_node_batch, S] tokens/targets as numpy."""
    toks = np.stack([ds.batch(i, step, per_node_batch)
                     for i in range(ds.n_nodes)])
    return {"tokens": toks[..., :-1].astype(np.int32),
            "targets": toks[..., 1:].astype(np.int32)}
