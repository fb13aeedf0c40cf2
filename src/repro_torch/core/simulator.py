"""Exact sequential simulator of Algorithms 1 & 2 (+ Extension 3): the
port's own copy of ``repro/core/simulator.py``, numpy only, drawing from
each generator in the reference's order, so the same seeds give the same
bits.

This is the paper's *actual* stochastic process: one interaction per step —
an edge of G sampled uniformly at random, geometric (or fixed) local step
counts, optional stale (non-blocking) reads and modular quantization. Used
to validate the theory (Γ_t boundedness, Lemma F.3; convergence of
‖∇f(μ_t)‖², Thm 4.1/4.2) on small objectives where the constants can be
checked numerically.

Models are flat vectors [n, d] (numpy); the gradient oracle is any callable
grad_fn(x, node, rng) -> g with E[g] = ∇f_node(x).

`run_superstep_oracle` additionally replays the SPMD engine's synchronous
superstep semantics (all nodes step, one matching per superstep, optional
depth-1 non-blocking staleness) — the reference trajectory for the
simulator↔engine parity tests.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from repro_torch.core.graph import Graph


@dataclass
class SimConfig:
    H: float = 2.0
    h_mode: str = "geometric"    # geometric | fixed
    eta: float = 0.01
    nonblocking: bool = False
    quantize: bool = False
    quant_bits: int = 8
    quant_resolution: float = 1e-3
    seed: int = 0


@dataclass
class SimTrace:
    gamma: List[float] = field(default_factory=list)
    grad_norm_sq: List[float] = field(default_factory=list)
    loss: List[float] = field(default_factory=list)
    quant_failures: int = 0
    bits_sent: int = 0


def _quantize_modular(x, y, resolution, bits, rng):
    """Encode x at fixed resolution; decode against y. Returns (x_hat, failed)."""
    levels = 1 << bits
    half = levels // 2
    s = resolution
    q = np.floor(x / s + rng.uniform(size=x.shape)) % levels
    qy = np.round(y / s)
    diff = (q - qy) % levels
    wrapped = np.where(diff >= half, diff - levels, diff)
    x_hat = (qy + wrapped) * s
    failed = np.max(np.abs(x - y)) >= half * s  # distance criterion violated
    return x_hat, bool(failed)


def run_simulation(graph: Graph, x0: np.ndarray, grad_fn: Callable,
                   cfg: SimConfig, T: int,
                   loss_fn: Optional[Callable] = None,
                   grad_of_mean_fn: Optional[Callable] = None,
                   record_every: int = 1) -> SimTrace:
    """Run T sequential interactions; x0: [n, d] initial models."""
    rng = np.random.default_rng(cfg.seed)
    n = graph.n
    X = x0.astype(np.float64).copy()
    # comm copies for the non-blocking variant (value at last averaging)
    Y = X.copy()
    trace = SimTrace()

    def local_steps(i):
        if cfg.h_mode == "fixed":
            h = int(round(cfg.H))
        else:
            h = int(rng.geometric(1.0 / cfg.H))
        for _ in range(h):
            X[i] -= cfg.eta * grad_fn(X[i], i, rng)

    for t in range(T):
        e = graph.edges[rng.integers(len(graph.edges))]
        i, j = int(e[0]), int(e[1])
        if cfg.nonblocking:
            # Algorithm 2: average pre-local-step comm copies, then apply
            # each node's fresh local delta on top.
            Si, Sj = X[i].copy(), X[j].copy()
            local_steps(i)
            local_steps(j)
            di, dj = X[i] - Si, X[j] - Sj
            read_j, read_i = Y[j], Y[i]      # stale reads
            if cfg.quantize:
                read_j, f1 = _quantize_modular(Y[j], Si, cfg.quant_resolution,
                                               cfg.quant_bits, rng)
                read_i, f2 = _quantize_modular(Y[i], Sj, cfg.quant_resolution,
                                               cfg.quant_bits, rng)
                trace.quant_failures += f1 + f2
                trace.bits_sent += 2 * cfg.quant_bits * X.shape[1]
            else:
                trace.bits_sent += 2 * 32 * X.shape[1]
            X[i] = (Si + read_j) / 2 + di
            X[j] = (Sj + read_i) / 2 + dj
            Y[i] = (Si + read_j) / 2
            Y[j] = (Sj + read_i) / 2
        else:
            # Algorithm 1 (blocking)
            local_steps(i)
            local_steps(j)
            xi, xj = X[i], X[j]
            if cfg.quantize:
                xj_hat, f1 = _quantize_modular(xj, xi, cfg.quant_resolution,
                                               cfg.quant_bits, rng)
                xi_hat, f2 = _quantize_modular(xi, xj, cfg.quant_resolution,
                                               cfg.quant_bits, rng)
                trace.quant_failures += f1 + f2
                trace.bits_sent += 2 * cfg.quant_bits * X.shape[1]
                X[i] = (xi + xj_hat) / 2
                X[j] = (xj + xi_hat) / 2
            else:
                trace.bits_sent += 2 * 32 * X.shape[1]
                avg = (xi + xj) / 2
                X[i] = avg.copy()
                X[j] = avg.copy()

        if t % record_every == 0:
            mu = X.mean(axis=0)
            trace.gamma.append(float(np.sum((X - mu) ** 2)))
            if grad_of_mean_fn is not None:
                g = grad_of_mean_fn(mu)
                trace.grad_norm_sq.append(float(np.sum(g * g)))
            if loss_fn is not None:
                trace.loss.append(float(loss_fn(mu)))
    return trace


# ---------------------------------------------------------------------------
# Superstep-level oracle of the SPMD engine (simulator <-> engine parity)
# ---------------------------------------------------------------------------


def run_superstep_oracle(x0: np.ndarray, grad_fn: Callable, perms, H: int,
                         eta: float, nonblocking: bool = False,
                         dtype=np.float32, h_schedule=None,
                         masks=None, kinds=None) -> np.ndarray:
    """Sequential numpy replay of the engine's superstep semantics
    (`core/swarm.py`), the reference side of the simulator↔engine parity
    oracle (tests/test_async_pipeline.py, tests/test_sched_parity.py).

    Unlike `run_simulation` — the paper's one-edge-at-a-time process — this
    models the engine's synchronous-superstep parallelization: every node
    runs its local SGD steps, then the given matching `perm` (an
    involution over nodes, identity at unmatched nodes) averages matched
    pairs. With ``nonblocking=True`` it applies the engine's Algorithm-2
    staleness of depth exactly ONE interaction: the partner contribution is
    the partner's superstep-START model S_j — the value its in-flight
    payload was packed from at the end of the previous superstep in the
    overlapped pipeline — and each node's fresh local delta rides on top:

        X_i <- (S_i + S_j) / 2 + (X_i^post - S_i)

    which is exactly what both the plain non-blocking and the overlapped
    (double-buffered) engine supersteps compute in exact mode.

    Heterogeneous traces (the scheduler bridge, sched/bridge.py):
    `h_schedule` ([T, n] int — per-node local-step counts, 0 = idle;
    defaults to the homogeneous `H` everywhere) and `masks` ([T, n] bool —
    participation; the effective matching is `(perm != arange) & mask`,
    defaults to all-True) replay the engine's masked superstep exactly.

    Elastic membership (sched/bridge.py churn schedules): `kinds` ([T] int,
    avail.EVENT_* values) marks join bins — for a join bin the masked node
    (the joiner) COPIES its partner's (the donor's) model, bitwise, and no
    local steps or averaging happen; permanently-left nodes simply stop
    appearing in masks (their rows freeze), so leaves need no oracle step.

    grad_fn(x, node, t, q) -> gradient for `node` at superstep t, local
    step q (must be deterministic for step-for-step parity). Computation is
    carried in `dtype` (fp32 to match the engine). Returns the [T, n, d]
    trajectory of post-superstep models.
    """
    X = x0.astype(dtype).copy()
    n = X.shape[0]
    eta = dtype(eta)
    traj = []
    for t, perm in enumerate(perms):
        perm = np.asarray(perm)
        if kinds is not None and int(kinds[t]) == 1:  # avail.EVENT_JOIN
            joiner = int(np.nonzero(np.asarray(masks[t], bool))[0][0])
            X[joiner] = X[int(perm[joiner])].copy()
            traj.append(X.copy())
            continue
        h_t = np.full(n, H, np.int64) if h_schedule is None \
            else np.asarray(h_schedule[t])
        S = X.copy()
        for i in range(n):
            for q in range(int(h_t[i])):
                X[i] = X[i] - eta * np.asarray(grad_fn(X[i], i, t, q), dtype)
        matched = perm != np.arange(n)
        if masks is not None:
            matched = matched & np.asarray(masks[t], bool)
        if nonblocking:
            new_x = (S + S[perm]) * dtype(0.5) + (X - S)
        else:
            new_x = (X + X[perm]) * dtype(0.5)
        X = np.where(matched[:, None], new_x, X).astype(dtype)
        traj.append(X.copy())
    return np.stack(traj)


def run_events_oracle(x0: np.ndarray, grad_fn: Callable, pairs, hs,
                      event_bin, eta: float, nonblocking: bool = False,
                      dtype=np.float32, kinds=None) -> np.ndarray:
    """One-event-at-a-time replay of a scheduler trace — the ground truth
    the bridge's binned execution is validated against.

    For each event e with endpoints (i, j) and accrued step counts
    (h_i, h_j): both endpoints run their local steps from their current
    models, then average — blocking: post-step models; non-blocking:
    pre-step models with each side's fresh delta on top (the Algorithm-2 /
    superstep-start staleness the engine implements). Because events within
    a bridge bin are node-disjoint, this sequential replay computes exactly
    the same values as the binned superstep oracle above when grads are
    indexed identically — `event_bin` (from `BinnedSchedule`) maps each
    event to its superstep so grad_fn(x, node, bin, q) draws the same data
    the engine's batched input would. Returns the [E, n, d] post-event
    trajectory.

    Elastic membership: `kinds` ([E] int, avail.EVENT_* values) extends the
    replay with churn — a JOIN event (joiner, donor) copies the donor's
    model into the joiner, bitwise; a LEAVE event is a state no-op (the
    left node's row freezes and it never appears in later events). This is
    the sequential ground truth the engine's churn execution is proven
    against (tests/test_churn.py).
    """
    X = x0.astype(dtype).copy()
    eta = dtype(eta)
    traj = []
    for e, (i, j) in enumerate(np.asarray(pairs)):
        i, j = int(i), int(j)
        if kinds is not None and int(kinds[e]) != 0:
            if int(kinds[e]) == 1:        # avail.EVENT_JOIN
                X[i] = X[j].copy()
            traj.append(X.copy())         # EVENT_LEAVE: state no-op
            continue
        t = int(event_bin[e])
        Si, Sj = X[i].copy(), X[j].copy()
        for q in range(int(hs[e][0])):
            X[i] = X[i] - eta * np.asarray(grad_fn(X[i], i, t, q), dtype)
        for q in range(int(hs[e][1])):
            X[j] = X[j] - eta * np.asarray(grad_fn(X[j], j, t, q), dtype)
        if nonblocking:
            base = (Si + Sj) * dtype(0.5)
            X[i] = base + (X[i] - Si)
            X[j] = base + (X[j] - Sj)
        else:
            avg = (X[i] + X[j]) * dtype(0.5)
            X[i] = avg.copy()
            X[j] = avg.copy()
        traj.append(X.copy())
    return np.stack(traj) if traj else np.zeros((0,) + X.shape, dtype)


# ---------------------------------------------------------------------------
# Standard test objectives
# ---------------------------------------------------------------------------


def quadratic_problem(d: int, n_nodes: int, *, noise: float = 0.1,
                      hetero: float = 0.0, seed: int = 0):
    """f_i(x) = 0.5 * ||A(x - b_i)||^2 with per-node optima spread `hetero`.

    Returns (grad_fn, loss_fn, grad_of_mean_fn, x_star).
    """
    rng = np.random.default_rng(seed)
    diag = np.linspace(0.5, 2.0, d)
    b = rng.normal(size=(n_nodes, d)) * hetero
    b_mean = b.mean(axis=0)

    def grad_fn(x, node, rng_):
        g = diag * (x - b[node])
        return g + noise * rng_.normal(size=d)

    def loss_fn(mu):
        return float(0.5 * np.mean(
            [np.sum(diag * (mu - b[i]) ** 2) for i in range(n_nodes)]))

    def grad_of_mean(mu):
        return diag * (mu - b_mean)

    return grad_fn, loss_fn, grad_of_mean, b_mean
