"""The chunked superstep driver (counterpart of ``repro/core/scan.py``).

The reference folds K supersteps into one ``lax.scan`` dispatch. Here a
chunk replays CUDA graphs: on the card each superstep is one graph, captured
once per *graph key* — the host values its control flow reads, which for
the local-step loop is the pair (min h, max h) and for SGP also t mod
log2 n (``EngineStep.graph_key``) — and replayed with no host sync inside
the chunk. A graph reads its inputs from static buffers, which the chunk
refills before each replay with device-to-device copies (the chunk's
matchings, counts, masks and batches are moved to the card once per
chunk), and writes the new state back into the state's own tensors in
place, as the reference donates its carry: the state passed in is
consumed, and the chunk returns it updated.

Only the sweeps a superstep runs are captured, so a chunk launches what the
per-step driver launches (Σ_s max_i h_{s,i} optimizer sweeps), not h_max
sweeps a superstep. The driver's first superstep runs the body eagerly
(the warm-up a capture needs: cuBLAS handles, the permute's side stream,
cached device constants) and is then captured on the capture stream,
which runs nothing on the card; the first superstep of every later key is
captured and replayed at once (on a node mesh: run eagerly, then
captured), so no eager run's memory sits beside the graphs' shared pool
while it replays; every later superstep with a captured key replays its graph. The encode's generator is registered with every graph, so
a replay draws the uniforms the eager sequence would. The kernels' launch
counters (``kernels/ops.py``) count in Python: a graph's launches are
recorded at its capture and added at every replay. Since keys replay in
schedule order and share one pool, each capture is checked to leave
nothing allocated in the pool beyond the first capture's cuBLAS
workspaces.

On a node mesh (``launch/mesh.py``, one node a rank) the captured superstep
holds the rank's NCCL work too: the exchange's point-to-point messages,
the metrics' all-gather, Γ's all-reduces, the baselines' all-gathers. A
graph posts to the ranks it was captured with, so the key adds the rank's
(dsts, src) for the superstep's host perm (``EngineStep.peers_fn``), and
the chunk stages that perm beside h. The rank's encode draws from a
generator folded from the run's by a host hash of its state
(``NodeMesh.fold_generator``), which a replay cannot compute: the driver
folds through :class:`GraphFolds`, whose persistent generators every graph
registers and which it seeds on the host before each replay from where
the run's generator stood at each fold of that key's superstep. A place
can be read only eagerly, so on a mesh each new key's superstep runs
eagerly (recording its places), then is captured. Ranks whose keys differ
run the same NCCL work in the same order, eagerly or replayed. On the card
the mesh chunk needs NCCL's registration of captured buffers off
(``NCCL_GRAPH_REGISTER=0`` in the environment before the process group
starts; the driver raises otherwise): with it on, on 4 H100s with NCCL
2.28.9, a new driver's first exchange hung after an earlier driver's
graphs were destroyed (PERF.md §6). Every rank calls :meth:`close` before
a driver is dropped and a new one built: the ranks' devices finish and
the ranks meet before and after the graphs and their pool are released.

On CPU tensors the same body runs eagerly, superstep by superstep; on CUDA
tensors the chunk captures or raises. A chunked run is bitwise the
per-step driver's on the final state and the per-superstep metrics (on
the card, when both run under deterministic algorithms with one pinned
cuBLAS workspace), and
chunk boundaries are exact resume and checkpoint points (the state there
is the per-step driver's state at the same superstep).

Every chunk driver of a process captures on one capture stream per device,
so the cuBLAS workspaces a capture stream gets (one a thread that runs
GEMMs, cached by PyTorch for the life of the process) are made once, not
once a driver. Between replays the graphs' shared pool holds the free
blocks of their temporaries (tens of GiB at full width); work that runs at
a chunk boundary and frees everything it allocates before the next replay
— the mean-model evaluation of ``--eval-mean`` — allocates from there
(`borrow_pool`) instead of from the default pool beside them.
"""
from __future__ import annotations

import contextlib
import gc
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.exchange import EngineStep, StepInputs
from repro_torch.core.swarm import SwarmState
from repro_torch.kernels import ops as K

_FIELDS = ("params", "opt", "prev", "inflight", "residual")

# what a capture may leave allocated in the graphs' shared pool: the first
# capture creates the capture stream's cuBLAS workspaces there, one for the
# handle of each thread that runs GEMMs (this one's forward, the autograd
# engine's backward), 32 MiB each on Hopper (PyTorch's default and the
# :4096:8 that chip_smoke.py pins; seen on the H100 as two 33,554,432-byte
# blocks allocated by at::cuda::setWorkspaceForHandle); every later capture
# must leave the pool as it found it
_POOL_ALLOWANCE = 2 * (32 << 20)


def _leaves(x) -> list:
    """Tensors of a state field in a fixed order: dicts by sorted key,
    tuples (a wire) in order, None empty."""
    if x is None:
        return []
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in _leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _leaves(v)]
    return [x]


def _state_leaves(state: SwarmState) -> list:
    return [t for f in _FIELDS for t in _leaves(getattr(state, f))]


def _release() -> None:
    """Return every cached, unused block to the device (reference cycles
    first): a graph's pool cannot reuse the default pool's blocks."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _pool_bytes(pool, key: str = "allocated_size") -> int:
    """Bytes allocated (live) in the CUDA graph pool `pool` (an id), or
    with key="total_size" the bytes its segments reserve."""
    return sum(seg[key] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == tuple(pool))


_CAPTURE_STREAMS: dict = {}


def _capture_stream(device) -> torch.cuda.Stream:
    """The one capture stream of `device` for every chunk driver."""
    key = torch.device(device).index
    side = _CAPTURE_STREAMS.get(key)
    if side is None:
        side = _CAPTURE_STREAMS[key] = torch.cuda.Stream(device=device)
    return side


def _write_back(static: SwarmState, new: SwarmState) -> None:
    """Copy `new`'s tensors into `static`'s, field by field (a tensor the
    step passed through unchanged is the static one itself)."""
    dst, src = _state_leaves(static), _state_leaves(new)
    if len(dst) != len(src):
        raise ValueError(f"the step changed the state's structure: "
                         f"{len(dst)} tensors before, {len(src)} after")
    for d, s in zip(dst, src):
        if s is d:
            continue
        if s.shape != d.shape or s.dtype != d.dtype:
            raise ValueError(f"state tensor {tuple(d.shape)} {d.dtype} "
                             f"cannot take {tuple(s.shape)} {s.dtype}")
        d.copy_(s)


class GraphFolds:
    """A node mesh's folds of the run's generator in a form a CUDA graph
    replays (the chunk driver's; ``NodeMesh.folding``): fold i of a
    superstep always hands out persistent generator i, which every graph
    registers.

    Eagerly (``begin(key, rng, capturing=False)``) fold i seeds generator
    i as ``NodeMesh.fold_generator`` would seed a fresh one, so the draws
    are the fold's, and records the place of the fold under graph key
    `key`: how far the run's generator `rng` (on the card) had moved since
    the superstep began. Under capture the seed cannot be set (it hashes
    `rng`'s state): fold i hands out generator i as it is and moves `rng`
    on by its draw, and :meth:`seed_for_replay` seeds every generator from
    `rng`'s state at the key's places before each replay. A capture that
    folds another number of times than its key's eager run raises."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.gens: list = []       # generator i of fold i
        self.places: dict = {}     # graph key -> rng's offset at each fold
        self._key, self._i, self._start = None, 0, None
        self._capturing = False

    def begin(self, key, rng: Optional[torch.Generator],
              capturing: bool) -> None:
        """Before a superstep's body under graph key `key`."""
        if capturing and key not in self.places:
            raise RuntimeError(f"graph key {key} is captured before an "
                               "eager run recorded its folds")
        self._key, self._i, self._capturing = key, 0, capturing
        if not capturing:
            self.places[key] = []
            self._start = rng.get_offset() if rng is not None and \
                rng.device.type == "cuda" else None

    def fold(self, rng: torch.Generator) -> torch.Generator:
        i, self._i = self._i, self._i + 1
        places = self.places[self._key]
        if self._capturing:
            if i >= len(places):
                raise RuntimeError(
                    f"a captured superstep folds the run's generator "
                    f"{i + 1} times, its key's eager run {len(places)}")
            self.mesh.move_on(rng)
            return self.gens[i]
        if i == len(self.gens):
            self.gens.append(torch.Generator(device=rng.device))
        places.append(None if self._start is None
                      else rng.get_offset() - self._start)
        g = self.gens[i]
        g.manual_seed(self.mesh.fold_seed(rng))
        self.mesh.move_on(rng)
        return g

    def end(self) -> None:
        """After a superstep's body: a capture folded as often as its
        key's eager run."""
        want = len(self.places[self._key])
        if self._capturing and self._i != want:
            raise RuntimeError(
                f"a captured superstep folds the run's generator {self._i} "
                f"times, its key's eager run {want}")

    def seed_for_replay(self, key, rng: torch.Generator) -> None:
        """Seed each generator as its eager fold would have, from `rng`'s
        state at the fold's place in the superstep about to replay."""
        start = rng.get_offset()
        for g, at in zip(self.gens, self.places[key]):
            rng.set_offset(start + at)
            g.manual_seed(self.mesh.fold_seed(rng))
        rng.set_offset(start)


class SuperstepChunk:
    """chunk(state, gen, batch, perm, h[, mask]) -> (state, metrics): K
    supersteps of `step` (an EngineStep). batch leaves carry a leading [K]
    dim (tensors on the state's device); perm, h (and with `with_mask`,
    mask) are host arrays [K, n_nodes]; gen is the encode's generator (or
    None for a run that draws nothing). Returns the state — the argument's
    own tensors, updated in place, its step advanced by K — and each
    metric stacked [K] on the device."""

    def __init__(self, step: EngineStep, *, with_mask: bool = False):
        if not isinstance(step, EngineStep):
            raise TypeError("the chunk driver takes an EngineStep (from "
                            "make_swarm_step / make_algorithm)")
        self.step = step
        # a node mesh's folds of the run's generator, replayable
        self._folds = None if step.mesh is None else GraphFolds(step.mesh)
        self._closed = False
        self.with_mask = with_mask
        self.graphs = {}          # graph key -> (CUDAGraph, launches)
        self.pool_bytes = {}      # graph key -> pool bytes after its capture
        self._state: Optional[SwarmState] = None
        self._inp: Optional[StepInputs] = None
        self._batch: Optional[dict] = None
        self._metrics: Optional[dict] = None
        self._pool = None          # the graphs' shared torch.cuda.MemPool
        self._warm = False

    # -- static buffers ----------------------------------------------------

    def _adopt(self, state: SwarmState) -> None:
        """Make `state`'s tensors the static ones on the first call; later
        calls take the state the chunk returned (the same tensors)."""
        if self._state is None:
            self._state = SwarmState(state.params, state.opt, state.prev,
                                     state.step, state.inflight,
                                     state.residual)
            return
        mine, theirs = _state_leaves(self._state), _state_leaves(state)
        if len(mine) != len(theirs) or any(
                a is not b for a, b in zip(mine, theirs)):
            raise ValueError("a chunk driver updates the state it was "
                             "first given in place: pass the state it "
                             "returned (or build a new driver)")
        self._state.step = state.step

    def _stage(self, device, n_nodes: int, batch: dict, k: int, lr: float,
               perm_d, h_d, mask_d, h_host, perm_host) -> None:
        if self._inp is None:
            self._inp = StepInputs.static(n_nodes, device, self.with_mask)
            self._batch = {name: torch.empty_like(v[0])
                           for name, v in batch.items()}
        inp = self._inp
        inp.lr.fill_(lr)
        inp.perm.copy_(perm_d[k])
        inp.h.copy_(h_d[k])
        if self.with_mask:
            inp.mask.copy_(mask_d[k])
        inp.h_host, inp.perm_host = h_host, perm_host
        for name, v in batch.items():
            self._batch[name].copy_(v[k])

    # -- one superstep -----------------------------------------------------

    def _body(self, gen, key=None, capturing: bool = False) -> None:
        """The captured function: one superstep from the static inputs,
        its state and metrics written into the static tensors. On the card
        (`key` its graph key) a node mesh's folds of `gen` go through the
        driver's GraphFolds."""
        if key is None or self._folds is None:
            new, m = self.step.run(self._state, self._batch, self._inp, gen)
        else:
            self._folds.begin(key, gen, capturing)
            with self.step.mesh.folding(self._folds):
                new, m = self.step.run(self._state, self._batch, self._inp,
                                       gen)
            self._folds.end()
        _write_back(self._state, new)
        del new
        if self._metrics is None:
            self._metrics = {k: v.clone() for k, v in m.items()}
        else:
            for k, v in m.items():
                self._metrics[k].copy_(v)

    def _cuda_superstep(self, key, gen) -> None:
        if key in self.graphs:
            self._replay(key, gen)
            return
        # warm-up, once per driver: this superstep, eagerly, on the
        # current stream, where the state's memory was allocated and
        # cached (lazy initialisation must not happen under capture:
        # cuBLAS handles, the permute's side stream, cached device
        # constants, the kernels' libraries); later keys find it done and
        # capture at once, so no eager run's memory sits beside the
        # graphs' pool. On a node mesh every new key's superstep runs
        # eagerly first: it records where the key's folds stand
        eager = not self._warm or self._folds is not None
        if not self._warm:
            self._warm = True
            self._pool = torch.cuda.MemPool()
        if eager:
            _release()
            self._body(gen, key)
        # the capture allocates from the shared pool what the warm-up and
        # earlier eager work left cached in the default pool
        _release()
        current = torch.cuda.current_stream()
        side = _capture_stream(current.device)
        side.wait_stream(current)
        graph = torch.cuda.CUDAGraph()
        if gen is not None:
            graph.register_generator_state(gen)
        for g in () if self._folds is None else self._folds.gens:
            graph.register_generator_state(g)
        before = dict(K.LAUNCHES)
        # the autograd engine runs the backward on its own thread, on the
        # capturing stream: "thread_local" refuses unsafe calls of this
        # thread only
        failed = None
        try:
            with torch.cuda.graph(graph, pool=self._pool.id, stream=side,
                                  capture_error_mode="thread_local"):
                try:
                    self._body(gen, key, capturing=True)
                except BaseException as e:
                    failed = e
                    raise
        except BaseException as end:
            if failed is None or end is failed:
                raise
            # the body raised between the permute's fork onto its side
            # stream and the join (an out-of-memory error in the local
            # steps, say): ending the capture then fails with "unjoined
            # work", which must not hide the cause
            raise failed from end
        launches = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES}
        K.LAUNCHES.update(before)       # the capture ran nothing
        self.graphs[key] = (graph, launches)
        current.wait_stream(side)
        self._check_pool(key)
        if not eager:
            self._replay(key, gen)      # this superstep

    def _replay(self, key, gen) -> None:
        graph, launches = self.graphs[key]
        if self._folds is not None and gen is not None:
            self._folds.seed_for_replay(key, gen)
        graph.replay()
        K.add_launches(launches)

    def _check_pool(self, key) -> None:
        """Graphs replay in schedule order, not in capture order. A tensor
        that a capture leaves allocated in the shared pool may sit where
        an earlier graph kept its temporaries, and that graph's replay
        would overwrite it; so no capture but the first may leave a byte
        there, and the first only its workspaces (scratch, rewritten
        before every read), at most `_POOL_ALLOWANCE`."""
        gc.collect()
        live = _pool_bytes(self._pool.id)
        before = max(self.pool_bytes.values(), default=0)
        self.pool_bytes[key] = live
        allowed = _POOL_ALLOWANCE if len(self.pool_bytes) == 1 else before
        if live > allowed:
            raise RuntimeError(
                f"the capture of graph key {key} left {live} bytes "
                f"allocated in the graphs' shared pool (allowed {allowed}): "
                f"a replay out of capture order could overwrite them")

    def pool_reserved(self) -> int:
        """Bytes the graphs' shared pool reserves (0 before a capture)."""
        return 0 if self._pool is None else \
            _pool_bytes(self._pool.id, "total_size")

    def borrow_pool(self):
        """A context in which this thread allocates from the graphs' shared
        pool: for work between replays (the mean-model evaluation at a
        chunk boundary) whose tensors are all freed before the next
        replay, which would overwrite them. A no-op before the first
        capture and on the CPU."""
        if self._pool is None:
            return contextlib.nullcontext()
        return torch.cuda.use_mem_pool(self._pool)

    def close(self) -> None:
        """Release the graphs, their pool and the static inputs; the state
        the driver returned stays the caller's. On a node mesh every rank
        calls it: each rank's device finishes its work and the ranks meet
        before the graphs are destroyed and again after, so no rank
        communicates while a peer's graphs go. A closed driver runs no
        chunk."""
        mesh = self.step.mesh
        on_card = self._pool is not None

        def settle():
            if on_card:
                torch.cuda.synchronize()
            if mesh is not None and dist.is_initialized():
                dist.barrier(group=mesh.group)
                if on_card:
                    torch.cuda.synchronize()
        settle()
        self.graphs.clear()
        self._pool = self._state = self._inp = self._batch = None
        self._metrics = None
        self._closed = True
        gc.collect()
        settle()

    # -- the chunk ---------------------------------------------------------

    def __call__(self, state: SwarmState, gen, batch: dict, perm, h,
                 mask=None):
        if self.with_mask != (mask is not None):
            raise ValueError(f"with_mask={self.with_mask} but mask is "
                             f"{'given' if mask is not None else 'None'}")
        perm, h = np.asarray(perm), np.asarray(h)
        n_steps, n_nodes = h.shape
        if self._closed:
            raise RuntimeError("this chunk driver is closed: build a new one")
        self._adopt(state)
        device = _state_leaves(self._state)[0].device
        on_card = device.type == "cuda"
        if on_card and self.step.mesh is not None and \
                os.environ.get("NCCL_GRAPH_REGISTER") != "0":
            raise RuntimeError(
                "a node mesh's chunk captures NCCL work: set "
                "NCCL_GRAPH_REGISTER=0 in the environment before the "
                "process group starts (core/scan.py)")
        # the chunk's schedule rows, moved to the device once
        perm_d = torch.as_tensor(perm.astype(np.int64), device=device)
        h_d = torch.as_tensor(h.astype(np.int32), device=device)
        mask_d = torch.as_tensor(np.asarray(mask, bool), device=device) \
            if mask is not None else None
        out = {}
        for k in range(n_steps):
            st = self._state
            h_host = tuple(int(x) for x in h[k])
            self._stage(device, n_nodes, batch, k, self.step.lr_fn(st.step),
                        perm_d, h_d, mask_d, h_host, perm[k])
            if on_card:
                self._cuda_superstep(
                    self.step.graph_key(st, h_host, perm[k]), gen)
            else:
                self._body(gen)
            st.step += 1
            for name, v in self._metrics.items():
                out.setdefault(name, []).append(v.clone())
        return self._state, {k: torch.stack(v) for k, v in out.items()}


def make_superstep_scan(step_fn: EngineStep, *,
                        with_mask: bool = False) -> SuperstepChunk:
    """Wrap a per-superstep engine step (from make_swarm_step /
    make_algorithm) into a K-superstep chunk: chunk(state, gen, batch[K],
    perm[K], h[K][, mask[K]]) -> (state, metrics stacked [K])."""
    return SuperstepChunk(step_fn, with_mask=with_mask)
