"""Continuous-batching serving engine (``repro/serve/engine.py``).

Slot-based scheduling over the model's prefill/decode/chunk modes:
sequences join and retire MID-BATCH by flipping a lane mask — every lane
computes every step, only masked lanes COMMIT, so all shapes are static.
The reference vmaps a batch-1 forward over the slots; here the slots are
one batch whose cache carries one length per lane, so lane ``i`` reads
and writes only its own rows.

KV memory comes in two layouts:

* dense (default): a fixed bank of `max_slots` lanes, every cache leaf
  with a slot axis (``blocks`` leaves [n_blocks, slots, ...], everything
  else [slots, ...]);
* paged (``EngineConfig.paged``): full-attention layers share global page
  pools + per-lane page tables (serve/paged.py); pages alloc on admit,
  free on retire, and an admission that cannot get pages DEFERS. Decode
  gathers a lane's pages back to the contiguous layout, so the paged token
  stream is BITWISE the dense engine's. Sliding-window rings and Mamba
  states stay in the per-lane tree, side by side in a hybrid bank.

A mixture-of-experts layer routes and dispatches each lane on its own
(``forward(moe_per_lane=True)``), as the reference's vmap does: a lane's
capacity is that of its own tokens (1 at decode, the chunk in a chunk
step), and an idle lane's tokens take no slot in another lane's expert
buffer; the slots still run as one batched call. Architectures with a
modality frontend are refused: they serve through the one-shot path.

Prefill comes in two schedules:

* blocking (default): admission runs a batch-1 prefill to completion and
  installs the cache; ragged prompts dispatch at their own length;
* chunked (``prefill_chunk`` > 0): prompts prefill in fixed-shape
  [slots, T] token chunks, one chunk dispatch interleaved with the decode
  dispatch per engine step, masked commits — ragged prompts are
  length-masked chunks and no new shape is ever dispatched.

Hot swap (serve/swap.py) composes with the batch through generations: a
lane is pinned to the param generation it was ADMITTED under and finishes
on it; at most two generations are ever live, each step runs one masked
dispatch per live generation — same shapes.

"Zero recompiles": eager PyTorch has no compile cache, so the engine
counts the distinct shape signatures (tree structure, shapes, dtypes of
every argument) dispatched to its decode and chunk steps;
``decode_cache_misses`` / ``prefill_cache_misses`` are that count minus
one — exactly what jit would compile again. A swap and a chunked ragged
admission add none. The bank's dtypes are the reference's: an SSM state
in bf16 widens to fp32 at the bank's first decode (the bf16 state times
the fp32 decay), which adds one signature to each step that runs before
and after it, as it adds one compile to the reference's.

Admission control: a bounded FIFO queue (`queue_depth`); `submit` on a
full queue REJECTS (backpressure) and counts it.

Sampling: greedy (temperature 0) is an argmax; temperature sampling draws
from the engine's ``torch.Generator`` seeded with ``EngineConfig.seed``,
one draw per dispatch, so a seed fixes the stream (the reference's
``jax.random`` draws cannot be reproduced in torch).

On a node split over K GPUs (`tp`, ``launch/mesh.py`` ``ModelShard``;
`params` and every source's models this GPU's slices) each GPU runs the
same engine on its own cache bank and pools (its kv heads), and every
dispatch's collectives pair with its peers' only if the K engines take
the same host decisions in the same step. Model index 0 decides:

* the clock (:meth:`ServeEngine.clock`): every decision in time (the
  step's admissions' timestamps, an open loop's arrivals) reads index 0's;
* the source: index 0 polls, and the others take the very checkpoint or
  snapshot it took (``poll(tag=...)``, waiting up to SOURCE_WAIT_S);
* the tokens: each GPU samples from the whole (gathered) logits and then
  takes index 0's tokens (``models/layers.py`` ``broadcast_from_model``).

Admissions, adoptions and retirements then follow from the same queue,
lanes and allocator on every GPU. Before each dispatch, and at each clock
and poll, the K GPUs all-gather one fixed-size row of their host state
(the call's kind, the queue, the allocator, every lane) and raise on any
difference, on every GPU at once: a GPU out of step fails this check and
never pairs its collectives with another step's.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models import forward, init_cache, logits_head
from repro_torch.models.layers import broadcast_from_model
from repro_torch.serve import paged as P
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.swap import HotSwap
from repro_torch.tree import (
    keystr, tree_flatten, tree_key_paths, tree_leaves, tree_map_with_path,
)


def lane_axis(path) -> int:
    """The slot axis of a cache leaf: after the stacked block axis."""
    return 1 if path and path[0] == "blocks" else 0


def grow_cache(full, cache):
    """Copy a (smaller) prefill cache into a full-capacity cache.

    Every leaf must either match shapes exactly or grow into a same-rank
    leaf that is at least as large on every axis; anything else raises
    with the offending leaf path — a shape mismatch silently keeping the
    EMPTY destination would serve garbage KV state. Used by the one-shot
    path (launch/serve.py); the engine installs prefill caches in place,
    lane by lane."""
    if tree_flatten(full)[1] != tree_flatten(cache)[1]:
        raise ValueError("prefill and serving caches must share structure")

    def grow(path, dst, src):
        name = keystr(path)
        if dst.ndim != src.ndim:
            raise ValueError(
                f"cache leaf {name}: rank mismatch {tuple(src.shape)} -> "
                f"{tuple(dst.shape)}; prefill and serving caches must share "
                "structure")
        if dst.shape == src.shape:
            return src
        if any(d < s for d, s in zip(dst.shape, src.shape)):
            raise ValueError(
                f"cache leaf {name}: cannot grow {tuple(src.shape)} into "
                f"smaller {tuple(dst.shape)}")
        out = dst.clone()
        out[tuple(slice(0, s) for s in src.shape)] = src.to(dst.dtype)
        return out
    return tree_map_with_path(grow, full, cache)


def _signature(*trees) -> tuple:
    """Tree structure, shapes and dtypes of a call's arguments: what a jit
    cache keys on."""
    out = []
    for tree in trees:
        leaves, treedef = tree_flatten(tree)
        out.append((treedef, tuple((tuple(x.shape), x.dtype)
                                   for x in leaves
                                   if isinstance(x, torch.Tensor))))
    return tuple(out)


# what a split node's GPUs are about to do, the first entry of the row
# they check against each other (ServeEngine._agree)
_CLOCK, _POLL, _PREFILL, _CHUNK, _DECODE = range(5)

#: seconds a split node's GPU waits for the model its model index 0 took
SOURCE_WAIT_S = 60.0


@dataclass(frozen=True)
class EngineConfig:
    max_slots: int = 4           # concurrent sequences (KV-cache lanes)
    prompt_len: int = 32         # default/maximum admission prompt length
    max_new_tokens: int = 16     # default per-request generation budget
    cache_size: int = 0          # 0 = prompt_len + max_new_tokens
    queue_depth: int = 16        # bounded admission queue (backpressure)
    temperature: float = 0.0     # 0 = greedy (deterministic serving)
    seed: int = 0
    # paged KV (serve/paged.py). page_size is rows per page; n_pages sizes
    # the global pool (0 = enough for every lane at full capacity — no
    # memory saving, but no admission can ever starve). Architectures
    # with no full-attention layer (pure SSM) run dense: paging is a
    # documented no-op there. The defaults are the reference's
    # environment defaults, as constants: the port reads no environment.
    paged: bool = False
    page_size: int = 8
    n_pages: int = 0
    # chunked prefill: tokens per prefill chunk; 0 = blocking admission
    prefill_chunk: int = 0

    @property
    def kv_capacity(self) -> int:
        base = self.cache_size or (self.prompt_len + self.max_new_tokens)
        if self.paged:
            # page-aligned so a page table covers exactly the capacity
            base = -(-base // self.page_size) * self.page_size
        return base

    @property
    def pages_per_lane(self) -> int:
        return self.kv_capacity // self.page_size

    @property
    def pool_pages(self) -> int:
        return self.n_pages or (self.max_slots * self.pages_per_lane)


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                   # [L] int32, L <= prompt_len
    max_new_tokens: int = 0              # 0 = engine default
    t_submit: float = 0.0


@dataclass
class Completion:
    rid: int
    tokens: np.ndarray                   # [n_generated] int32
    gen: int                             # param generation served under
    t_submit: float
    t_admit: float
    t_first_token: float
    t_done: float


@dataclass
class _Lane:
    rid: int = -1
    gen: int = -1
    active: bool = False
    prefilling: bool = False
    pos: int = 0                         # prompt tokens consumed (chunked)
    prompt: Optional[np.ndarray] = None
    budget: int = 0
    remaining: int = 0
    pages: Optional[List[int]] = None
    tokens: List[int] = field(default_factory=list)
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0
    t_last: float = 0.0                  # last token commit (gap metric)


class ServeEngine:
    """Continuous-batching engine over one model config, on `device`.

    `source` is any object with ``poll() -> Optional[ModelUpdate]``
    (serve/source.py); `params` seeds generation 1 directly when no source
    is used (the one-shot/oracle mode). At least one of the two must
    provide a model before the first admission. `tp`: this GPU's share of
    a node split over the model axis (the module docstring); its source
    also takes ``poll(tag=...)``.
    """

    def __init__(self, cfg, ecfg: EngineConfig, *, params=None, source=None,
                 device="cuda", tp=None):
        if cfg.frontend is not None:
            raise ValueError(
                f"{cfg.name}: the continuous-batching engine serves "
                "token-only architectures; multimodal prefix serving runs "
                "through the one-shot path (launch/serve.py)")
        self.cfg = cfg
        self.ecfg = ecfg
        self.device = torch.device(device)
        self.tp = tp
        self.source = source
        self.swap = HotSwap()
        self.metrics = ServeMetrics()
        self.queue: Deque[Request] = deque()
        self.lanes = [_Lane() for _ in range(ecfg.max_slots)]
        self.live: Dict[int, Any] = {}       # gen -> params (<= 2 entries)
        self.adopted_gen = -1
        self.completions: List[Completion] = []
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(ecfg.seed)
        self._decode_sigs: set = set()
        self._chunk_sigs: set = set()
        self._steps = 0
        # paged is a no-op without full-attention layers (pure-SSM archs)
        self._paged = ecfg.paged and bool(P.attn_layer_entries(cfg))
        self.allocator = P.PageAllocator(ecfg.pool_pages) \
            if self._paged else None
        dtype = getattr(torch, cfg.dtype)
        self._pools = P.build_pools(cfg, ecfg.pool_pages, ecfg.page_size,
                                    dtype, self.device, tp) \
            if self._paged else None
        self._caches = self._init_cache_bank()
        self._tokens = torch.zeros((ecfg.max_slots, 1), dtype=torch.int64,
                                   device=self.device)
        self.metrics.kv_pool_pages = ecfg.pool_pages if self._paged else 0
        self.metrics.kv_dense_bytes = P.dense_attn_bank_bytes(
            cfg, ecfg.max_slots, ecfg.kv_capacity, dtype, tp)
        self.metrics.kv_bytes = P.tree_num_bytes(self._pools) \
            if self._paged else self.metrics.kv_dense_bytes
        if params is not None:
            self.swap.publish(params, t_landed=time.time(), tag="init")

    # -- a split node's agreement -----------------------------------------

    def _state_row(self, kind: int, payload: int) -> list:
        row = [kind, payload, self._steps, self.adopted_gen,
               self.swap.generation, len(self.queue),
               self.queue[0].rid if self.queue else -1,
               self.allocator.free_count if self._paged else -1,
               self.metrics.submitted, self.metrics.rejected,
               len(self.completions)]
        for ln in self.lanes:
            row += [int(ln.active), ln.rid, ln.gen, int(ln.prefilling),
                    ln.pos, ln.remaining]
        return row

    def _agree(self, kind: int, payload: int = 0) -> int:
        """Model index 0's `payload`, once the node's GPUs have shown one
        another the same host state before the same call `kind` (one
        all-gather of a fixed-size int64 row over the model group; any
        difference raises on every GPU). Without a model axis
        `payload`."""
        if self.tp is None:
            return payload
        row = torch.tensor(self._state_row(kind, payload), dtype=torch.int64,
                           device=self.device)
        rows = [torch.empty_like(row) for _ in range(self.tp.size)]
        dist.all_gather(rows, row, group=self.tp.group)
        rows = [r.tolist() for r in rows]
        for i, r in enumerate(rows[1:], 1):
            if r[:1] + r[2:] != rows[0][:1] + rows[0][2:]:
                raise RuntimeError(
                    f"serving engine: model index {i} is out of step with "
                    f"index 0 (kind, payload, step, adopted, published, "
                    f"queue, head, free pages, submitted, rejected, "
                    f"completed, lanes: {r} != {rows[0]})")
        return rows[0][1]

    def clock(self) -> float:
        """The engine's wall clock, seconds: ``time.time()``; on a split
        node model index 0's."""
        return self._agree(_CLOCK, time.time_ns()) / 1e9

    # -- the serving steps -------------------------------------------------

    def _sample(self, logits):
        """[slots, vocab] fp32 -> [slots] int64: argmax, or one draw from
        the engine's generator; on a split node model index 0's."""
        temp = self.ecfg.temperature
        if temp <= 0:
            toks = torch.argmax(logits, dim=-1)
        else:
            probs = torch.softmax(logits / temp, dim=-1)
            toks = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        return broadcast_from_model(toks, self.tp)

    def _prefill(self, params, tokens):
        self._agree(_PREFILL)
        hidden, cache, _ = forward(self.cfg, params, tokens, mode="prefill",
                                   tp=self.tp)
        logits = logits_head(self.cfg, params, hidden[:, -1:],
                             self.tp)                       # [1,1,V]
        return self._sample(logits[:, -1]), cache

    def _install(self, cache1, tok1, i: int):
        """Install a batch-1 prefill cache (+ its first token) into lane i,
        in place, touching only that lane: one prefix copy per leaf, the
        stale bank tail beyond the prompt is masked at attention time,
        never read."""
        bank = {k: v for k, v in self._caches.items() if k != "pages"}
        if tree_flatten(bank)[1] != tree_flatten(cache1)[1]:
            raise ValueError("prefill and bank caches must share structure")
        paths = tree_key_paths(bank)
        for path, dst, src in zip(paths, tree_leaves(bank),
                                  tree_leaves(cache1)):
            ax = lane_axis(path)
            lane = dst.select(ax, i)
            if src.ndim == dst.ndim:
                src = src.select(ax, 0)
            lane[tuple(slice(0, s) for s in src.shape)].copy_(src)
        self._tokens[i, 0] = tok1[0]

    def _select(self, commit, new, old):
        """Per-lane commit: lanes with `commit` take `new`, the others keep
        `old` bitwise. A floating leaf takes the wider of the two dtypes,
        as ``jnp.where`` does: a bf16 SSM state widens to fp32 at the
        bank's first decode (the bf16 state times the fp32 decay), as the
        reference's does, and stays there."""
        def sel(path, n, o):
            ax = lane_axis(path)
            m = commit.reshape((1,) * ax + (-1,) + (1,) * (n.ndim - ax - 1))
            dt = torch.promote_types(n.dtype, o.dtype) \
                if o.is_floating_point() else o.dtype
            return torch.where(m, n.to(dt), o.to(dt))
        return tree_map_with_path(sel, new, old)

    def _decode_masked(self, params, commit):
        """One decode step over ALL lanes; only `commit` lanes commit their
        cache/token updates (masking discipline = churn)."""
        caches, pools, tokens = self._caches, self._pools, self._tokens
        self._decode_sigs.add(_signature(params, caches, pools, tokens,
                                         commit))
        self._agree(_DECODE)
        hidden, c2, _ = forward(self.cfg, params, tokens, mode="decode",
                                cache=caches, pools=pools,
                                moe_per_lane=True, tp=self.tp)
        toks = self._sample(logits_head(self.cfg, params, hidden,
                                        self.tp)[:, -1])
        c2, rows = P.split_new_rows(c2)
        self._caches = self._select(commit, c2, caches)
        if rows is not None:
            ones = torch.ones_like(caches["len"])
            self._pools = P.scatter_tree(pools, rows, caches["pages"],
                                         caches["len"], ones, commit,
                                         self.ecfg.page_size)
        self._tokens = torch.where(commit, toks, tokens[:, 0])[:, None]

    def _chunk_masked(self, params, chunks, n_valid, commit, finish):
        """One [slots, T] prefill-chunk step; `commit` lanes advance their
        caches by n_valid tokens, `finish` lanes (final chunk) also commit
        the prompt's next-token sample as their first generated token."""
        caches, pools, tokens = self._caches, self._pools, self._tokens
        self._chunk_sigs.add(_signature(params, caches, pools, tokens,
                                        chunks, n_valid, commit, finish))
        self._agree(_CHUNK)
        hidden, c2, _ = forward(self.cfg, params, chunks, mode="chunk",
                                cache=caches, n_valid=n_valid, pools=pools,
                                moe_per_lane=True, tp=self.tp)
        last = torch.clamp(n_valid.to(torch.int64) - 1, min=0)
        hidden = hidden[torch.arange(hidden.shape[0], device=self.device),
                        last][:, None]                        # [slots,1,D]
        toks = self._sample(logits_head(self.cfg, params, hidden,
                                        self.tp)[:, -1])
        c2, rows = P.split_new_rows(c2)
        self._caches = self._select(commit, c2, caches)
        if rows is not None:
            self._pools = P.scatter_tree(pools, rows, caches["pages"],
                                         caches["len"], n_valid, commit,
                                         self.ecfg.page_size)
        self._tokens = torch.where(finish, toks, tokens[:, 0])[:, None]

    def reset_lane(self, i: int):
        """Zero lane i's recurrent state before chunked prefill: len and
        mamba conv/ssm must restart from scratch (chunk mode RESUMES
        them); attention rows are overwritten/masked, so KV stays. Leaves
        are picked by their path's names, in place, lane i only."""
        for path, leaf in zip(tree_key_paths(self._caches),
                              tree_leaves(self._caches)):
            if set(path) & {"conv", "ssm", "len"}:
                leaf.select(lane_axis(path), i).zero_()

    def _install_pool(self, rows, i: int, length: int):
        """Blocking-admit install of a prefilled prompt's attention rows
        into the page pools (one lane)."""
        dev = self.device
        self._pools = P.scatter_tree(
            self._pools, rows, self._caches["pages"][i:i + 1],
            torch.zeros((1,), dtype=torch.int64, device=dev),
            torch.full((1,), length, dtype=torch.int64, device=dev),
            torch.ones((1,), dtype=torch.bool, device=dev),
            self.ecfg.page_size)

    def _init_cache_bank(self):
        ecfg = self.ecfg
        bank = init_cache(self.cfg, ecfg.max_slots, ecfg.kv_capacity,
                          device=self.device, tp=self.tp)
        bank["len"] = torch.zeros((ecfg.max_slots,), dtype=torch.int32,
                                  device=self.device)
        if self._paged:
            bank, _ = P.strip_attn_kv(self.cfg, bank)
            bank["pages"] = torch.full(
                (ecfg.max_slots, ecfg.pages_per_lane), -1,
                dtype=torch.int32, device=self.device)
        return bank

    # -- model management --------------------------------------------------

    def poll_source(self):
        """Pull at most one fresh model from the source into the swap; on
        a split node the one model index 0 pulls."""
        if self.source is None:
            return
        upd = self.source.poll() if self.tp is None else self._poll_agreed()
        if upd is not None:
            self.swap.publish(upd.params, t_landed=upd.t_landed,
                              tag=upd.tag)

    def _poll_agreed(self):
        """Model index 0 polls; the other GPUs take the checkpoint or
        snapshot it took, by its tag."""
        upd = self.source.poll() if self.tp.index == 0 else None
        if not self._agree(_POLL, int(upd is not None)):
            return None
        tag = [None if upd is None else upd.tag]
        dist.broadcast_object_list(
            tag, src=dist.get_global_rank(self.tp.group, 0),
            group=self.tp.group, device=self.device)
        deadline = time.time() + SOURCE_WAIT_S
        while upd is None:
            upd = self.source.poll(tag=tag[0])
            if upd is None and time.time() > deadline:
                raise RuntimeError(
                    f"serving engine: model index {self.tp.index} found no "
                    f"model {tag[0]!r} (model index 0's) in "
                    f"{SOURCE_WAIT_S} s")
            if upd is None:
                time.sleep(0.01)
        return upd

    def _gens_in_use(self) -> set:
        return {ln.gen for ln in self.lanes if ln.active}

    def _try_adopt(self):
        """Adopt the newest published generation for NEW admissions.

        Double-buffer invariant: at most two generations live at once —
        adoption DEFERS while two distinct generations still hold active
        lanes (the draining one finishes first; sequences are finite, so
        this always unblocks)."""
        latest = self.swap.latest()
        if latest is None:
            return
        gen, params = latest
        if gen == self.adopted_gen:
            return
        in_use = self._gens_in_use()
        if len(in_use - {gen}) >= 2:
            return                         # two gens draining: defer
        assert gen > self.adopted_gen, "generation tags must be monotone"
        self.adopted_gen = gen
        self.live[gen] = params
        self.metrics.record_adoption(gen, self.swap.landed_at(gen))
        self._gc_live()

    def _gc_live(self):
        keep = self._gens_in_use() | {self.adopted_gen}
        for g in [g for g in self.live if g not in keep]:
            del self.live[g]

    # -- admission ---------------------------------------------------------

    def submit(self, req: Request) -> bool:
        """Bounded-queue admission: False = rejected (backpressure)."""
        if len(self.queue) >= self.ecfg.queue_depth:
            self.metrics.rejected += 1
            self.metrics.record_queue(len(self.queue))
            return False
        self.metrics.submitted += 1
        if not req.t_submit:
            req.t_submit = time.time()
        self.queue.append(req)
        self.metrics.record_queue(len(self.queue))
        return True

    def _free_lanes(self) -> List[int]:
        return [i for i, ln in enumerate(self.lanes) if not ln.active]

    def _admit(self, now: float):
        """Move queued requests into free lanes under the adopted
        generation. Blocking mode prefills the prompt here; chunked mode
        only claims the lane (and, paged, its pages) — prefill happens in
        the step's chunk dispatches. Paged: an admission that cannot get
        its pages DEFERS at the queue head (second backpressure signal)."""
        if self.adopted_gen < 0:
            return
        params = self.live[self.adopted_gen]
        for i in self._free_lanes():
            if not self.queue:
                break
            req = self.queue[0]
            prompt = np.asarray(req.prompt, np.int32).reshape(-1)
            L = prompt.shape[0]
            budget = req.max_new_tokens or self.ecfg.max_new_tokens
            if L + budget > self.ecfg.kv_capacity:
                raise ValueError(
                    f"request {req.rid}: prompt {L} + budget {budget} "
                    f"exceeds kv_capacity {self.ecfg.kv_capacity}")
            pages = None
            if self._paged:
                need = -(-(L + budget) // self.ecfg.page_size)
                pages = self.allocator.alloc(need)
                if pages is None:
                    self.metrics.pool_deferrals += 1
                    break                # pool exhausted: stay queued
                self.metrics.record_pool(self.allocator.in_use)
                table = np.full((self.ecfg.pages_per_lane,), -1, np.int32)
                table[:need] = pages
                self._caches["pages"][i] = torch.from_numpy(table)
            self.queue.popleft()
            self.metrics.record_queue_wait(now - req.t_submit)
            ln = self.lanes[i]
            ln.rid, ln.gen, ln.active = req.rid, self.adopted_gen, True
            ln.prompt, ln.budget, ln.pages = prompt, budget, pages
            ln.t_submit, ln.t_admit = req.t_submit, now
            if self.ecfg.prefill_chunk > 0:
                ln.prefilling, ln.pos, ln.tokens = True, 0, []
                self.reset_lane(i)
            else:
                self._admit_blocking(i, ln, params)

    def _admit_blocking(self, i: int, ln: _Lane, params):
        """Blocking admission: batch-1 prefill at the prompt's own length,
        single-copy install."""
        prompt = torch.from_numpy(ln.prompt).to(self.device)[None, :]
        tok1, c1 = self._prefill(params, prompt)
        if self._paged:
            c1, rows = P.strip_attn_kv(self.cfg, c1)
            if rows:
                self._install_pool(rows, i, ln.prompt.shape[0])
        self._install(c1, tok1, i)
        t1 = time.time()
        ln.tokens = [int(tok1[0])]
        ln.remaining = ln.budget - 1
        ln.t_first = ln.t_last = t1
        self.metrics.record_ttft(t1 - ln.t_submit)
        self.metrics.tokens_committed += 1
        self.metrics.record_first_token(ln.gen, t1)
        if ln.remaining <= 0:
            self._retire(i)

    # -- decode / harvest --------------------------------------------------

    def _retire(self, i: int):
        ln = self.lanes[i]
        if ln.pages:
            self.allocator.free(ln.pages)
        self.completions.append(Completion(
            ln.rid, np.asarray(ln.tokens, np.int32), ln.gen,
            ln.t_submit, ln.t_admit, ln.t_first, time.time()))
        self.metrics.completed += 1
        self.lanes[i] = _Lane()

    def _lane_mask(self, pred) -> np.ndarray:
        return np.array([pred(ln) for ln in self.lanes])

    def _step_chunks(self, g: int, params) -> int:
        """One [slots, T] prefill-chunk dispatch for generation g's
        prefilling lanes (fixed shapes). Returns tokens committed (first
        tokens of lanes that finished their prompt)."""
        slots, T = self.ecfg.max_slots, self.ecfg.prefill_chunk
        pre = self._lane_mask(lambda ln: ln.active and ln.gen == g
                              and ln.prefilling)
        if not pre.any():
            return 0
        chunks = np.zeros((slots, T), np.int64)
        nv = np.zeros((slots,), np.int64)
        fin = np.zeros((slots,), bool)
        for i, ln in enumerate(self.lanes):
            if pre[i]:
                L = ln.prompt.shape[0]
                n = min(T, L - ln.pos)
                chunks[i, :n] = ln.prompt[ln.pos:ln.pos + n]
                nv[i], fin[i] = n, ln.pos + n >= L
        dev = self.device
        self._chunk_masked(params, torch.from_numpy(chunks).to(dev),
                           torch.from_numpy(nv).to(dev),
                           torch.from_numpy(pre).to(dev),
                           torch.from_numpy(fin).to(dev))
        committed = 0
        toks_np = self._tokens.cpu().numpy() if fin.any() else None  # sync
        t_now = time.time()
        for i, ln in enumerate(self.lanes):
            if not pre[i]:
                continue
            ln.pos += int(nv[i])
            if fin[i]:
                ln.prefilling = False
                ln.tokens = [int(toks_np[i, 0])]
                ln.remaining = ln.budget - 1
                ln.t_first = ln.t_last = t_now
                self.metrics.record_ttft(t_now - ln.t_submit)
                self.metrics.tokens_committed += 1
                self.metrics.record_first_token(ln.gen, t_now)
                committed += 1
                if ln.remaining <= 0:
                    self._retire(i)
        return committed

    def step(self) -> int:
        """One engine iteration: poll -> adopt -> admit -> per live
        generation one chunk dispatch (chunked prefill) + one decode
        dispatch -> harvest. Returns # tokens committed."""
        now = self.clock()
        if self.metrics.t_start is None:
            self.metrics.t_start = now
        self.poll_source()
        self._try_adopt()
        self._admit(now)
        committed = 0
        # one masked dispatch per live generation (usually one; two while
        # a swap drains) — identical shapes
        for g in sorted(self._gens_in_use()):
            params = self.live[g]
            if self.ecfg.prefill_chunk > 0:
                committed += self._step_chunks(g, params)
            commit = self._lane_mask(lambda ln: ln.active and ln.gen == g
                                     and not ln.prefilling
                                     and ln.remaining > 0)
            if not commit.any():
                continue
            t0 = time.time()
            self._decode_masked(params,
                                torch.from_numpy(commit).to(self.device))
            toks_np = self._tokens.cpu().numpy()     # sync point
            t_now = time.time()
            n = 0
            for i, ln in enumerate(self.lanes):
                if commit[i]:
                    ln.tokens.append(int(toks_np[i, 0]))
                    ln.remaining -= 1
                    self.metrics.record_token_gap(t_now - ln.t_last)
                    ln.t_last = t_now
                    n += 1
            committed += n
            self.metrics.tokens_committed += n
            self.metrics.record_step(t_now - t0, n)
        for i, ln in enumerate(self.lanes):
            if ln.active and not ln.prefilling and ln.remaining <= 0:
                self._retire(i)
        self._gc_live()
        self._steps += 1
        self.metrics.t_end = time.time()
        self.metrics.decode_cache_misses = max(0, len(self._decode_sigs) - 1)
        if self.ecfg.prefill_chunk > 0:
            self.metrics.prefill_cache_misses = max(
                0, len(self._chunk_sigs) - 1)
        return committed

    def drain(self, max_steps: int = 10_000):
        """Run until queue + lanes are empty (no new arrivals)."""
        for _ in range(max_steps):
            if not self.queue and not any(ln.active for ln in self.lanes):
                return
            self.step()
        raise RuntimeError("drain did not converge")

    @property
    def active_count(self) -> int:
        return sum(ln.active for ln in self.lanes)


def serve_openloop(engine: ServeEngine, arrivals, *, settle_steps: int = 0):
    """Drive the engine under a synthetic OPEN-LOOP arrival process:
    `arrivals` is a list of (t_offset_s, Request) relative to loop start.
    Arrivals are injected by wall clock regardless of engine progress (the
    open-loop property — load does not slow down when the server does);
    returns the engine's completions once all work drains. On a split
    node every GPU drives its engine with the same `arrivals`, in model
    index 0's time (``ServeEngine.clock``)."""
    t0 = engine.clock()
    pending = sorted(arrivals, key=lambda a: a[0])
    i = 0
    while i < len(pending) or engine.queue or engine.active_count:
        now = engine.clock() - t0
        while i < len(pending) and pending[i][0] <= now:
            engine.submit(pending[i][1])
            i += 1
        if i < len(pending) and not engine.queue and \
                not engine.active_count:
            time.sleep(min(0.001, max(0.0, pending[i][0] - now)))
            continue
        engine.step()
    for _ in range(settle_steps):
        engine.step()
    return engine.completions
