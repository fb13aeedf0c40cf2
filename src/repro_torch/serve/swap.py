"""Generation-tagged hot swap of serving params (copy of
``repro/serve/swap.py``; pure Python).

The swap contract the engine builds on:

* publishing is ATOMIC: ``publish`` installs ``(generation, params)`` as a
  single reference assignment, so a reader never observes a half-updated
  pair — there is no moment where the new params carry the old tag;
* generations are MONOTONE: each publish increments the tag by one, and
  ``latest()`` can only ever move forward (asserted);
* the buffer is DOUBLE: at most two generations are live in the engine at
  once — the adopted one (new admissions) and the draining one (in-flight
  sequences finish on the generation they were admitted under). The swap
  object itself only tracks the newest publication; a publish that lands
  while the previous publication is still unadopted simply replaces it
  (the server wants the freshest model, not every model), which is what
  bounds the live set to two.

Because every generation's param trees share shapes/dtypes, adopting a new
generation dispatches the serving functions at shapes they have already
seen — zero new shape signatures per swap, asserted by the engine's
cache-miss counters (serve/engine.py).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple


class HotSwap:
    """Double-buffered, generation-tagged param publication point."""

    def __init__(self):
        self._latest: Optional[Tuple[int, Any]] = None   # (gen, params)
        self._gen = 0
        self._meta: dict = {}        # gen -> (t_landed, tag) for freshness

    def publish(self, params, *, t_landed: float = 0.0,
                tag: str = "") -> int:
        """Install `params` as the newest generation; returns its tag.
        Overwrites a not-yet-adopted pending publication (newest wins)."""
        self._gen += 1
        self._meta[self._gen] = (t_landed, tag)
        # single reference assignment = the atomic swap
        self._latest = (self._gen, params)
        return self._gen

    def latest(self) -> Optional[Tuple[int, Any]]:
        """Newest (generation, params), or None before the first publish."""
        return self._latest

    def landed_at(self, gen: int) -> float:
        return self._meta.get(gen, (0.0, ""))[0]

    def tag(self, gen: int) -> str:
        return self._meta.get(gen, (0.0, ""))[1]

    @property
    def generation(self) -> int:
        return self._gen
