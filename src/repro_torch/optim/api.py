"""Uniform optimizer facade used by the training engines (counterpart of
``repro/optim/api.py``): sgd and adamw."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim.sgd import SGDConfig, sgd_init, sgd_update


@dataclass(frozen=True)
class Optimizer:
    cfg: Any
    init: Callable
    update: Callable  # (params, grads, state, lr) -> (params, state)


def make_optimizer(kind: str = "sgd", **kw) -> Optimizer:
    if kind == "sgd":
        cfg = SGDConfig(**kw)
        return Optimizer(cfg, lambda p: sgd_init(cfg, p),
                         lambda p, g, s, lr=None: sgd_update(cfg, p, g, s, lr))
    if kind == "adamw":
        cfg = AdamWConfig(**kw)
        return Optimizer(cfg, lambda p: adamw_init(cfg, p),
                         lambda p, g, s, lr=None: adamw_update(cfg, p, g, s,
                                                               lr))
    raise ValueError(f"unknown optimizer {kind!r}")
