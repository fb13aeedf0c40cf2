"""Uniform optimizer facade used by the training engine (the SGD half of
``repro/optim/api.py``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

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
    raise NotImplementedError(
        f"optimizer {kind!r} is not ported; the port has sgd only")
