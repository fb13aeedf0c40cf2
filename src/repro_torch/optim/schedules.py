"""Learning-rate schedules (counterpart of ``repro/optim/schedules.py``):
each returns fn(step) -> a 0-d fp32 tensor, `step` an int or an integer
tensor (on the device the result should lie on). The paper reuses the
sequential baseline's schedule unchanged (step decay at 1/3 and 2/3 of
training for ResNets)."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.int32) \
        if not isinstance(step, torch.Tensor) else step


def constant_lr(base: float):
    def fn(step):
        return torch.tensor(base, dtype=torch.float32,
                            device=_step(step).device)
    return fn


def step_decay_lr(base: float, total_steps: int, milestones=(1 / 3, 2 / 3),
                  factor: float = 0.1):
    ms = [m * total_steps for m in milestones]

    def fn(step):
        s = _step(step)
        k = torch.sum(s >= torch.tensor(ms, dtype=torch.float32,
                                        device=s.device))
        return base * torch.pow(factor, k.to(torch.float32))
    return fn


def cosine_lr(base: float, total_steps: int, final_frac: float = 0.0):
    def fn(step):
        t = torch.clamp(_step(step) / total_steps, 0.0, 1.0)
        c = 0.5 * (1 + torch.cos(math.pi * t))
        return base * (final_frac + (1 - final_frac) * c)
    return fn


def warmup_cosine_lr(base: float, total_steps: int, warmup: int = 100,
                     final_frac: float = 0.0):
    cos = cosine_lr(base, max(total_steps - warmup, 1), final_frac)

    def fn(step):
        s = _step(step)
        w = torch.clamp_max(s / max(warmup, 1), 1.0)
        return torch.where(s < warmup, base * w, cos(s - warmup))
    return fn
