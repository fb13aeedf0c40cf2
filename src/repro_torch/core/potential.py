"""The paper's potential Γ_t = Σᵢ ‖Xᵢ − μ_t‖² over node-stacked trees
(counterpart of ``repro/core/potential.py``), the mean model μ_t, and the
analytic bound of Lemma F.3, E[Γ_t] ≤ (40r/λ₂ + 80r²/λ₂²)·n·η²·H²·M²."""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map


def mean_model(params_stacked):
    """μ_t: the fp32 mean over the leading node axis of every leaf."""
    return tree_map(lambda x: torch.mean(x.to(torch.float32), dim=0),
                    params_stacked)


def gamma_potential(params_stacked) -> torch.Tensor:
    """Γ_t = Σᵢ ‖Xᵢ − μ‖² summed over every parameter leaf (fp32)."""
    total = None
    for x in tree_leaves(params_stacked):
        xf = x.to(torch.float32)
        g = torch.sum(torch.square(xf - torch.mean(xf, dim=0, keepdim=True)))
        total = g if total is None else total + g
    return total


def gamma_bound(n: int, r: int, lambda2: float, eta: float, H: float,
                M2: float) -> float:
    """Lemma F.3 upper bound on E[Γ_t]."""
    return (40 * r / lambda2 + 80 * r**2 / lambda2**2) * n * eta**2 * H**2 * M2
