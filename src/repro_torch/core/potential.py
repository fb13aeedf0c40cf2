"""The paper's potential Γ_t = Σᵢ ‖Xᵢ − μ_t‖² over node-stacked trees."""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves


def gamma_potential(params_stacked) -> torch.Tensor:
    """Γ_t = Σᵢ ‖Xᵢ − μ‖² summed over every parameter leaf (fp32)."""
    total = None
    for x in tree_leaves(params_stacked):
        xf = x.to(torch.float32)
        g = torch.sum(torch.square(xf - torch.mean(xf, dim=0, keepdim=True)))
        total = g if total is None else total + g
    return total
