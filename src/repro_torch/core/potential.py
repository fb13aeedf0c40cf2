"""The paper's potential Γ_t = Σᵢ ‖Xᵢ − μ_t‖² over node-stacked trees
(counterpart of ``repro/core/potential.py``), the mean model μ_t, and the
analytic bound of Lemma F.3, E[Γ_t] ≤ (40r/λ₂ + 80r²/λ₂²)·n·η²·H²·M²."""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core import bucket as B
from repro_torch.tree import tree_leaves, tree_map


def mean_model(params_stacked, mesh=None):
    """μ_t: the fp32 mean over the leading node axis of every leaf. On a
    node `mesh` (the rank's [1, ...] leaves) each leaf's rows are
    all-gathered first (its bytes, so every dtype crosses bit for bit):
    every rank gets the whole swarm's μ, bitwise the one-shard mean of the
    gathered rows."""
    def mu(x):
        if mesh is not None:
            x = B.all_gather_rows(x, mesh)
        return torch.mean(x.to(torch.float32), dim=0)
    return tree_map(mu, params_stacked)


def gamma_potential(params_stacked, mesh=None, split=None) -> torch.Tensor:
    """Γ_t = Σᵢ ‖Xᵢ − μ‖² summed over every parameter leaf (fp32).

    On a node `mesh` (one node a rank, `params_stacked` its [1, ...]
    leaves) every rank gets the global Γ: one all-reduce of the rank's
    packed fp32 buffer gives the sum, so μ; each rank's squared distance
    to μ, and one scalar all-reduce sums them.

    With a model axis `params_stacked` is the rank's slices and `split`
    the tree of ``models/transformer.py`` ``param_split`` (None: a leaf every
    GPU of the node holds whole): μ is taken over the node group, and the
    scalar all-reduce runs over the whole mesh, a whole leaf counted at
    model index 0 only."""
    if mesh is not None:
        layout = B.build_layout(params_stacked)
        buf = B.pack(layout, params_stacked)[0]
        mu = buf.clone()
        dist.all_reduce(mu, group=mesh.group)
        mu.div_(mesh.size)
        # in the packed buffer's own memory (the same values as out of
        # place): two fp32 copies of the rank's parameters at once, not
        # four, where an overlapped step's in-flight buffers are live too
        d = buf.sub_(mu).square_()
        del buf, mu
        if mesh.model_size > 1:
            if split is None:
                raise ValueError("Γ on the model axis needs the parameters' "
                                 "split (models/transformer.py param_split)")
            if mesh.model_index != 0:
                for dim, off, seg in zip(tree_leaves(split), layout.offsets,
                                         layout.seg_sizes):
                    if dim is None:
                        d[off:off + seg] = 0.0
        g = torch.sum(d).reshape(1)
        del d
        dist.all_reduce(g, group=mesh.group if mesh.model_size == 1
                        else None)
        return g[0]
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
