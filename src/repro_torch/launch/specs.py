"""The mesh of a SwarmSGD node split over GPUs (counterpart of the mesh
rules of ``repro/launch/specs.py``): the axes that carry the nodes and
their count.

In the reference's production layout a node is a tensor-parallel island
of 16 chips: the mesh has the axes ``("data", "model")`` (``"pod"`` too
on two pods), and the nodes live on the axes other than ``"model"``
(:func:`node_axes_for`). In the port a node is K GPUs of a node mesh
(``launch/mesh.py`` ``init_node_mesh(..., model_parallel=K)``); how a
node's parameters split over them is ``models/split.py``'s.

FUNCTIONS only: importing this module touches no device state.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.models.split import MODEL_AXIS


def node_axes_for(cfg, mesh: Dict[str, int]) -> Tuple[str, ...]:
    """The mesh axes that carry the nodes (``specs.py:29``): every axis
    but "model" (a ``big_model`` node is a whole pod)."""
    if cfg.big_model:
        return ("pod",) if "pod" in mesh else ()
    return tuple(a for a in mesh if a != MODEL_AXIS)


def n_nodes_for(cfg, mesh: Dict[str, int]) -> int:
    """Nodes of the mesh (``specs.py:36``)."""
    n = 1
    for a in node_axes_for(cfg, mesh):
        n *= mesh[a]
    return n
