"""The port's node mesh (counterpart of ``repro/launch/mesh.py``
``make_host_mesh`` / ``make_production_mesh`` and ``repro/compat.py``
``make_mesh_compat``): SwarmSGD's nodes sharded over ``torch.distributed``
ranks, as the reference's static pairs index the shards of its node axis.

With ``model_parallel=K`` (default 1) the mesh is 2-D, the reference's
``("data", "model")``: ``n_nodes x K`` ranks, rank ``r`` node ``r // K``
at model index ``r % K`` ("model" the minor axis, so a node's GPUs are
neighbours). A node's K ranks hold its parameters split by
``models/split.py``; gossip, the node mean and the metrics run between
the ranks of one model index (the node group), the model's own
collectives between the K ranks of a node (the model group). K = 1 is
one node a rank.

On the card each rank owns one GPU (``cuda:<rank>``) and the backend is
NCCL; on the CPU the backend is gloo. The backend follows the device the
caller names, and there is no fallback between them: a mesh on ``cuda``
without a GPU for the rank, or without NCCL, raises.

  mesh = init_node_mesh("cuda")            # RANK, WORLD_SIZE, MASTER_* set
  mesh = init_node_mesh("cpu", rank=r, world_size=4,
                        init_method="tcp://localhost:29500")

FUNCTIONS and a dataclass only: importing this module touches no device
state and starts nothing.
"""
from __future__ import annotations

import contextlib
import contextvars
import hashlib
import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Optional

import torch
import torch.distributed as dist

# who folds while a chunk driver runs a superstep on the card
# (`NodeMesh.folding`): an object with fold(rng) -> Generator, or None
_FOLDER = contextvars.ContextVar("repro_torch_mesh_folder", default=None)


@dataclass(frozen=True)
class ModelShard:
    """What a model's layers need of the model axis: the node's GPU count
    (`size`), this GPU's model index and the model group
    (``models/layers.py`` ``copy_to_model`` / ``reduce_from_model``)."""
    size: int
    index: int
    group: Any


@dataclass(frozen=True)
class NodeMesh:
    """One rank's view of the node mesh: its node (`rank`, its index in
    the node group), the number of nodes (`size`), its device and the node
    group, over which gossip runs (None: the default group). With a model
    axis (`model_size` > 1) also its model index and the model group, the
    K ranks of its node; the global rank of node i at this model index is
    :meth:`peer`."""
    rank: int
    size: int
    device: torch.device
    group: Optional[Any] = None
    model_size: int = 1
    model_index: int = 0
    model_group: Optional[Any] = None

    @property
    def world_rank(self) -> int:
        """This rank's global rank."""
        return self.peer(self.rank)

    def peer(self, node: int) -> int:
        """The global rank of node `node` at this rank's model index (a
        point-to-point message's peer, a gather's destination)."""
        return int(node) * self.model_size + self.model_index

    @property
    def model_shard(self) -> Optional[ModelShard]:
        """The model axis as the layers take it; None without one."""
        if self.model_size == 1:
            return None
        return ModelShard(self.model_size, self.model_index,
                          self.model_group)

    def fold_seed(self, rng: torch.Generator) -> int:
        """The seed of this rank's fold of `rng` as it stands: a hash of
        its state (read on the host) and the rank."""
        state = rng.get_state().numpy().tobytes()
        digest = hashlib.sha256(state + self.rank.to_bytes(8, "little"))
        return int.from_bytes(digest.digest()[:8], "little") >> 1

    @staticmethod
    def move_on(rng: torch.Generator) -> None:
        """The one draw by which a fold moves the run's generator on."""
        torch.empty((1,), device=rng.device).uniform_(generator=rng)

    def fold_generator(self, rng: torch.Generator) -> torch.Generator:
        """This rank's generator for one encode, made from the run's
        generator `rng` and the rank (the counterpart of
        ``jax.random.fold_in(key, axis_index)``): seeded by `fold_seed`,
        after which `rng` moves on by one draw, the same on every rank.
        Reads the state on the host: no device sync. Inside `folding`
        the folder given there folds instead, to the same draws."""
        folder = _FOLDER.get()
        if folder is not None:
            return folder.fold(rng)
        seed = self.fold_seed(rng)
        self.move_on(rng)
        g = torch.Generator(device=rng.device)
        g.manual_seed(seed)
        return g

    @contextlib.contextmanager
    def folding(self, folder):
        """A context in which `fold_generator` hands each fold to
        ``folder.fold(rng)`` (the chunk driver's replayable folds,
        ``core/scan.py`` ``GraphFolds``)."""
        token = _FOLDER.set(folder)
        try:
            yield folder
        finally:
            _FOLDER.reset(token)

    def close(self) -> None:
        """Tear down the process group (every rank calls it); with a model
        axis every group of the mesh."""
        dist.destroy_process_group(self.group if self.model_size == 1
                                   else None)


def init_node_mesh(device="cuda", *, rank: Optional[int] = None,
                   world_size: Optional[int] = None,
                   init_method: Optional[str] = None,
                   model_parallel: int = 1,
                   timeout: Optional[timedelta] = None) -> NodeMesh:
    """Join the node mesh: rank and size from the arguments or the usual
    ``RANK`` / ``WORLD_SIZE`` variables, the rendezvous from
    `init_method` or ``env://`` (``MASTER_ADDR`` / ``MASTER_PORT``). On
    ``cuda`` the rank takes GPU `rank` (``torch.cuda.set_device``) and the
    group is NCCL; on ``cpu`` it is gloo. One all-reduce then runs on
    every rank, so the group's first call is a collective and a later P2P
    batch may involve only a pair.

    With `model_parallel` K > 1 the world is ``n_nodes x K`` ranks: every
    rank makes every model group and node group (``dist.new_group`` in
    the same order everywhere) and keeps its own two, and each group's
    first call is an all-reduce, model group then node group. `timeout`
    bounds every collective's wait (torch's default without it), so a
    rank whose peer never posts raises instead of waiting on."""
    dev = torch.device(device)
    rank = int(os.environ["RANK"]) if rank is None else int(rank)
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None \
        else int(world_size)
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a mesh of {world_size}")
    K = int(model_parallel)
    if K < 1 or world_size % K:
        raise ValueError(f"model_parallel={K} does not divide a mesh of "
                         f"{world_size} ranks into nodes")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a node mesh on cuda needs a GPU a rank; "
                               "none is available")
        if rank >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} needs GPU {rank}, but "
                               f"{torch.cuda.device_count()} are visible "
                               "(one node a GPU)")
        if not dist.is_nccl_available():
            raise RuntimeError("a node mesh on cuda needs NCCL, which this "
                               "torch lacks")
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"a node mesh runs on cuda (NCCL) or cpu (gloo), "
                         f"got {device!r}")
    kw = {"device_id": dev} if backend == "nccl" else {}
    if timeout is not None:
        kw["timeout"] = timeout
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, **kw)
    dist.all_reduce(torch.zeros((1,), device=dev))
    if K == 1:
        return NodeMesh(rank, world_size, dev)
    return _model_axis_mesh(rank, world_size, K, dev, timeout)


def _model_axis_mesh(rank: int, world_size: int, K: int,
                     dev: torch.device,
                     timeout: Optional[timedelta] = None) -> NodeMesh:
    """Rank `rank`'s NodeMesh of `world_size // K` nodes of K ranks, its
    groups made (every rank makes every group, in one order) and each
    group's first call a collective."""
    n_nodes = world_size // K
    model_groups = [dist.new_group(list(range(n * K, (n + 1) * K)),
                                   timeout=timeout)
                    for n in range(n_nodes)]
    node_groups = [dist.new_group(list(range(m, world_size, K)),
                                  timeout=timeout)
                   for m in range(K)]
    node, index = divmod(rank, K)
    mesh = NodeMesh(node, n_nodes, dev, node_groups[index], K, index,
                    model_groups[node])
    for g in (mesh.model_group, mesh.group):
        dist.all_reduce(torch.zeros((1,), device=dev), group=g)
    return mesh
