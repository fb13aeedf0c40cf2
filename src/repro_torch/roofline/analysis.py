"""Roofline analysis of a traced step (counterpart of
``repro/roofline/analysis.py``, which reads the same terms out of
compiled XLA).

The dry run (``launch/dryrun.py``) runs one step of the port under
``torch._subclasses.fake_tensor.FakeTensorMode``, where no tensor holds
memory, and counts as it goes:

* FLOPs, with ``torch.utils.flop_counter.FlopCounterMode`` (matrix
  products, as XLA's ``cost_analysis`` counts them);
* bytes, with :class:`TraceCounter`: every storage an operation returns
  is live from then until Python frees it, so the peak of their sum is
  the step's peak of allocated bytes (before the caching allocator's
  rounding and the libraries' workspaces, which allocate outside the
  dispatcher);
* collectives, also with :class:`TraceCounter`: the bytes of every
  ``c10d`` operation the rank posts, with the reference's accounting (an
  all-reduce counts twice, as a ring's reduce-scatter plus all-gather; an
  all-gather its whole result).

The terms divide those counts by the card's datasheet peaks
(``repro_torch/hardware.py``), never by a measurement.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch import hardware as HW

# the port's c10d operations -> the key each is counted under, its weight;
# any other counts its first argument once, under its own name
_COLLECTIVES = {"send": ("send", 1), "recv_": ("recv", 1),
                "allreduce_": ("all-reduce", 2),
                "allgather_": ("all-gather", 1)}


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


class TraceCounter(TorchDispatchMode):
    """Live and peak bytes of the storages the operations under it return,
    and the bytes of the collectives they post.

    `hold` registers storages that exist already (a step's arguments), so
    `live` starts at their sum. A storage counts once, from the operation
    that returned it (a view or an in-place result adds nothing) until it
    is freed. Outputs only: a kernel's internal scratch is not seen, and a
    custom operation (``kernels/ops.py``) counts as its outputs, whether it
    ran its plain version, launched its kernel or was fake."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.coll: dict = {}
        self._seen = WeakIdKeyDictionary()

    def hold(self, tree) -> int:
        """Count the storages of `tree`'s tensors as live; -> live bytes."""
        for t in _tensors(tree):
            self._add(t.untyped_storage())
        return self.live

    def _free(self, n: int) -> None:
        self.live -= n

    def _add(self, storage) -> None:
        if storage in self._seen:
            return
        n = storage.nbytes()
        self._seen[storage] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(storage, self._free, n)

    def _count_collective(self, func, args) -> None:
        kind, weight = _COLLECTIVES.get(func._opname, (func._opname, 1))
        # the first argument: the tensors sent, received or reduced, or an
        # all-gather's output lists (its whole result)
        ts = _tensors(args[0])
        n = weight * sum(t.numel() * t.element_size() for t in ts)
        self.coll[kind] = self.coll.get(kind, 0) + n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "c10d":
            self._count_collective(func, args)
        out = func(*args, **kwargs)
        for t in _tensors(out):
            self._add(t.untyped_storage())
        return out


def sent_bytes(coll: dict) -> int:
    """Bytes a rank puts on its links by `coll` (a :class:`TraceCounter`'s
    collectives): everything but what it receives."""
    return sum(v for k, v in coll.items() if k != "recv")


def model_flops(cfg, shape, kind: str) -> float:
    """'Useful' flops per step: 6·N_active·tokens (train), 2·N_active·tokens
    (prefill/decode). KV-cache attention reads are excluded (documented)."""
    n_active = cfg.n_active_params()
    if kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch  # decode: one token per sequence
    return 2.0 * n_active * tokens


def peak_flops(dtype: str) -> float:
    """The card's matrix peak for a model in `dtype`: bf16 on the tensor
    cores; fp32 outside them (the port turns TF32 off)."""
    return HW.PEAK_FLOPS_FP32 if dtype == "float32" else HW.PEAK_FLOPS_BF16


def link_bw(n_devices: int) -> float:
    """The slowest link a mesh of `n_devices` GPUs, one node each, may
    cross: NVLink within one host of 8, one NDR InfiniBand port beyond."""
    return HW.NVLINK_BW if n_devices <= HW.GPUS_A_HOST else HW.IB_NDR_BW


def model_group_bytes(rec: dict) -> int:
    """The bytes a dry-run record's rank puts on the model group's links:
    its all-reduces' and its all-gathers' (0 off the model axis)."""
    return rec.get("model_allreduce_bytes_per_dev", 0) + \
        rec.get("model_allgather_bytes_per_dev", 0)


def roofline_terms(flops: float, n_bytes: float, coll_bytes: float,
                   dtype: str, n_devices: int, model_coll_bytes: float = 0,
                   model_parallel: int = 1) -> dict:
    """The three terms in seconds and the largest: FLOPs over the matrix
    peak, bytes over the HBM rate, collective bytes over the link. Of
    `coll_bytes`, the model group's `model_coll_bytes` (a node's
    `model_parallel` GPUs, neighbours on the mesh's minor axis) cross the
    slowest link that many GPUs may cross, NVLink within one host; the
    rest the slowest link the mesh of `n_devices` may cross."""
    node_bytes = coll_bytes - model_coll_bytes
    terms = {"compute": flops / peak_flops(dtype),
             "memory": n_bytes / HW.HBM_BW,
             "collective": (node_bytes / link_bw(n_devices) if node_bytes
                            else 0.0) +
             (model_coll_bytes / link_bw(model_parallel)
              if model_coll_bytes else 0.0)}
    return {"compute_s": terms["compute"], "memory_s": terms["memory"],
            "collective_s": terms["collective"],
            "bottleneck": max(terms, key=terms.get)}
