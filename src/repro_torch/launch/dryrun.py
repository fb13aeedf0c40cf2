"""Dry run of the port (counterpart of ``repro/launch/dryrun.py``): size
one (arch × input shape) at full width and depth without running it.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-4b \\
      --shape train_4k --mesh single --quantize --out results/dryrun_torch
  PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu \\
      --arch transformer-wmt --shape train_4k --nodes-per-gpu 8 \\
      --batch 4 --seq 128 --quantize      # the one-card main path

The reference lowers its program on 512 placeholder devices. Here the
port's own step runs once under ``FakeTensorMode``: every tensor carries
the device named by ``--device`` (default ``cuda``) and holds no memory,
so the step allocates nothing on any device and no kernel runs (the three
kernels' fake implementations, ``kernels/ops.py``, give their outputs'
shapes). The step is built by the drivers' own code:

* a training shape traces one superstep of ``launch/train.py`` ``build``
  (``Trainer.superstep``). ``--mesh single|multi`` keeps the reference's
  node counts (16 or 32; 1 or 2 for a ``big_model``, ``specs.py``
  ``n_nodes_for``), one node a GPU: the step is rank 0's on a node mesh
  (``launch/mesh.py``) whose other ranks are torch's ``fake`` process
  group, whose collectives return at once. ``--nodes-per-gpu N`` is the
  layout ``launch/train.py`` runs: N nodes stacked on one GPU. The global
  batch splits as the reference's ``train_input_specs``: ``b_local =
  global_batch // (n_nodes · H)`` a node and local step;
* ``--model-parallel K`` splits each node over K GPUs, the reference's
  own layout (``specs.py``: a node is a 16-chip "model" row): the mesh
  is ``n_nodes x K`` ranks (``launch/mesh.py``), the step is model index 0
  of node 0, its parameters and state that GPU's slices
  (``models/split.py``), and the model group's all-reduces and
  all-gathers (a MoE layer's experts split by expert) count into
  ``coll_bytes_per_dev`` (apart too: ``model_allreduce_bytes_per_dev``,
  ``model_allgather_bytes_per_dev``), priced at the model group's own
  link. Dense and MoE archs only; the rest raise, naming their
  ROADMAP.md item. ``--layers N`` cuts the depth to N layers (the widths
  stay);
* a serving shape traces one GPU's prefill or decode step
  (``launch/serve.py`` ``make_serve_fns``) with its KV cache or SSM state.
  The batch splits over the node groups, data-parallel replicas of the
  mean model (the reference's ``batch_axes_for(role="serve")``: every
  axis but "model"): ``global_batch / n_nodes`` sequences a node group,
  and ``--batch`` gives that share. At ``--model-parallel K`` a node group
  is K GPUs and the step is model index 0 of node 0 on ``fake_world``, its
  parameters and cache that GPU's slices (the cache's kv heads
  ``init_cache(..., tp=)``'s), and the model group's collectives
  (all-reduces, the logits' all-gather) counted as in training. Batch 1
  (``long_500k``) stays whole on one node group (the reference shards
  that cache's sequence over "data"; the port has no counterpart). A
  pure full-attention arch gives the reference's ``skipped`` record for
  ``long_500k``.

On the card the step's tensors hold nothing, but torch's fake mode
touches the device itself: it probes the CUDA context with a one-element
tensor as it makes a fake CUDA tensor, and computes a host constant moved
to the device (a step's learning rate) for real. Both are freed at once:
``device_allocated_bytes`` is the card's peak in the run (one 512 B
allocator block in the runs measured) and ``device_allocated_after_bytes``
what stays (0).

The trace stops where the driver would read a device value on the host
(a superstep's metrics). It counts (``roofline/analysis.py``): FLOPs
(``FlopCounterMode``), the state's bytes (``argument_bytes``: params,
optimizer state, comm copy, in-flight wire, residual; a serving step's
params and cache), the peak of live bytes (``temp_bytes`` = peak less the
arguments) and the collectives the rank posts (``coll_bytes_per_dev``;
``wire_bytes_per_node`` is the transport's ``payload_num_bytes``). From
those, against ``repro_torch/hardware.py``'s datasheet peaks: the three
roofline terms, the bottleneck, and ``fits`` (the peak against the card's
79.18 GiB). One JSON record a run, the reference's field names where they
mean the same.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import sys
import time

import torch

from repro_torch import hardware as HW
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.configs.base import InputShape
from repro_torch.roofline import analytic as A
from repro_torch.roofline.analysis import (
    TraceCounter, model_flops, model_group_bytes, roofline_terms,
    sent_bytes,
)

DEFAULT_H = 2
MESH_KINDS = ("single", "multi")
SKIP_LONG = "pure full-attention arch (see DESIGN.md §5)"
NO_SEQ_SHARDING = ("batch 1 stays whole on one GPU: the reference shards "
                   "this cache's sequence over its 'data' axis, which the "
                   "port has no counterpart for")


# the reference's production meshes (``launch/mesh.py``
# ``make_production_mesh``)
PRODUCTION_MESHES = {"single": {"data": 16, "model": 16},
                     "multi": {"pod": 2, "data": 16, "model": 16}}


def n_nodes_for(cfg, mesh_kind: str) -> int:
    """Nodes of the reference's production mesh (``launch/specs.py``
    ``n_nodes_for``): one a 16-chip data row, 16 a pod and 32 on two pods;
    a ``big_model`` node is a whole pod. In the port a node is one GPU,
    or K with ``--model-parallel K``."""
    from repro_torch.launch.specs import n_nodes_for as nodes_of
    return nodes_of(cfg, PRODUCTION_MESHES[mesh_kind])


def node_batch(shape: InputShape, n_nodes: int, H: int) -> int:
    """Sequences a node takes a local step (``specs.py:135``)."""
    b_local = shape.global_batch // (n_nodes * H)
    if b_local < 1:
        raise ValueError(f"{shape.name}: global_batch {shape.global_batch}"
                         f" < n_nodes*H = {n_nodes * H}")
    return b_local


def serve_batch(shape: InputShape, n_groups: int) -> int:
    """Sequences one node group serves: the batch split over the groups
    (whole on one group for batch 1)."""
    if shape.global_batch == 1:
        return 1
    if shape.global_batch % n_groups:
        raise ValueError(f"{shape.name}: global_batch {shape.global_batch} "
                         f"does not split over {n_groups} node groups")
    return shape.global_batch // n_groups


@functools.cache
def _record_stream_meta():
    """A no-op meta kernel for ``Tensor.record_stream`` (the overlapped
    permute's side stream, on the card): a fake tensor has no memory for
    the allocator to hold back. Registered once a process."""
    lib = torch.library.Library("aten", "IMPL")
    lib.impl("record_stream", lambda self, stream: None, "Meta")
    return lib


def fake_mode():
    """A FakeTensorMode that refuses an operation with no fake or meta
    implementation, where by default it would run the real kernel on zeros
    of the inputs' shapes, on their device."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    _record_stream_meta()
    return FakeTensorMode(allow_fallback_kernels=False)


class HostFolds:
    """The mesh's folds of the run's generator (``NodeMesh.
    fold_generator``), its state read on the host outside the fake mode
    (a generator is real; reading its state is not a device read)."""

    def __init__(self, mesh):
        self.mesh = mesh

    def fold(self, rng):
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        with unset_fake_temporarily():
            seed = self.mesh.fold_seed(rng)
        self.mesh.move_on(rng)
        g = torch.Generator(device=rng.device)
        g.manual_seed(seed)
        return g


@contextlib.contextmanager
def fake_world(n_nodes: int, device: str, model_parallel: int = 1):
    """Rank 0 of a node mesh of `n_nodes` (of `model_parallel` GPUs each)
    whose other ranks are torch's ``fake`` process group (collectives
    return at once); -> its NodeMesh, folding through
    :class:`HostFolds`."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import NodeMesh
    K = int(model_parallel)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_nodes * K)
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", 0)
        if K == 1:
            mesh = NodeMesh(0, n_nodes, dev)
        else:
            model = dist.new_group(list(range(K)))
            node = dist.new_group(list(range(0, n_nodes * K, K)))
            mesh = NodeMesh(0, n_nodes, dev, node, K, 0, model)
        with mesh.folding(HostFolds(mesh)):
            yield mesh
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _counting(counter: TraceCounter):
    """FLOPs and bytes of what runs inside; -> the flop counter."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc, counter:
        yield fc


def train_argv(arch: str, n_nodes: int, H: int, batch: int, seq: int,
               device: str, gossip_impl: str, quantize: bool,
               nonblocking: bool, overlap: bool, h_mode: str,
               h_max: int) -> list:
    """The training driver's flags for one superstep of the dry run."""
    argv = ["--arch", arch, "--nodes", str(n_nodes), "--H", str(H),
            "--steps", "1", "--batch", str(batch), "--seq", str(seq),
            "--device", device, "--gossip-impl", gossip_impl,
            "--h-mode", h_mode, "--h-max", str(h_max)]
    return argv + [f for f, on in (("--quantize", quantize),
                                   ("--nonblocking", nonblocking),
                                   ("--overlap", overlap)) if on]


def lone_node_graph():
    """The interaction graph of one node, which every graph builder
    refuses (an isolated node): no edge, so its matching is the identity
    and the node exchanges with itself, as the reference's dry run builds
    a one-node step (``static_pairs = [(0, 0)]``)."""
    import numpy as np
    from repro_torch.core.graph import Graph
    return Graph("lone", 1, np.zeros((0, 2), np.int32), 0, 0.0)


def trace_train(cfg, argv: list, mesh=None) -> dict:
    """One superstep of ``launch/train.py`` ``build`` (on `mesh` when
    given) under the fake mode; -> the counts."""
    from repro_torch.core import bucket as B
    from repro_torch.core.exchange import transport_from_config
    from repro_torch.core.scan import _state_leaves
    from repro_torch.launch import train
    from repro_torch.models import layers
    args = train.build_parser().parse_args(argv)
    graph = lone_node_graph() if args.nodes == 1 else None
    counter = TraceCounter()
    constants = dict(B._CONSTANTS)
    try:
        with fake_mode():
            tr = train.build(args, cfg, mesh=mesh, graph=graph)
            state = _state_leaves(tr.state)
            arg_bytes = counter.hold(state)
            # one node's gossip send: the codec's declared layout
            n_wire = transport_from_config(tr.scfg, tr.graph, args.seed) \
                .payload_num_bytes(tr.state.params, quantize=args.quantize)
            del state
            layers.COLLECTIVES = model_coll = {}
            with _counting(counter) as fc:
                tr.superstep(0)
    finally:
        layers.COLLECTIVES = None
        # the fake constants the trace cached do not outlive it
        B._CONSTANTS.clear()
        B._CONSTANTS.update(constants)
    return {"flops": float(fc.get_total_flops()), "argument_bytes": arg_bytes,
            "peak_bytes": counter.peak, "coll": dict(counter.coll),
            "wire_bytes": n_wire, "h": [int(h) for h in tr.hs[0]],
            "model_coll": model_coll}


def trace_serve(cfg, kind: str, batch: int, seq: int, device: str,
                mesh=None) -> dict:
    """One GPU's prefill (`batch` prompts of `seq`) or decode step (`batch`
    tokens over a cache of `seq`) of ``launch/serve.py``
    ``make_serve_fns`` under the fake mode (on `mesh`'s model axis this
    GPU's slices and cache); -> the counts."""
    from repro_torch.launch.serve import make_generators, make_serve_fns
    from repro_torch.models import init_cache, init_params, layers
    from repro_torch.models.multimodal import synth_prefix_embeds
    tp = None if mesh is None else mesh.model_shard
    prefill, decode_step = make_serve_fns(cfg, tp)
    gens = make_generators(0, device)
    counter = TraceCounter()
    try:
        with fake_mode():
            params = init_params(gens["init"], cfg, device, tp=tp)
            if kind == "prefill":
                inputs = [torch.zeros((batch, seq), dtype=torch.int32,
                                      device=device)]
                if cfg.frontend is not None:
                    inputs.append(synth_prefix_embeds(gens["prefix"], cfg,
                                                      batch, device))
                arg_bytes = counter.hold([params, inputs])
                layers.COLLECTIVES = model_coll = {}
                with _counting(counter) as fc:
                    prefill(params, *inputs)
            else:
                cache = init_cache(cfg, batch, seq, device=device, tp=tp)
                tokens = torch.zeros((batch, 1), dtype=torch.int32,
                                     device=device)
                arg_bytes = counter.hold([params, cache, tokens])
                layers.COLLECTIVES = model_coll = {}
                with _counting(counter) as fc:
                    decode_step(params, cache, tokens)
    finally:
        layers.COLLECTIVES = None
    return {"flops": float(fc.get_total_flops()), "argument_bytes": arg_bytes,
            "peak_bytes": counter.peak, "coll": dict(counter.coll),
            "wire_bytes": None, "model_coll": model_coll}


def _device_allocated(device: str):
    """(the card's peak of allocated bytes in this process, what stays
    allocated), or (None, None) off the card."""
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        return None, None
    return (int(torch.cuda.max_memory_allocated()),
            int(torch.cuda.memory_allocated()))


def run_one(arch: str, shape_name: str, mesh_kind: str = "single", *,
            gossip_impl: str = "gather", quantize: bool = False,
            nonblocking: bool = False, overlap: bool = False,
            H: int = DEFAULT_H, h_mode: str = "fixed", h_max: int = 8,
            nodes_per_gpu: int = None, nodes: int = None, batch: int = None,
            seq: int = None, device: str = "cuda", cfg=None,
            model_parallel: int = 1) -> dict:
    """The dry run of (arch, shape, mesh); -> its record. `nodes_per_gpu`
    stacks that many nodes on one GPU; `nodes` is a node mesh of that many
    nodes in place of the reference's count; `model_parallel` K splits
    each node over K GPUs (``models/split.py``). `cfg` replaces the arch's
    config (tests pass reduced ones); `batch` and `seq` replace the
    shape's per-node (training: a local step's) or per-node-group
    (serving) batch and its sequence (decode: the cache's length)."""
    cfg = cfg or get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    K = int(model_parallel)
    mesh_name = "one_card" if nodes_per_gpu else \
        f"{nodes}_gpus" if nodes else mesh_kind
    if K > 1:
        from repro_torch.models.split import check_model_parallel
        if nodes_per_gpu:
            raise ValueError("--model-parallel splits a node over GPUs; "
                             "--nodes-per-gpu stacks nodes on one")
        check_model_parallel(cfg, K)
        mesh_name += f"_tp{K}"
    head = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    if shape.name == "long_500k" and not cfg.subquadratic:
        return {**head, "skipped": SKIP_LONG}
    one_card = nodes_per_gpu is not None
    n_nodes = nodes_per_gpu if one_card else \
        nodes or n_nodes_for(cfg, mesh_kind)
    seq = seq or shape.seq_len
    rec = dict(head, kind=shape.kind, device=device,
               layout="one_card" if one_card else "node_a_gpu")
    t0 = time.time()
    if shape.kind == "train":
        b = batch or node_batch(shape, n_nodes, H)
        n_dev = 1 if one_card else n_nodes * K
        argv = train_argv(arch, n_nodes, H, b, seq, device, gossip_impl,
                          quantize, nonblocking, overlap, h_mode, h_max)
        world = contextlib.nullcontext() if one_card \
            else fake_world(n_nodes, device, K)
        with world as mesh:
            counts = trace_train(cfg, argv, mesh)
        g_shape = InputShape(shape.name, seq, b * n_nodes * H, "train")
        an_flops = A.train_flops(cfg, g_shape, H=H, remat=cfg.remat) / n_dev
        an_bytes = A.train_bytes_full(cfg, g_shape, n_nodes, H=H,
                                      remat=cfg.remat) / n_dev
        mf = model_flops(cfg, g_shape, "train") / n_dev
        rec.update(n_layers=cfg.n_layers, remat=cfg.remat,
                   gossip=gossip_impl, quantize=quantize,
                   nonblocking=nonblocking or overlap, overlap=overlap, H=H,
                   h_mode=h_mode, h_traced=counts["h"],
                   batch_per_node=b)
    else:
        groups = 1 if one_card or shape.global_batch == 1 else n_nodes
        n_dev = groups * K
        b = batch or serve_batch(shape, groups)
        world = contextlib.nullcontext() if K == 1 \
            else fake_world(groups, device, K)
        with world as mesh:
            counts = trace_serve(cfg, shape.kind, b, seq, device, mesh)
        g_shape = InputShape(shape.name, seq, b, shape.kind)
        an_flops = A.serve_flops(cfg, g_shape) / K
        an_bytes = A.serve_bytes(cfg, g_shape) / K
        mf = model_flops(cfg, g_shape, shape.kind) / K
        rec.update(batch_per_dev=b)
        if shape.global_batch == 1 and not one_card:
            rec["note"] = NO_SEQ_SHARDING
    model_coll = counts["model_coll"]
    rec.update(model_parallel=K,
               model_allreduce_bytes_per_dev=2 * model_coll.get("bytes", 0),
               model_allreduce_calls=model_coll.get("calls", 0),
               model_allgather_bytes_per_dev=model_coll.get("gather_bytes",
                                                            0),
               model_allgather_calls=model_coll.get("gather_calls", 0))
    if K > 1:
        from repro_torch.models.split import kv_deviation
        rec.update(layout="node_over_gpus",
                   kv_heads_whole=kv_deviation(cfg, K))
    t_trace = time.time() - t0
    flops = counts["flops"]
    coll = counts["coll"]
    coll_bytes = sent_bytes(coll)
    peak = counts["peak_bytes"]
    rec.update(
        n_devices=n_dev, n_nodes=n_nodes if shape.kind == "train" else None,
        seq_len=seq, t_trace_s=round(t_trace, 2),
        flops_per_dev=flops, flops_analytic_per_dev=an_flops,
        bytes_analytic_per_dev=an_bytes,
        coll_bytes_per_dev=coll_bytes, coll_raw=coll,
        wire_bytes_per_node=counts["wire_bytes"],
        **roofline_terms(flops, an_bytes, coll_bytes, cfg.dtype, n_dev,
                         model_group_bytes(rec), K),
        argument_bytes=counts["argument_bytes"],
        temp_bytes=peak - counts["argument_bytes"], peak_bytes=peak,
        fits=peak <= HW.HBM_CAPACITY, hbm_capacity_bytes=HW.HBM_CAPACITY,
        model_flops_per_dev=mf,
        useful_ratio=mf / flops if flops else None)
    rec["device_allocated_bytes"], rec["device_allocated_after_bytes"] = \
        _device_allocated(device)
    return rec


def record_tag(args) -> str:
    """The record's file name, as the reference tags its runs."""
    tag = f"{args.arch}__{args.shape}__{args.mesh}"
    for flag, on in ((f"npg{args.nodes_per_gpu}", args.nodes_per_gpu),
                     (f"n{args.nodes}", args.nodes),
                     (f"tp{args.model_parallel}", args.model_parallel > 1),
                     (f"l{args.layers}", args.layers),
                     (args.gossip_impl, args.gossip_impl != "gather"),
                     ("q8", args.quantize), ("nb", args.nonblocking),
                     ("ov", args.overlap),
                     (args.h_mode, args.h_mode != "fixed"),
                     (f"b{args.batch}", args.batch),
                     (f"s{args.seq}", args.seq), (args.tag, args.tag)):
        if on:
            tag += "__" + flag
    return tag


def build_parser() -> argparse.ArgumentParser:
    from repro_torch.core.exchange import GOSSIP_IMPLS
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(INPUT_SHAPES))
    ap.add_argument("--mesh", default="single", choices=MESH_KINDS,
                    help="the reference's node count (16 or 32; 1 or 2 "
                         "for a big_model), one node a GPU")
    ap.add_argument("--nodes-per-gpu", type=int, default=None,
                    help="N nodes stacked on one GPU, as launch/train.py "
                         "runs them (in place of --mesh's layout)")
    ap.add_argument("--nodes", type=int, default=None,
                    help="a node mesh of N nodes (in place of --mesh's "
                         "count)")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="K GPUs a node, its parameters split by "
                         "models/split.py (the reference's 'model' axis); "
                         "1: one node a GPU")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the arch's depth to N layers (its widths "
                         "stay)")
    ap.add_argument("--gossip-impl", default="gather", choices=GOSSIP_IMPLS)
    ap.add_argument("--quantize", action="store_true")
    ap.add_argument("--nonblocking", action="store_true")
    ap.add_argument("--overlap", action="store_true",
                    help="pipelined non-blocking superstep (implies "
                         "--nonblocking)")
    ap.add_argument("--H", type=int, default=DEFAULT_H)
    ap.add_argument("--h-mode", default="fixed",
                    choices=["fixed", "geometric"])
    ap.add_argument("--h-max", type=int, default=8)
    ap.add_argument("--batch", type=int, default=None,
                    help="sequences a node takes a local step (training) "
                         "or one node group serves, in place of the "
                         "shape's split")
    ap.add_argument("--seq", type=int, default=None,
                    help="sequence (decode: cache) length in place of the "
                         "shape's")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: the fake tensors' device")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="results/dryrun_torch")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    cfg = None
    if args.layers:
        import dataclasses
        cfg = dataclasses.replace(get_config(args.arch), n_layers=args.layers)
    res = run_one(args.arch, args.shape, args.mesh,
                  gossip_impl=args.gossip_impl, quantize=args.quantize,
                  nonblocking=args.nonblocking, overlap=args.overlap,
                  H=args.H, h_mode=args.h_mode, h_max=args.h_max,
                  nodes_per_gpu=args.nodes_per_gpu, nodes=args.nodes,
                  batch=args.batch,
                  seq=args.seq, device=args.device, cfg=cfg,
                  model_parallel=args.model_parallel)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, record_tag(args) + ".json")
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))
    print("wrote", path)
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
