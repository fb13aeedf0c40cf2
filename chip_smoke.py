#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # one H100; exits non-zero on any failure
    python3 chip_smoke.py --only multi_shard   # the node mesh's phases
                                               # alone (2 or more GPUs;
                                               # the model axis on 4)
    python3 chip_smoke.py --only dryrun        # the dry run against the
                                               # peaks it predicts

Phases, each printed on its own line:

1. the card, as ``nvidia-smi --query-gpu=name,power.limit`` gives it;
2. the build of every CUDA kernel from ``src/repro_torch/kernels/csrc``
   (one nvcc per source, in parallel), with its time;
3. each kernel against its plain PyTorch version on the card, at the main
   path's shapes (transformer-wmt, 8 nodes) and at ragged / q4 pack4 /
   q16 / average=False / matched-mask / bf16 / Nesterov+weight-decay
   variants: codes, scales and floats must match bitwise (the kernels are
   built with contraction off). Each kernel's time (CUDA events, median of
   20 runs) is printed beside its byte bound, the plain version's time and,
   for sgd_update, ``torch.optim.SGD(fused=True).step()``; sgd_update is
   also held in place (``inplace=True``, as the optimizer runs it on its
   packed copies), and that is the time reported, the out-of-place one
   beside it;
4. a small-input reference: three supersteps of a reduced model on the
   card (kernels), each restarted from the state the CPU (plain versions)
   reached before it, against the CPU's, from identical weights, batches,
   matchings and uniforms — blocking exact and q8, non-blocking q8 and
   overlapped q8 (the latter restarted with its in-flight payload), and
   overlapped q8 with geometric per-node local steps; planted faults of
   the exchange must fail the same bound;
5. the blocking main path: 4 supersteps of ``repro_torch.launch.train
   --arch transformer-wmt --nodes 8 --H 2 --quantize`` at full width and
   depth in bf16, with every launch counter at 0 just before; it asserts
   finite losses and exactly 8 / 4 / 4 launches of sgd_update /
   quantize_mod / decode_avg, and prints the superstep time, peak
   device memory and the q8 decodes beyond the lattice's reach;
   then ``remat``: the same command with the config's ``remat`` on (each
   of the 12 blocks recomputed in the backward pass, the default at full
   size) against off, bitwise under deterministic algorithms (losses and
   parameters after one superstep), and 4 supersteps a run in turns (on,
   off, off, on) for the superstep times and peaks, launches 8 / 4 / 4;
6. one exact-mode superstep, in which quantize_mod and decode_avg must not
   launch;
7. overlap exact: the overlapped exact run equals the non-blocking exact
   run bitwise on the card (3 supersteps, 8 nodes, transformer-wmt cut to
   2 layers at its full width, fp32), which a race of the side stream
   would break;
8. the overlapped main path: 4 supersteps of the same driver with
   ``--h-mode geometric --h-max 8 --quantize --nonblocking --overlap
   --non-iid 0.5 --eval-mean --ckpt --ckpt-every 4`` at full width, launch
   counters at 0 just before; it asserts finite loss, Γ and mean-model
   losses, sgd_update = Σ_t max_i h_{t,i} / quantize_mod 5 / decode_avg 4
   launches and the checkpoint's files, and prints superstep times, peak
   memory and checkpoint bytes (the checkpoint is deleted after);
9. a reduced checkpoint written on the card and reloaded bitwise;
10. the baselines' reference: all-reduce (full and masked), Local SGD
    (H 2), D-PSGD on a ring (full and masked), AD-PSGD exact non-blocking
    and q8 blocking and non-blocking (masked), SGP q8 — on the card
    against the CPU, three steps each restarted from the CPU's state (SGP
    also one step from a push-sum state whose w is not all 1), with
    planted faults that must fail the same bound: the mean over all nodes
    where the mask drops one, the unmasked W under a mask, SGP's w
    unmixed;
11. the baselines at full width: ``repro_torch.launch.train --algo
    allreduce``, ``--algo localsgd --H 2``, ``--algo dpsgd --graph ring``,
    ``--algo adpsgd --quantize --nonblocking`` and ``--algo sgp --quantize
    --eval-mean``, 4 supersteps each of transformer-wmt x 8 nodes, launch
    counters at 0 just before each; it asserts finite losses, launches
    4/0/0, 8/0/0, 4/0/0, 4/4/4 and 4/4/4, all-reduce's nodes bitwise
    equal and SGP's sum of w = 8, and prints each command's superstep
    times and peak memory;
12. the scheduler's reference: 8 nodes of the reduced model from
    distinct models under binned traces — lognormal (sigma 0.8) with a
    quarter of the nodes 8x slower, blocking exact and q8, non-blocking
    q8 and overlapped q8; a churn trace (``--avail``) with two join bins
    and two leaves, exact and q8; a ``hier:4`` trace, q8; AD-PSGD q8 —
    every card bin restarted from the CPU's state and held to the same
    bound, join bins bitwise; planted faults that must fail it: the bin's
    h given to non-participants, a join that keeps the joiner's own row;
13. ``--rate-profile uniform`` equals ``none`` bitwise on the card (3
    supersteps of transformer-wmt cut to 2 layers at full width, fp32,
    q8, deterministic algorithms);
14. the scheduled commands at full width: ``--quantize`` with
    ``--rate-profile lognormal --rate-sigma 0.8 --straggler 0.25:8``,
    the same overlapped, ``--rate-profile uniform_async --avail ...`` and
    ``--rate-profile lognormal --topology hier:4``, ``--steps 3`` (4 to 9
    bins) each, launch counters at 0 just before each run; it asserts
    finite losses, sgd_update = Σ_s max_i h_{s,i}, quantize_mod = the
    gossip bins, decode_avg = the gossip bins with a participant, no
    codec launch in a join bin, and prints bins, density, bin times, peak
    memory and the cost model's ``sched_cost`` (H100 datasheet figures).

15. the new codecs' reference: q2, q4, q16 non-blocking, bf16, top-k 0.25
    non-blocking (with its residual) and compress_state q8 on the card
    against the CPU, 3 supersteps of the reduced model each restarted from
    the CPU's state, held to each codec's bound (one lattice step; one
    bf16 step of the value; half top-k's largest shipped magnitude, and
    the residual likewise), with planted faults that must fail it (the
    average dropped, top-k's residual kept); compress_state's
    zero-reference encode and plain decode kernel against plain at the
    main path's shape, bitwise;
16. the codec commands at full width, 4 supersteps each: ``--quantize``
    with ``--codec q4``, ``--codec q16``, ``--codec bf16``, ``--codec
    topk:0.25 --nonblocking`` and ``--compress-state``; it asserts finite
    losses, launches 8/4/4, 8/4/4, 8/0/0, 8/0/0, 8/8/8 and the declared
    wire bytes per node, and prints superstep medians, peak memory, wire,
    comm-copy and residual bytes;
17. the transports' reference: ``ppermute`` and ``ppermute_pool`` (pool
    of 4) and the three ``*_legacy`` per-leaf oracles, exact and q8
    blocking, the two flat ppermute impls non-blocking and overlapped q8,
    and AD-PSGD q8 on the pool — on the card against the CPU, 3
    supersteps of the reduced model each restarted from the CPU's state,
    held to `phase_reference`'s bound (q8: one lattice step of the
    partner's row, a per-leaf oracle's rows as its per-leaf encode scaled
    them), planted faults failing it; then bitwise on the card: each flat
    exact impl equals its per-leaf oracle, ``ppermute_pool`` fed pool
    indices equals gather fed the matchings they select (q8), and the
    pool's chunked run (CUDA graphs gathering the matching from the
    stacked pool by the device index) equals its per-step run;
18. the transports at full width, 3 supersteps each of transformer-wmt x
    8 nodes: ``--quantize`` under ``--gossip-impl ppermute``, under
    ``ppermute_pool --nonblocking --overlap`` and under the
    ``gather_legacy`` oracle; launches 6/3/3, 6/3/3 and 6/0/0 (the
    per-leaf oracle's codec is plain torch), superstep times beside
    `main_path`'s median, peak memory, and the q8 decodes beyond the
    lattice's reach (``q8_wraps``, which `main_path` prints too);
19. the chunk driver's replay against the per-step driver, bitwise, on
    the card (CUDA graphs against eager; blocking q8, overlapped q8,
    overlapped geometric q8 whose graphs replay out of capture order,
    top-k non-blocking, a masked lognormal schedule and the five
    baselines; 6 supersteps of transformer-wmt cut to 2 layers at full
    width, bf16, deterministic algorithms, remat off; the blocking and
    geometric cases again with remat on, the recompute inside the
    captured backward pass), with equal launch counts, and what the
    captures leave in the graphs' shared pool traced to the cuBLAS
    workspaces;
20. ``--scan-chunk 4`` at full width, 8 supersteps: the blocking q8
    command (its supersteps 0-3 bitwise `main_path`'s records of the same
    call, beside that run's per-step median) and the overlapped geometric
    one, both on 8 nodes; launches Σ_t max_i h_{t,i} / 8 / 8, the
    second chunk's time per superstep, the graphs captured, their keys,
    the bytes their shared pool reserves and each command's peak
    allocated and reserved bytes;
21. serving's reference: transformer-wmt, olmo-1b and mamba2-780m cut to
    2 layers of d_model 32 (fp32), card against CPU from the same weights
    and prompts — prefill, teacher-forced decode, paged decode and ragged
    chunk logits and states within 2e-5, one-shot greedy tokens equal,
    the dense, paged (page 4) and chunked (chunk 4) engines' tokens equal
    the CPU's with no added shape signature; planted faults (the cache
    written at len + 1, a page table shifted by one page, padded chunk
    tokens with dt != 0) must fail the bound;
22. serving at full width and depth in bf16, transformer-wmt and
    mamba2-780m: ``repro_torch.launch.serve --batch 8 --prompt-len 512
    --gen 64`` (prefill ms, decode ms a token, finite logits), then the
    engine with 8 slots and 16 requests of 512 + 64 tokens four ways
    (dense blocking, dense --prefill-chunk 128, paged --page-size 16 with
    chunk 128, blocking with a hot swap after 8 decode steps): paged ==
    dense bitwise, the swap's first lanes bitwise the no-swap run's,
    nothing dropped, no added shape signature; it prints tokens/s,
    latency and TTFT p50/p99, peak memory, KV bytes dense and paged, and
    the chunked schedule's token agreement with blocking;
23. serving checkpoints of both full-width models, q8, q4 and bf16, and
    of granite-moe-3b-a800m (its expert leaves packed into the flat
    buffer), q8: quantize_mod 1 on export and decode_avg 1 on load per
    lattice codec (0 / 0 for bf16), the export bitwise the plain encode,
    the load bitwise a plain decode of the same wire, wire bytes the
    declared layout, greedy tokens those of the plain decode's weights,
    and the codec times at these shapes;
24. the follower and the live source: the port's driver writes two
    ``--compress-state`` checkpoints of transformer-wmt x 4 nodes,
    ``repro_torch.launch.serve --follow`` serves 8 requests from them, the
    two land one after the other beside a running engine that adopts both
    in order, and ``--source live`` serves across more than one
    generation (launches 8/9/8 for the training run, 0/0/0 serving, 6/0/0
    live);
25. the zoo's reference: chatglm3-6b, gemma3-4b, gemma3-27b,
    granite-moe-3b-a800m, qwen3-moe-30b-a3b, jamba-1.5-large-398b (8
    layers), paligemma-3b and musicgen-large at ``reduced`` (d_model 64,
    fp32, 4 nodes, sequences of 192 so that sliding-window layers take the
    band path): one blocking q8 superstep on the card against the CPU from
    the CPU's state, held to the reference's bound and the loss to 1e-4;
    the MoE routing choices that differ between card and CPU from the
    same weights (0 required); a planted fault, the router's aux loss
    dropped from the loss, must fail the bound;
26. granite-moe-3b-a800m at full width (40 experts top-8, vocab 49,155,
    bf16, fp32 momentum) cut to 4 layers, 4 nodes, ``--H 2 --quantize``,
    4 supersteps through the training driver: finite losses and router
    aux, launches 8 / 4 / 4, superstep times and peak memory;
27. the zoo served at full width and depth in bf16: granite-moe-3b-a800m
    (8 requests of 512 + 64 on 8 slots, 12 across the swap) and
    gemma3-4b (8 requests of 3072 + 32 on 4 slots: the rings wrap, the
    prefill takes the band path), dense blocking, chunked and paged + chunked, granite also with
    a hot swap: paged == dense and swap == no swap bitwise, no added shape
    signature, finite one-shot logits, tokens/s, TTFT, KV bytes and the
    chunked schedule's agreement with blocking; paligemma-3b served
    one-shot with its 256-row prefix, and refused by the engine;
28. the node mesh's reference (``multi_shard_reference``; 2 or more
    GPUs, 4 ranks on 4): one node a GPU, NCCL between them, the reduced
    cases of ``tests/test_torch_multishard.py`` — the flat exchange at
    every codec, masked and not, static and pool, the payload permutes,
    the per-leaf oracles, 3 supersteps of the reduced transformer-wmt
    engine blocking exact / q8, non-blocking and overlapped q8, each
    restarted from the CPU's state — and of
    ``tests/test_torch_multishard_gather.py`` — the gather exchange at
    every codec (exact, q4, q8, q16, bf16, top-k with its residual) by a
    matching and by SGP's cyclic shift, masked and not, the node mean
    and the dense mix, the per-leaf gather oracle, 3 restarted steps of
    the swarm on gather (blocking exact and q8, non-blocking top-k,
    overlapped q8, ``--compress-state`` q8) and of each baseline
    (all-reduce and D-PSGD masked, Local SGD, AD-PSGD q8 masked, SGP
    exact masked and q8), one join bin — against the CPU's one-shard
    port, within each codec's bound of `codecs_reference` (the join
    bitwise), with planted faults (a mask ignored, a partner off by one,
    a missed wait on the received tensors; a rank sending to
    ``perm[r]`` instead of to the ``j`` with ``perm[j] == r``, a mean
    over the rank's own row, the wrong row of ``W X``, a missed wait on
    the gather) failing it; and the long run: the mesh's mean model and
    checkpoint bitwise rank 0's one-card ones on its card, each rank's
    load its slab, the reduced gather q8 ``--scan-chunk 4`` run (CUDA
    graphs holding the rank's NCCL work) bitwise its per-step run and a
    chunked resume bitwise the uninterrupted run, with a save of the
    rank's row and a graph key without the peers planted to fail;
29. the node mesh at full width (``multi_shard_full_width``):
    transformer-wmt at full width and depth, one node a GPU, 4
    supersteps each of blocking q8 ``ppermute``, ``ppermute_pool
    --nonblocking --overlap`` q8, the ``ppermute_legacy`` oracle exact,
    blocking q8 ``gather`` (Algorithm 1 on the default transport),
    ``gather --nonblocking --codec topk:0.25``, ``gather
    --compress-state`` q8, ``--algo allreduce``, ``--algo localsgd --H
    2``, ``--algo dpsgd --graph ring``, ``--algo adpsgd --quantize`` and
    ``--algo sgp``; every exchange, node mean and dense mix bitwise rank
    0's rerun of it on one card through the one-shard path, flat exact
    bitwise its per-leaf oracle, SGP's sum of w the node count, launches
    8/4/4, 8/4/4, 8/0/0, 8/4/4, 8/0/0, 8/8/8, 4/0/0, 8/0/0, 4/0/0, 4/4/4,
    4/0/0 on every rank (``MS_WANT``); it prints superstep times, the
    NCCL time from post to landed (around the all-gather for the mean
    and the mix), wire bytes a node or all-gather bytes a rank, the
    GPUs' link, the overlapped command's ``permute_overlap``, peak
    memory, Γ and Γ's all-reduce time. Then ``--scan-chunk 4`` for 8
    supersteps of gather q8 blocking and of ``ppermute_pool`` overlapped
    q8 with geometric h, against the same command per step: replay ==
    eager bitwise on every rank, launches 16/8/8 and Σ_t h_t,rank / 8 /
    8, graphs and keys, pool bytes, peaks, both superstep times; at the
    gather command's chunk boundary ``--eval-mean`` (μ bitwise rank 0's
    one-card μ of the gathered state, the losses within 1e-6) and one
    mesh checkpoint (bytes, seconds to gather and to write, peaks),
    reloaded and resumed from bitwise in a new driver, built after the
    first was closed and the allocator's cache emptied. The ranks run
    with ``NCCL_GRAPH_REGISTER=0``, as the mesh's chunk driver asks. With
    one GPU both print
    ``{"phase": "multi_shard", "ran": false, "gpus": 1, "needs": 2}``
    and run nothing: a declared precondition (NCCL refuses two ranks on
    one GPU). The parent builds the kernels before it spawns the ranks,
    which load them. A clean gather q8 run of 2 supersteps on every rank
    is held to the dry run of ``--nodes <ranks>`` (as in 30). Then
    ``multi_shard_train_4k``: an olmo-1b ``train_4k`` node a GPU at full
    width and depth (the reference's `single` node batch, 8 x 4096 tokens
    a local step, H 2, blocking gather q8, remat on; only the node count
    is cut, 16 to the ranks), 2 supersteps: finite losses equal on every
    rank, launches 4 / 2 / 2 a rank, each rank's peak above its start
    within DRYRUN_BOUND of ``dryrun --nodes <ranks> --batch 8``. Then, on
    4 or more GPUs, ``tensor_parallel``: the model axis, 2 nodes x 2 GPUs
    (``init_node_mesh(..., model_parallel=2)``; with fewer GPUs the
    declared ``{"phase": "tensor_parallel", "ran": false, ...}`` line).
    First a reduced card-vs-CPU check: gemma3-4b and paligemma-3b's loss
    and gradients on each GPU's slices within 1e-5 of the CPU's one-GPU
    port, a whole leaf's gradient bitwise equal on a node's GPUs, with the
    MLP's row-parallel all-reduce dropped and a whole kv weight's gradient
    sum dropped planted to fail; 2 supersteps of gather exact (within
    2e-5 of the CPU's one-GPU 2-node run), gather q8 and ppermute q8 on
    the 2 x 2 mesh, whole leaves bitwise equal and every q8 encode bitwise
    the plain encode of the rank's own buffer. Then gemma3-4b ``train_4k``
    at full width and depth as 2 nodes x 2 GPUs (only the node count is
    cut, 16 to 2; the reference's `single` node batch, 8 x 4096 tokens a
    local step, where ``dryrun --nodes 2 --model-parallel 2 --batch 8``
    predicts it fits, else `multi`'s 4), H 2, blocking gather q8, remat
    on, 2 supersteps: finite losses the same on every rank, launches
    4 / 2 / 2 a rank, the model group's all-reduces (count, bytes, time),
    each rank's peak above its start within DRYRUN_BOUND of the
    prediction, whole leaves bitwise equal on each node's GPUs. With
    ``--only multi_shard`` phase 3 runs first and the kernels' line
    follows, its launches the ``tensor_parallel`` run's;
30. the dry run (``dryrun``, after phase 22; alone with ``--only
    dryrun``): ``repro_torch.launch.dryrun`` traces `main_path`'s
    command, `scan_full_width`'s overlapped geometric one and phase 22's
    decode step on fake CUDA and fake CPU tensors, one process each: the
    counted fields equal, the card holding at most DRYRUN_TOUCH_BYTES
    during a trace and 0 B after, and each predicted peak within
    DRYRUN_BOUND of what its phase measured (a training command's peak
    allocated; the decode step's allocation above its start).

The card's line is printed again before the kernels' JSON record, which
is the line before the last; the last line is
``{"ok": true, "device": {...}}``. With no CUDA device, or without the rest
of the repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")
TPU_KERNELS = {
    "sgd_update": "src/repro/kernels/sgd_update.py:43",
    "quantize_mod": "src/repro/kernels/quantize_mod.py:48",
    "decode_avg": "src/repro/kernels/decode_avg.py:66",
}
SOURCES = {n: f"src/repro_torch/kernels/csrc/{n}.cu" for n in TPU_KERNELS}


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


PHASE_LOG = os.path.join(OUT_DIR, "chip_smoke_phases.jsonl")
# what the phases the dry run predicts measured: name -> bytes allocated
# above the phase's start at its peak (`phase_dryrun`)
MEASURED_PEAKS: dict = {}


def log(phase, **kw):
    """Print a phase's JSON line, and keep it in PHASE_LOG as well, so a
    long run's first lines survive when only the end of its output is kept."""
    line = json.dumps({"phase": phase, **kw})
    print(line, flush=True)
    with open(PHASE_LOG, "a") as f:
        f.write(line + "\n")


def time_ms(fn, reps: int = 20) -> float:
    """Median of `reps` CUDA-event-timed calls, after two warm-up calls."""
    import torch
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound(n_bytes: int, n_ops: int):
    """The least time (ms) the card could take: the larger of the bytes
    over the HBM rate and the fp32 operations over the fp32 peak (the
    datasheet figures of ``repro_torch/hardware.py``)."""
    from repro_torch import hardware as HW
    t_bytes = n_bytes / HW.HBM_BW * 1e3
    t_ops = n_ops / HW.PEAK_FLOPS_FP32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def same_bits(a, b) -> bool:
    """Bitwise equality of two tensors (any dtype, uint16 included)."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[a.element_size()]
    return torch.equal(a.contiguous().view(view), b.contiguous().view(view))


def bitwise(kernel_out, plain_out, what: str) -> float:
    """Hold a kernel's output to its plain version's, bit for bit; -> the
    max abs error (0.0: anything else fails the phase, naming the error)."""
    import torch
    if same_bits(kernel_out, plain_out):
        return 0.0
    a, b = (x.view(torch.int16).to(torch.int32) & 0xFFFF
            if x.dtype == torch.uint16 else x.float()
            for x in (kernel_out, plain_out))
    err = float((a - b).abs().max()) if a.shape == b.shape else math.inf
    raise PhaseError(f"{what}: kernel != plain (max abs err {err})")


def main_path_layout(n_nodes: int):
    """The flat-buffer layout of the main path (transformer-wmt, full
    width, node-stacked), built from meta tensors."""
    from repro_torch.configs import get_config
    from repro_torch.sched.cost import model_layout
    cfg = get_config("transformer-wmt")
    return cfg, model_layout(cfg, n_nodes=n_nodes)


def phase_kernels():
    """Every kernel against its plain version on the card; -> records."""
    import torch
    from repro_torch.kernels import ops, ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n_nodes = 8
    _, layout = main_path_layout(n_nodes)
    n_padded = layout.n_padded
    rows = n_nodes * n_padded // 256
    records = {}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    # -- sgd_update ------------------------------------------------------
    p, g, m = (randn(n_nodes * n_padded // 512, 512) for _ in range(3))
    lr = torch.tensor(0.05, device=dev)
    kp, km = ops.sgd_fused_update(p, g, m, lr=lr, mu=0.9)
    rp, rm = ref.sgd_update(p, g, m, lr=lr, mu=0.9)
    errs = [bitwise(kp, rp, "sgd_update p' (main-path shape)"),
            bitwise(km, rm, "sgd_update m' (main-path shape)")]
    del kp, km
    # in place, as the optimizer runs it on its packed copies
    pi, mi = p.clone(), m.clone()
    kp, km = ops.sgd_fused_update(pi, g, mi, lr=lr, mu=0.9, inplace=True)
    check(kp.data_ptr() == pi.data_ptr() and km.data_ptr() == mi.data_ptr(),
          "sgd_update inplace=True did not write into p and m")
    errs += [bitwise(kp, rp, "sgd_update p' in place (main-path shape)"),
             bitwise(km, rm, "sgd_update m' in place (main-path shape)")]
    del kp, km, rp, rm
    ms = time_ms(lambda: ops.sgd_fused_update(pi, g, mi, lr=lr, mu=0.9,
                                              inplace=True))
    del pi, mi
    out_of_place_ms = time_ms(lambda: ops.sgd_fused_update(p, g, m, lr=lr,
                                                           mu=0.9))
    plain_ms = time_ms(lambda: ref.sgd_update(p, g, m, lr=lr, mu=0.9))
    n = p.numel()
    b_ms, b_by = bound(5 * 4 * n, 4 * n)
    # the one PyTorch call with the same semantics (after its first step,
    # which seeds the buffer with g instead of mu*0 + g)
    w = p.clone()
    w.grad = g
    opt = torch.optim.SGD([w], lr=0.05, momentum=0.9, fused=True)
    opt.step()
    lib_ms = time_ms(opt.step)
    del w, opt
    for mu, wd, nest, size in ((0.9, 1e-4, True, 3 * 512 * 8 + 100),
                               (0.0, 0.0, False, 1000),
                               (0.9, 5e-4, False, 512 * 8)):
        a, b, c = (randn(size) for _ in range(3))
        kp, km = ops.sgd_fused_update(a, b, c, lr=lr, mu=mu, wd=wd,
                                      nesterov=nest)
        rp, rm = ref.sgd_update(a, b, c, lr=lr, mu=mu, wd=wd, nesterov=nest)
        what = f"sgd_update (mu={mu} wd={wd} nesterov={nest} n={size})"
        errs += [bitwise(kp, rp, what), bitwise(km, rm, what)]
    records["sgd_update"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=b_by, library_ms=lib_ms,
                                 max_abs_err=max(errs),
                                 out_of_place_ms=out_of_place_ms,
                                 shape=list(p.shape))
    log("kernel", name="sgd_update", **records["sgd_update"])
    del p, g, m

    # -- quantize_mod / decode_avg at the main-path shape (q8, node mask) --
    x = randn(rows, 256)
    r = x + 0.01 * randn(rows, 256)
    u = torch.rand((rows, 256), generator=gen, device=dev)
    kq, ks, _ = ops.quantize_mod(x, r, u)
    rq, rs = ref.quantize_mod(x, r, u)
    q_errs = [bitwise(kq, rq, "quantize_mod codes (main-path shape, q8)"),
              bitwise(ks, rs, "quantize_mod scales (main-path shape, q8)")]
    del rq, rs
    ms = time_ms(lambda: ops.quantize_mod(x, r, u))
    plain_ms = time_ms(lambda: ref.quantize_mod(x, r, u))
    b_ms, b_by = bound(nbytes(x, r, u, kq, ks), 7 * x.numel())
    records["quantize_mod"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                   bound_by=b_by, library_ms=None,
                                   shape=[rows, 256])

    matched = (torch.arange(n_nodes, device=dev) % 4 != 3) \
        .repeat_interleave(rows // n_nodes)
    y = r
    kd = ops.decode_avg(kq, ks, y, matched=matched)
    rd = ref.decode_avg(kq, ks, y, matched=matched)
    d_errs = [bitwise(kd, rd, "decode_avg (main-path shape, q8, mask)")]
    del kd, rd
    ms = time_ms(lambda: ops.decode_avg(kq, ks, y, matched=matched))
    plain_ms = time_ms(lambda: ref.decode_avg(kq, ks, y, matched=matched))
    b_ms, b_by = bound(nbytes(kq, ks, y, matched) + nbytes(y),
                       9 * y.numel())
    records["decode_avg"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=b_by, library_ms=None,
                                 shape=[rows, 256])
    del x, r, u, y, kq, ks, matched

    # -- variants: ragged, q4 pack4, q16, average=False, bf16 y, no mask --
    for bits, size, y_dtype, average, masked in (
            (8, 256 * 37 + 5, torch.float32, True, True),
            (4, 256 * 64, torch.float32, True, True),
            (2, 256 * 24 + 100, torch.bfloat16, False, False),
            (16, 256 * 64, torch.float32, True, True),
            (12, 256 * 40, torch.bfloat16, True, False),
            (8, 256 * 64, torch.float32, False, False),
            (8, 256 * 64, torch.bfloat16, True, True)):
        pack4 = bits <= 4
        xs = randn(size)
        rs_ = xs + 0.02 * randn(size)
        us = torch.rand((size,), generator=gen, device=dev)
        kq, ks, pad = ops.quantize_mod(xs, rs_, us, bits=bits, pack4=pack4)
        xb, _ = ops._to_blocks(xs, 256, 8)
        rb, _ = ops._to_blocks(rs_, 256, 8)
        ub, _ = ops._to_blocks(us, 256, 8)
        rq, rsc = ref.quantize_mod(xb, rb, ub, bits=bits, pack4=pack4)
        what = f"quantize_mod (bits={bits} size={size})"
        q_errs += [bitwise(kq, rq, what), bitwise(ks, rsc, what)]
        ys = rs_.to(y_dtype)
        mk = (torch.arange(kq.shape[0], device=dev) % 3 != 0) \
            if masked else None
        kd = ops.decode_avg(kq, ks, ys, bits=bits, pack4=pack4,
                            average=average, matched=mk)
        yb, _ = ops._to_blocks(ys, 256, 8)
        rd = ref.decode_avg(kq, ks, yb, bits=bits, pack4=pack4,
                            average=average, matched=mk).reshape(-1)
        rd = rd[:rd.numel() - pad] if pad else rd
        d_errs.append(bitwise(
            kd, rd.reshape(ys.shape),
            f"decode_avg (bits={bits} size={size} {y_dtype} "
            f"average={average} masked={masked})"))
    records["quantize_mod"]["max_abs_err"] = max(q_errs)
    records["decode_avg"]["max_abs_err"] = max(d_errs)
    log("kernel", name="quantize_mod", **records["quantize_mod"])
    log("kernel", name="decode_avg", **records["decode_avg"])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return records


def _recording_classes(fault: str = ""):
    """(Codec, Transport): the q8 lattice codec remembering the scale and
    codes of every encode, and a transport of any impl; `fault` plants a
    known-wrong exchange, to show the reference's bounds reject it:
    "one_step_off" (every received code one lattice step up, flat q8) or
    "average_dropped" (a node takes its partner's model: exact, the codec's
    plain decode when quantized, or a per-leaf oracle's exchange)."""
    import torch
    from repro_torch.core.exchange import GossipTransport
    from repro_torch.quant.codecs import LatticeCodec
    from repro_torch.quant.schemes import ModularQuantConfig
    from repro_torch.tree import tree_map

    class Codec(LatticeCodec):
        def __init__(self):
            super().__init__(ModularQuantConfig())
            self.scales, self.codes = [], []

        def encode(self, *a, **kw):
            q, sc = super().encode(*a, **kw)
            self.scales.append(sc.reshape(-1).cpu())
            self.codes.append(q.reshape(-1).cpu())
            return q, sc

        def decode_avg(self, wire, ybuf, matched_rows=None, **kw):
            q, sc = wire
            if fault == "average_dropped":
                return self.decode(wire, ybuf, **kw)
            if fault == "one_step_off":
                q = ((q.to(torch.int32) + 1) % 256).to(torch.uint8)
            return super().decode_avg((q, sc), ybuf, matched_rows, **kw)

    class Transport(GossipTransport):
        def mix_pair(self, tree, perm, matched, *, quantize=False, **kw):
            if fault == "average_dropped" and (not quantize or self.legacy):
                node_perm, _ = self.resolve_perm(perm)
                return tree_map(lambda x: x[node_perm], tree)
            return super().mix_pair(tree, perm, matched, quantize=quantize,
                                    **kw)
    return Codec, Transport


def _reduced_engine(device, quantize: bool, fault: str = "",
                    mode: str = "blocking", h_mode: str = "fixed", cfg=None):
    """A superstep of a reduced transformer-wmt swarm (or of `cfg`) on
    `device` in
    `mode` (blocking | nonblocking | overlap) with fixed or geometric
    local-step counts (h_max 4), its q8 codec (which
    remembers the scale of every encode) and a function that runs
    superstep t from a state on any device. `fault` plants a known-wrong
    exchange, to show the reference's bounds reject it: "one_step_off"
    (every received code one lattice step up) or "average_dropped" (a node
    takes its partner's model)."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.swarm import SwarmConfig, SwarmState
    from repro_torch.core.swarm import make_swarm_step
    from repro_torch.models import TransformerLM
    from repro_torch.optim import make_optimizer

    Codec, Transport = _recording_classes(fault)
    cfg = cfg or reduced(get_config("transformer-wmt"), n_layers=1,
                         d_model=64)
    codec = Codec()
    opt = make_optimizer("sgd", lr=0.05, momentum=0.9)
    scfg = SwarmConfig(n_nodes=4, H=2, quantize=quantize,
                       nonblocking=mode != "blocking",
                       overlap=mode == "overlap", h_mode=h_mode, h_max=4)
    step = make_swarm_step(scfg, TransformerLM(cfg).functional_loss,
                           opt.update, lambda s: 0.05,
                           transport=Transport(4, codec=codec))

    def move(x):
        if x is None or isinstance(x, torch.Tensor):
            return None if x is None else x.to(device)
        if isinstance(x, tuple):
            return tuple(move(v) for v in x)
        return {k: move(v) for k, v in x.items()}

    def run(state, t, inputs):
        perms, batches, us, hs = inputs
        state = SwarmState(move(state.params), move(state.opt),
                           move(state.prev), t, move(state.inflight))
        batch = {k: torch.from_numpy(v[t]).to(device)
                 for k, v in batches[scfg.h_loop_bound].items()}
        return step(state, batch, perms[t], hs[h_mode][t], None,
                    u=torch.from_numpy(us[t]).to(device))

    return run, codec, opt, scfg


def _readings(card_params, cpu_params, scales, perm):
    """The card's parameters after one superstep against the CPU's: max
    abs difference, share within 2e-5 and, for q8, the max difference in
    units of its row's lattice step s and the count of coordinates beyond
    s + 2e-5. A node's row takes the step of the payload it decoded, its
    partner perm[i]'s: a flipped code of the sender moves the receiver's
    average by s/2."""
    import torch
    from repro_torch.core import bucket as B
    bufs = [B.pack(B.build_layout(p), p).cpu() for p in (card_params,
                                                          cpu_params)]
    d = (bufs[0] - bufs[1]).abs()
    r = {"max_abs": float(d.max()),
         "share_within_2e-5": float((d <= 2e-5).double().mean())}
    if scales is not None:
        n = len(perm)
        d = d.reshape(n, -1, 256)
        s = scales.reshape(n, -1, 1)[torch.as_tensor(perm, dtype=torch.long)]
        r["max_in_steps"] = float((d / s).max())
        r["beyond_one_step"] = int((d > s + 2e-5).sum())
    return r


def _within_bound(r) -> bool:
    """Exact: every coordinate within 2e-5. q8: every coordinate within
    one lattice step of its row beyond that, and >= 99.9% within 2e-5."""
    if "beyond_one_step" in r:
        return r["beyond_one_step"] == 0 and r["share_within_2e-5"] >= 0.999
    return r["max_abs"] <= 2e-5


REFERENCE_MODES = (("exact", False, "blocking", "fixed"),
                   ("q8", True, "blocking", "fixed"),
                   ("nonblocking_q8", True, "nonblocking", "fixed"),
                   ("overlap_q8", True, "overlap", "fixed"),
                   ("overlap_q8_geometric", True, "overlap", "geometric"))


def phase_reference():
    """The engine on the card (kernels) against the engine on the CPU
    (plain versions), at a small size, for the blocking exact and q8
    supersteps and the non-blocking and overlapped q8 ones, the latter
    also with heterogeneous local steps (geometric h_i, batch depth
    h_max 4, so nodes below max_i h_i take masked steps). The CPU runs
    three supersteps from one model (the overlapped run from its primed
    pipeline); each card superstep restarts from the CPU's state before it
    (parameters, momentum, comm copy, in-flight payload), with the same
    batches, matching and uniforms, and is held to the bound of
    `_within_bound`: the card's matmuls sum in another order than the
    CPU's, and a q8 code flips where x/s + u lies within an ulp of an
    integer (moving its coordinate by about s/2). The overlapped step
    decodes the payload of the state it restarts from, so its rows' steps
    are that payload's scales. Planted faults of the exchange must fail the
    same bound; the non-blocking modes plant them in superstep 1, since in
    superstep 0 every node still averages the one initial model."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import bucket as B
    from repro_torch.core.graph import complete, sample_matching
    from repro_torch.core.swarm import SwarmConfig, SwarmState
    from repro_torch.core.swarm import pipeline_prologue, sample_h_counts
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.data import make_node_batches
    from repro_torch.models import init_params
    from repro_torch.tree import tree_map
    n, steps = 4, 3
    cfg = reduced(get_config("transformer-wmt"), n_layers=1, d_model=64)
    g = torch.Generator()
    g.manual_seed(0)
    params = tree_map(lambda x: x[None].repeat((n,) + (1,) * x.ndim),
                      init_params(g, cfg, "cpu"))
    rng = np.random.default_rng(0)
    perms = np.stack([sample_matching(complete(n), rng)
                      for _ in range(steps)])
    ds = SyntheticLMDataset(DataConfig(cfg.vocab_size, 32, seed=0), n)
    batches = {}
    for depth in (2, 4):       # H, and h_max of the geometric mode
        nbs = [make_node_batches(ds, t, 2 * depth) for t in range(steps)]
        batches[depth] = {k: np.stack([nb[k].reshape(n, depth, 2, 32)
                                       for nb in nbs]) for k in nbs[0]}
    us = rng.random((steps + 1, n, B.build_layout(params).n_padded),
                    dtype=np.float32)
    geo = SwarmConfig(n_nodes=n, H=2, h_mode="geometric", h_max=4)
    hs = {"fixed": np.full((steps, n), 2, np.int32),
          "geometric": np.stack([sample_h_counts(geo, rng)
                                 for _ in range(steps)])}
    check(any(len(set(h.tolist())) > 1 for h in hs["geometric"]),
          f"geometric h counts are not heterogeneous: {hs['geometric']}")
    inputs = (perms, batches, us, hs)
    out = {}
    for name, quantize, mode, h_mode in REFERENCE_MODES:
        run, _, opt, scfg = _reduced_engine("cpu", quantize, mode=mode,
                                            h_mode=h_mode)
        state = SwarmState(params, opt.init(params),
                           tree_map(torch.clone, params)
                           if quantize and mode != "overlap" else None, 0)
        if mode == "overlap":
            # the prologue's uniforms are the last row of `us`
            state = pipeline_prologue(scfg, state, None,
                                      u=torch.from_numpy(us[steps]))
        states = [state]
        loss_cpu, loss_card, readings = [], [], []
        for t in range(steps):
            state, m = run(states[t], t, inputs)
            states.append(state)
            loss_cpu.append(float(m["loss"]))

        def scales(codec, t):
            if not quantize:
                return None
            if mode == "overlap":
                return states[t].inflight["wire"][1].reshape(-1)
            return codec.scales[-1]
        for t in range(steps):
            run, codec, _, _ = _reduced_engine("cuda", quantize, mode=mode,
                                               h_mode=h_mode)
            state, m = run(states[t], t, inputs)
            loss_card.append(float(m["loss"]))
            readings.append(_readings(state.params, states[t + 1].params,
                                      scales(codec, t), perms[t]))
        rec = dict(loss_card=loss_card, loss_cpu=loss_cpu, readings=readings,
                   hs=hs[h_mode].tolist(), planted={})
        t_fault = 0 if mode == "blocking" else 1
        for fault in (("one_step_off", "average_dropped") if quantize
                      else ("average_dropped",)):
            run, codec, _, _ = _reduced_engine("cuda", quantize, fault, mode,
                                               h_mode)
            state, _ = run(states[t_fault], t_fault, inputs)
            rec["planted"][fault] = _readings(
                state.params, states[t_fault + 1].params,
                scales(codec, t_fault), perms[t_fault])
        out[name] = rec
        check(all(math.isfinite(x) for x in loss_card),
              f"{name}: non-finite loss on card")
        check(np.allclose(loss_card, loss_cpu, rtol=1e-4, atol=0),
              f"{name}: card loss {loss_card} != CPU loss {loss_cpu}")
        check(all(_within_bound(r) for r in readings),
              f"{name}: card vs CPU beyond the bound: {readings}")
        check(not any(_within_bound(r) for r in rec["planted"].values()),
              f"{name}: a planted fault passes the bound: {rec['planted']}")
    log("reference", **out)


def _read_wraps() -> dict:
    """`bucket.WRAPS` as ints: the matched q8 rows decoded at or beyond
    the lattice's reach (sender and receiver 2^(bits-1) or more of the
    sender's steps apart) and the rows checked."""
    from repro_torch.core import bucket as B
    return {k: int(v) for k, v in B.WRAPS.items()}


MAIN_PATH_ARGV = ["--arch", "transformer-wmt", "--nodes", "8", "--H", "2",
                  "--quantize"]


def phase_main_path():
    """The blocking main path (see the module docstring), with the q8
    wrap counter on (it adds a check of every matched row to each
    exchange, and prints what it counted)."""
    import torch
    from repro_torch.core import bucket as B
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch import train
    os.makedirs(OUT_DIR, exist_ok=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    reset_launch_counts()
    B.WRAPS = {}
    try:
        hist = train.main(MAIN_PATH_ARGV + [
            "--steps", "4", "--log-every", "1", "--out",
            os.path.join(OUT_DIR, "chip_smoke_train_q8.json")])
        wraps = _read_wraps()
    finally:
        B.WRAPS = None
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(len(hist) == 4 and all(math.isfinite(h["loss"])
                                 and math.isfinite(h["gamma"])
                                 for h in hist),
          f"main path: non-finite or missing records {hist}")
    check(counts == {"sgd_update": 8, "quantize_mod": 4, "decode_avg": 4},
          f"main path launch counts {counts}")
    walls = [h["wall_s"] for h in hist]
    steady = [b - a for a, b in zip(walls, walls[1:])]
    log("main_path", records=hist, launches=counts,
        first_superstep_s=walls[0], superstep_s=steady,
        superstep_median_s=statistics.median(steady),
        max_memory_allocated_bytes=peak, start_allocated_bytes=start,
        q8_wraps=wraps)
    MEASURED_PEAKS["main_path"] = peak - start
    return counts, hist


def _remat_runs(steps: int, snapshot: bool, order=(True, False)) -> list:
    """`main_path`'s command for `steps` supersteps through
    ``train.build``, one run for each ``remat`` of `order` (the
    reference's per-block recompute in the backward pass, on by default
    at full size); -> [(remat, {its losses, superstep seconds, peak
    allocated above its start, launches and, with `snapshot`, the
    parameters after its first superstep})]."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves
    args = train.build_parser().parse_args(
        MAIN_PATH_ARGV + ["--steps", str(steps)])
    out = []
    for remat in order:
        cfg = dataclasses.replace(get_config("transformer-wmt"), remat=remat)
        _fresh_memory()
        start = torch.cuda.memory_allocated()
        tr = train.build(args, cfg)
        reset_launch_counts()
        losses, secs, params = [], [], None
        for t in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(tr.superstep(t)["loss"]))
            secs.append(time.perf_counter() - t0)
            if snapshot and t == 0:
                params = [x.clone() for x in tree_leaves(tr.state.params)]
        torch.cuda.synchronize()
        out.append((remat, dict(
            losses=losses, superstep_s=secs, launches=dict(LAUNCHES),
            peak_above_start_bytes=torch.cuda.max_memory_allocated() -
            start, params=params)))
        del tr
    _fresh_memory()
    return out


def phase_remat():
    """``cfg.remat`` on against off on `main_path`'s command at full width
    and depth (8 nodes of transformer-wmt, bf16, blocking q8): with remat
    the backward pass recomputes each of the 12 blocks from its input.
    Under PyTorch's deterministic algorithms (the cuBLAS workspace pinned
    in `main`) the losses and parameters after one superstep must be
    bitwise equal, and so must the losses of the next two. Then 4
    supersteps a run in the default algorithms, as `main_path` runs, in
    turns (on, off, off, on): the superstep times (steady: supersteps 1-3
    of both runs) and the peaks allocated above the start, every run with
    launches 8 / 4 / 4. -> {path: launches}."""
    import warnings
    import torch
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            det = dict(_remat_runs(3, snapshot=True))
    finally:
        torch.use_deterministic_algorithms(False)
    on, off = det[True], det[False]
    pairs = list(zip(on.pop("params"), off.pop("params")))
    params_equal = all(same_bits(a, b) for a, b in pairs)
    max_abs = max(float((a.float() - b.float()).abs().max())
                  for a, b in pairs)
    del pairs, det
    timed = _remat_runs(4, snapshot=False, order=(True, False, False, True))
    rec = {}
    for key, remat in (("on", True), ("off", False)):
        runs = [r for m, r in timed if m == remat]
        for r in runs:
            del r["params"]
        rec[key] = {"runs": runs, "superstep_median_s": statistics.median(
            x for r in runs for x in r["superstep_s"][1:]),
            "peak_above_start_bytes": max(r["peak_above_start_bytes"]
                                          for r in runs)}
    log("remat", deterministic={"on": on, "off": off,
                                "params_bitwise": params_equal,
                                "max_abs_diff": max_abs,
                                "losses_bitwise": on["losses"] ==
                                off["losses"]},
        **rec, median_on_over_off=rec["on"]["superstep_median_s"] /
        rec["off"]["superstep_median_s"],
        peak_on_over_off=rec["on"]["peak_above_start_bytes"] /
        rec["off"]["peak_above_start_bytes"])
    check(params_equal and on["losses"] == off["losses"],
          f"remat on != off on the card: params bitwise {params_equal}, "
          f"losses {on['losses']} vs {off['losses']}")
    want = {"sgd_update": 8, "quantize_mod": 4, "decode_avg": 4}
    for key, r in rec.items():
        for run in r["runs"]:
            check(all(math.isfinite(x) for x in run["losses"]),
                  f"remat {key}: non-finite losses {run['losses']}")
            check(run["launches"] == want,
                  f"remat {key}: launches {run['launches']} != {want}")
    return {f"remat_{key}": r["runs"][0]["launches"]
            for key, r in rec.items()}


def phase_exact():
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch import train
    reset_launch_counts()
    hist = train.main(["--arch", "transformer-wmt", "--nodes", "8",
                       "--H", "2", "--steps", "1", "--log-every", "1"])
    counts = dict(LAUNCHES)
    check(math.isfinite(hist[-1]["loss"]), "exact superstep: non-finite")
    check(counts == {"sgd_update": 2, "quantize_mod": 0, "decode_avg": 0},
          f"exact superstep launch counts {counts}")
    log("exact_superstep", record=hist[-1], launches=counts)


def _fresh_memory():
    import gc
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def phase_overlap_exact():
    """The overlapped exact run against the non-blocking exact run, bitwise
    on the card, superstep by superstep: 3 supersteps of 8 nodes of
    transformer-wmt cut to 2 layers, at its full width (d_model 1024,
    vocab 32768; 58.7 M parameters a node) in fp32, so the side stream
    carries the same rows a full-width run puts in flight. The pipeline
    only reschedules the exchange, so any difference is a race of its
    side stream. Both runs use PyTorch's deterministic algorithms
    (the cuBLAS workspace is pinned in `main`), so that the two runs'
    local steps themselves reproduce."""
    import dataclasses
    import warnings
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves
    argv = ["--arch", "transformer-wmt", "--nodes", "8", "--H", "2",
            "--steps", "3"]
    cfg = dataclasses.replace(get_config("transformer-wmt"), n_layers=2,
                              dtype="float32", opt_state_dtype="float32")
    _fresh_memory()
    runs, counts = {}, {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for mode in ("--nonblocking", "--overlap"):
                reset_launch_counts()
                tr = train.build(train.build_parser().parse_args(
                    argv + [mode]), cfg)
                runs[mode] = []
                per_node = sum(x[0].numel()
                               for x in tree_leaves(tr.state.params))
                for t in range(3):
                    m = tr.superstep(t)
                    runs[mode].append((tree_leaves(tr.state.params),
                                       float(m["loss"])))
                counts[mode] = dict(LAUNCHES)
                del tr
    finally:
        torch.use_deterministic_algorithms(False)
    equal, max_abs = [], []
    for (a, la), (b, lb) in zip(runs["--nonblocking"], runs["--overlap"]):
        equal.append(all(same_bits(x, y) for x, y in zip(a, b))
                     and la == lb)
        max_abs.append(max(float((x.float() - y.float()).abs().max())
                           for x, y in zip(a, b)))
    nondet = sorted({str(w.message)[:160] for w in caught})
    log("overlap_exact", n_layers=cfg.n_layers, d_model=cfg.d_model,
        vocab=cfg.vocab_size, dtype=cfg.dtype, params_per_node=per_node,
        bitwise_equal=equal, max_abs_diff=max_abs,
        losses=[l for _, l in runs["--overlap"]], launches=counts,
        nondeterministic_op_warnings=nondet)
    del runs
    check(all(equal), f"overlap exact != non-blocking exact on the card: "
          f"per superstep {equal}, max abs {max_abs}")
    check(all(c["sgd_update"] == 6 and c["quantize_mod"] == 0
              for c in counts.values()), f"launch counts {counts}")


FULL_WIDTH_ARGV = ["--arch", "transformer-wmt", "--nodes", "8", "--H", "2",
                   "--h-mode", "geometric", "--h-max", "8", "--quantize",
                   "--nonblocking", "--overlap", "--non-iid", "0.5",
                   "--eval-mean", "--steps", "4", "--log-every", "1"]


def phase_full_width():
    """This slice's main path: the overlapped q8 run with geometric local
    steps, non-iid data, --eval-mean and checkpoints, 4 supersteps at full
    transformer-wmt width and depth (bf16, 8 nodes), every launch counter
    at 0 just before."""
    import numpy as np
    import shutil
    import torch
    from repro_torch.checkpoint import load_metadata
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch import train
    ckpt = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    out = os.path.join(OUT_DIR, "chip_smoke_train_overlap_q8.json")
    disk_free = shutil.disk_usage(ROOT).free
    _fresh_memory()
    reset_launch_counts()
    t0 = time.time()
    hist = train.main(FULL_WIDTH_ARGV + ["--ckpt", ckpt, "--ckpt-every", "4",
                                         "--out", out])
    torch.cuda.synchronize()
    run_s = time.time() - t0
    counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    with open(out) as f:
        hs = np.asarray(json.load(f)["hs"])
    want = {"sgd_update": int(hs.max(axis=1).sum()), "quantize_mod": 5,
            "decode_avg": 4}
    keys = ("loss", "gamma", "loss_mean_model", "loss_node_mean",
            "loss_node_worst")
    check(len(hist) == 4 and all(math.isfinite(h[k]) for h in hist
                                 for k in keys),
          f"full width: non-finite or missing records {hist}")
    check(counts == want, f"full width launch counts {counts} != {want} "
          f"(hs {hs.tolist()})")
    files = sorted(os.listdir(ckpt))
    meta = load_metadata(os.path.join(ckpt, "step_000004"))
    ckpt_bytes = sum(os.path.getsize(os.path.join(ckpt, f)) for f in files)
    shutil.rmtree(ckpt)
    check(files == ["step_000004.json", "step_000004.npz"]
          and meta["step"] == 4 and meta["codec"]["state"] == ["params",
                                                               "prev"],
          f"full width checkpoint {files} {meta}")
    walls = [h["wall_s"] for h in hist]
    steady = [b - a for a, b in zip(walls, walls[1:])]
    log("full_width", argv=FULL_WIDTH_ARGV, records=hist, hs=hs.tolist(),
        launches=counts, first_superstep_s=walls[0], superstep_s=steady,
        superstep_median_s=statistics.median(steady),
        superstep_note="wall deltas include each step's --eval-mean",
        max_memory_allocated_bytes=peak, run_s=run_s,
        checkpoint_files=files, checkpoint_bytes=ckpt_bytes,
        disk_free_bytes=disk_free)
    return counts


def phase_checkpoint():
    """A reduced-size checkpoint written on the card (an overlapped q8 run,
    drained on a copy) and reloaded onto the card bitwise; a bf16 copy of
    it too, which the file stores widened."""
    import shutil
    import torch
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.core.swarm import (
        codec_checkpoint_tree, pipeline_epilogue, pipeline_prologue,
        restore_codec_state,
    )
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves, tree_map
    ckpt = os.path.join(ROOT, "build", "chip_smoke_ckpt_small")
    shutil.rmtree(ckpt, ignore_errors=True)
    _fresh_memory()
    tr = train.build(train.build_parser().parse_args(
        ["--reduced", "--layers", "2", "--d-model", "256", "--nodes", "4",
         "--steps", "2", "--quantize", "--overlap", "--h-mode", "geometric",
         "--h-max", "4", "--batch", "2", "--seq", "64"]))
    for t in range(2):
        tr.superstep(t)
    path = os.path.join(ckpt, "step_000002")
    tr.write_ckpt(path, 2)
    like = codec_checkpoint_tree(pipeline_epilogue(tr.scfg, tr.state))
    back = load_checkpoint(path, like)
    same = all(same_bits(a, b) and a.device == b.device
               for a, b in zip(tree_leaves(back), tree_leaves(like)))
    resumed = pipeline_prologue(
        tr.scfg, restore_codec_state(pipeline_epilogue(tr.scfg, tr.state),
                                     back), tr.enc_gen)
    prev_same = same_bits(resumed.inflight["prev"], tr.state.inflight["prev"])
    half = {"params": tree_map(lambda x: x.to(torch.bfloat16),
                               like["params"])}
    save_checkpoint(path + "_bf16", half)
    back16 = load_checkpoint(path + "_bf16", half)
    same16 = all(same_bits(a, b) for a, b in zip(tree_leaves(back16),
                                                 tree_leaves(half)))
    shutil.rmtree(ckpt)
    log("checkpoint", reload_bitwise=same, prologue_prev_bitwise=prev_same,
        bf16_reload_bitwise=same16,
        n_leaves=len(tree_leaves(like)))
    check(same and prev_same and same16, "checkpoint reload on the card is "
          f"not bitwise: {same} {prev_same} {same16}")

# -- the baselines (PR 13): card vs CPU at a small size, then full width --

# name, algo, quantize, nonblocking, graph, masked, planted faults; every
# mode runs 3 steps but the push-sum one (below)
BASELINE_MODES = (
    ("allreduce", "allreduce", False, False, "complete", False, ()),
    ("allreduce_masked", "allreduce", False, False, "complete", True,
     ("mean_over_all",)),
    ("localsgd", "localsgd", False, False, "complete", False, ()),
    ("dpsgd_ring", "dpsgd", False, False, "ring", False, ()),
    ("dpsgd_ring_masked", "dpsgd", False, False, "ring", True,
     ("unmasked_W",)),
    ("adpsgd_nonblocking", "adpsgd", False, True, "complete", False, ()),
    ("adpsgd_q8", "adpsgd", True, False, "complete", False, ()),
    ("adpsgd_q8_nonblocking_masked", "adpsgd", True, True, "complete", True,
     ()),
    ("sgp_q8", "sgp", True, False, "complete", False, ()),
    ("sgp_q8_pushsum", "sgp", True, False, "complete", False,
     ("w_unmixed",)),
)
# sgp_q8_pushsum starts from a push-sum state whose w is not all 1 (X =
# w x0, the comm copy at w = 1), so w mixes and its planted fault shows.
# One step only: once a node's comm copy refreshes, its next encode's
# distance proxy is one gradient step while the nodes' X differ by
# (w_i - w_j) x0, so the lattice decode wraps (in the reference too), and
# card and CPU may then land an ulp apart on either side of a wrap
SGP_W0 = (1.3, 0.7, 1.4, 0.6)


def _baseline_engine(device, algo: str, quantize: bool, nonblocking: bool,
                     graph: str, fault: str = ""):
    """A step of `algo` on `_reduced_engine`'s model (4 nodes), its q8
    codec (which remembers the scale of every encode) and a function that
    runs step t from a state on any device. `fault` plants a known-wrong
    exchange: "mean_over_all" (the global mean ignores the mask),
    "unmasked_W" (D-PSGD mixes with W where the mask asks for W_eff) or
    "w_unmixed" (SGP's push-sum weights do not land)."""
    import numpy as np
    import torch
    from repro_torch.algorithms import make_algorithm
    from repro_torch.algorithms.dpsgd import metropolis_weights
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.exchange import GossipTransport
    from repro_torch.core.graph import make_graph
    from repro_torch.core.swarm import SwarmState
    from repro_torch.models import TransformerLM
    from repro_torch.optim import make_optimizer
    from repro_torch.quant.codecs import LatticeCodec
    from repro_torch.quant.schemes import ModularQuantConfig
    n = 4
    g = make_graph(graph, n)
    W_full = torch.from_numpy(metropolis_weights(g).astype(np.float32))

    class Codec(LatticeCodec):
        def __init__(self):
            super().__init__(ModularQuantConfig())
            self.scales = []

        def encode(self, *a, **kw):
            q, sc = super().encode(*a, **kw)
            self.scales.append(sc.reshape(-1).cpu())
            return q, sc

    class Transport(GossipTransport):
        def global_mean(self, tree, mask=None):
            return super().global_mean(
                tree, None if fault == "mean_over_all" else mask)

        def matrix_mix(self, tree, W):
            if fault == "unmasked_W":
                W = W_full.to(W.device)
            return super().matrix_mix(tree, W)

        def mix_pair(self, tree, perm, matched, **kw):
            out = super().mix_pair(tree, perm, matched, **kw)
            if fault == "w_unmixed" and isinstance(tree, dict) \
                    and "w" in tree:
                out["w"] = tree["w"].clone()
            return out

    cfg = reduced(get_config("transformer-wmt"), n_layers=1, d_model=64)
    codec = Codec()
    opt = make_optimizer("sgd", lr=0.05, momentum=0.9)
    kw = dict(loss_fn=TransformerLM(cfg).functional_loss,
              opt_update=opt.update, lr_fn=lambda s: 0.05, n_nodes=n,
              transport=Transport(n, codec=codec))
    if algo == "localsgd":
        kw["H"] = 2
    if algo == "dpsgd":
        kw["graph"] = g
    if algo in ("adpsgd", "sgp"):
        kw["quantize"] = quantize
    if algo == "adpsgd":
        kw["nonblocking"] = nonblocking
    step = make_algorithm(algo, **kw)
    depth = 2 if algo == "localsgd" else 1

    def move(x):
        if x is None or isinstance(x, torch.Tensor):
            return None if x is None else x.to(device)
        return {k: move(v) for k, v in x.items()}

    def run(state, t, inputs):
        perms, batches, us, masks = inputs
        state = SwarmState(move(state.params), move(state.opt),
                           move(state.prev), t)
        batch = {k: torch.from_numpy(v[t]).to(device)
                 for k, v in batches[depth].items()}
        u = torch.from_numpy(us[t]).to(device) if us is not None else None
        return step(state, batch, perms[t], np.full((n,), depth, np.int32),
                    None, masks[t], u=u)

    return run, codec, opt, cfg


def phase_baselines_reference(card: str = "cuda"):
    """The five baselines on the card (kernels) against the same on the
    CPU (plain versions), at `_reduced_engine`'s size: three steps on the
    CPU, each card step restarted from the CPU's state before it with the
    same batches, matchings, masks and uniforms, held to the bound of
    `_within_bound`. All-reduce full and masked, Local SGD (H 2), D-PSGD on
    a ring full and masked, AD-PSGD exact non-blocking and q8 blocking and
    non-blocking (masked), SGP q8 from the driver's start (w = 1) and, for
    one step, from a push-sum state with w not all 1 (so w mixes). Three
    planted faults must fail the same bound:
    the mean over all nodes where the mask drops one, the unmasked W under
    a mask, and SGP's w unmixed."""
    import numpy as np
    import torch
    from repro_torch.algorithms.sgp import sgp_init_state
    from repro_torch.core import bucket as B
    from repro_torch.core.graph import make_graph, sample_matching
    from repro_torch.core.swarm import SwarmState
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.data import make_node_batches
    from repro_torch.models import init_params
    from repro_torch.tree import tree_map
    n = 4
    ds = None
    out = {}
    for name, algo, quantize, nonblocking, graph, masked, faults in \
            BASELINE_MODES:
        pushsum = name.endswith("pushsum")
        steps = 1 if pushsum else 3
        run, _, opt, cfg = _baseline_engine("cpu", algo, quantize,
                                            nonblocking, graph)
        if ds is None:
            ds = SyntheticLMDataset(DataConfig(cfg.vocab_size, 32, seed=0),
                                    n)
            batches = {}
            for depth in (1, 2):
                nbs = [make_node_batches(ds, t, 2 * depth)
                       for t in range(3)]
                batches[depth] = {k: np.stack([nb[k].reshape(n, depth, 2, 32)
                                               for nb in nbs])
                                  for k in nbs[0]}
        g = torch.Generator()
        g.manual_seed(0)
        params = tree_map(lambda x: x[None].repeat((n,) + (1,) * x.ndim),
                          init_params(g, cfg, "cpu"))
        state = SwarmState(params, opt.init(params),
                           tree_map(torch.clone, params)
                           if quantize or nonblocking else None, 0)
        if algo == "sgp":
            state = sgp_init_state(state, n, quantize)
        if pushsum:
            w = torch.tensor(SGP_W0)
            state = SwarmState(
                {"model": tree_map(lambda x: x * w.reshape(
                    (-1,) + (1,) * (x.ndim - 1)), state.params["model"]),
                 "w": w}, state.opt, state.prev, 0)
        rng = np.random.default_rng(1)
        perms = np.stack([sample_matching(make_graph(graph, n), rng)
                          for _ in range(steps)])
        masks = [rng.random(n) < 0.6 if masked else None
                 for _ in range(steps)]
        if masked:
            masks[0] = np.array([True, True, True, False])
        us = rng.random((steps, n, B.build_layout(state.params).n_padded),
                        dtype=np.float32) if quantize else None
        inputs = (perms, batches, us, masks)
        partners = ([(np.arange(n) - 2 ** (t % 2)) % n for t in range(steps)]
                    if algo == "sgp" else list(perms))
        states, loss_cpu = [state], []
        for t in range(steps):
            state, m = run(states[t], t, inputs)
            states.append(state)
            loss_cpu.append(float(m["loss"]))
        loss_card, readings = [], []
        for t in range(steps):
            run_c, codec, _, _ = _baseline_engine(card, algo, quantize,
                                                  nonblocking, graph)
            state, m = run_c(states[t], t, inputs)
            loss_card.append(float(m["loss"]))
            readings.append(_readings(
                state.params, states[t + 1].params,
                codec.scales[-1] if quantize else None, partners[t]))
        rec = dict(algo=algo, quantize=quantize, nonblocking=nonblocking,
                   graph=graph, masks=[None if m is None else m.tolist()
                                       for m in masks],
                   loss_card=loss_card, loss_cpu=loss_cpu,
                   readings=readings, planted={})
        if algo == "sgp":
            rec["w_cpu"] = [s.params["w"].tolist() for s in states]
        for fault in faults:
            run_f, codec, _, _ = _baseline_engine(card, algo, quantize,
                                                  nonblocking, graph, fault)
            state, _ = run_f(states[0], 0, inputs)
            rec["planted"][fault] = _readings(
                state.params, states[1].params,
                codec.scales[-1] if quantize else None, partners[0])
        out[name] = rec
        check(all(math.isfinite(x) for x in loss_card),
              f"{name}: non-finite loss on card")
        check(np.allclose(loss_card, loss_cpu, rtol=1e-4, atol=0),
              f"{name}: card loss {loss_card} != CPU loss {loss_cpu}")
        check(all(_within_bound(r) for r in readings),
              f"{name}: card vs CPU beyond the bound: {readings}")
        check(not any(_within_bound(r) for r in rec["planted"].values()),
              f"{name}: a planted fault passes the bound: {rec['planted']}")
    log("baselines_reference", **out)
    return out


# the five commands of the baselines' slice, 4 supersteps each at full
# transformer-wmt width and depth (8 nodes, bf16), and their launches of
# sgd_update / quantize_mod / decode_avg
BASELINE_COMMANDS = {
    "allreduce": (["--algo", "allreduce"], (4, 0, 0)),
    "localsgd": (["--algo", "localsgd", "--H", "2"], (8, 0, 0)),
    "dpsgd": (["--algo", "dpsgd", "--graph", "ring"], (4, 0, 0)),
    "adpsgd": (["--algo", "adpsgd", "--quantize", "--nonblocking"],
               (4, 4, 4)),
    "sgp": (["--algo", "sgp", "--quantize", "--eval-mean"], (4, 4, 4)),
}


def phase_baselines_full_width():
    """Each baseline command at full width, every launch counter at 0 just
    before it; -> {path: launches}. Asserts finite loss and Γ (and SGP's
    mean-model loss), the launch counts, all-reduce's 8 nodes bitwise
    equal after its run and SGP's Σw = 8 within 1e-4; prints each
    command's superstep median and peak memory."""
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves
    base = ["--arch", "transformer-wmt", "--nodes", "8", "--steps", "4",
            "--log-every", "1"]
    by_path, out = {}, {}
    for name, (flags, want) in BASELINE_COMMANDS.items():
        argv = base + flags
        args = train.build_parser().parse_args(argv)
        _fresh_memory()
        start = torch.cuda.memory_allocated()
        tr = train.build(args)
        reset_launch_counts()
        t0 = time.time()
        hist = train.run(args, tr)
        torch.cuda.synchronize()
        run_s = time.time() - t0
        counts = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        keys = ("loss", "gamma") + (("loss_mean_model",)
                                    if "--eval-mean" in flags else ())
        check(len(hist) == 4 and all(math.isfinite(h[k]) for h in hist
                                     for k in keys),
              f"{name}: non-finite or missing records {hist}")
        want = dict(zip(("sgd_update", "quantize_mod", "decode_avg"), want))
        check(counts == want, f"{name}: launch counts {counts} != {want}")
        rec = {}
        if name == "allreduce":
            rec["nodes_bitwise_equal"] = all(
                same_bits(x[0:1].expand_as(x).contiguous(), x)
                for x in tree_leaves(tr.state.params))
            check(rec["nodes_bitwise_equal"],
                  "allreduce: the 8 nodes are not bitwise equal")
        if name == "sgp":
            rec["w_sum"] = float(tr.state.params["w"].sum())
            check(abs(rec["w_sum"] - 8.0) <= 1e-4, f"sgp: Σw = {rec}")
        walls = [h["wall_s"] for h in hist]
        steady = [b - a for a, b in zip(walls, walls[1:])]
        out[name] = dict(argv=argv, records=hist, launches=counts,
                         first_superstep_s=walls[0], superstep_s=steady,
                         superstep_median_s=statistics.median(steady),
                         max_memory_allocated_bytes=peak, run_s=run_s, **rec)
        by_path[name] = counts
        del tr
    _fresh_memory()
    log("baselines_full_width", **out)
    return by_path


# the scheduler's reference cases: (name, algo, q8, mode, flags of the
# trace, planted faults). Every case runs 8 nodes of `_reduced_engine`'s
# model under a binned trace. The churn spec joins one node in bin 1 and
# another in bin 5, each from a donor that has trained (so a join moves a
# row that differs from the joiner's own), and retires two nodes before
# bin 5, at 3 --steps of 8 nodes
SCHED_AVAIL = ("day_night:period=4,duty=0.75,join=0.25:0.8:1.6,"
               "leave=0.25:1.6:2.4,seed=1")
SCHED_LOGNORMAL = ["--rate-profile", "lognormal", "--rate-sigma", "0.8",
                   "--straggler", "0.25:8"]
SCHED_MODES = (
    ("lognormal_exact", "swarm", False, "blocking", SCHED_LOGNORMAL,
     ("h_to_idle",)),
    ("lognormal_q8", "swarm", True, "blocking", SCHED_LOGNORMAL, ()),
    ("lognormal_q8_nonblocking", "swarm", True, "nonblocking",
     SCHED_LOGNORMAL, ()),
    ("lognormal_q8_overlap", "swarm", True, "overlap", SCHED_LOGNORMAL, ()),
    ("churn_exact", "swarm", False, "blocking",
     ["--rate-profile", "uniform_async", "--avail", SCHED_AVAIL],
     ("join_keeps_own_row",)),
    ("churn_q8", "swarm", True, "blocking",
     ["--rate-profile", "uniform_async", "--avail", SCHED_AVAIL],
     ("join_keeps_own_row",)),
    ("hier4_q8", "swarm", True, "blocking",
     ["--rate-profile", "lognormal", "--topology", "hier:4"], ()),
    ("adpsgd_q8", "adpsgd", True, "blocking", SCHED_LOGNORMAL, ()),
)


def _sched_schedule(flags, algo: str, n: int = 8, steps: int = 3):
    """The binned schedule the training driver builds for `flags`."""
    from repro_torch.algorithms import CAPABILITIES
    from repro_torch.core.graph import make_graph
    from repro_torch.core.swarm import SwarmConfig
    from repro_torch.launch import train
    args = train.build_parser().parse_args(
        ["--nodes", str(n), "--steps", str(steps), "--h-max", "4",
         "--algo", algo] + flags)
    caps = CAPABILITIES[algo]
    scfg = SwarmConfig(n_nodes=n, H=2 if caps.local_H else 1,
                       h_mode="trace" if caps.local_H else "fixed", h_max=4)
    sched, _, _ = train.build_schedule(args, make_graph("complete", n), scfg,
                                       caps)
    return sched


def _sched_engine(device, algo: str, quantize: bool, mode: str,
                  fault: str = ""):
    """A bin of `algo` under a trace on `_reduced_engine`'s model with 8
    nodes (trace h-mode, h_max 4), its q8 codec (which remembers the scale
    of every encode) and a function that runs bin s from a state on any
    device: the join bootstrap on a join bin, else the masked superstep.
    `fault` plants a known-wrong bin: "h_to_idle" (the non-participants
    take the bin's largest h) or "join_keeps_own_row" (the joiner keeps
    its own model)."""
    import numpy as np
    import torch
    from repro_torch.algorithms import make_algorithm
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.exchange import GossipTransport
    from repro_torch.core.swarm import SwarmConfig, SwarmState
    from repro_torch.core.swarm import make_join_step
    from repro_torch.models import TransformerLM
    from repro_torch.optim import make_optimizer
    from repro_torch.quant.codecs import LatticeCodec
    from repro_torch.quant.schemes import ModularQuantConfig
    from repro_torch.sched import EVENT_JOIN
    n = 8

    class Codec(LatticeCodec):
        """The q8 codec, remembering the scales of every encode and the
        receiver's reference buffer of every decode."""

        def __init__(self):
            super().__init__(ModularQuantConfig())
            self.scales, self.ybufs = [], []

        def encode(self, *a, **kw):
            q, sc = super().encode(*a, **kw)
            self.scales.append(sc.reshape(-1).cpu())
            return q, sc

        def decode_avg(self, wire, ybuf, *a, **kw):
            self.ybufs.append(ybuf.cpu())
            return super().decode_avg(wire, ybuf, *a, **kw)

    cfg = reduced(get_config("transformer-wmt"), n_layers=1, d_model=64)
    codec = Codec()
    opt = make_optimizer("sgd", lr=0.05, momentum=0.9)
    kw = dict(loss_fn=TransformerLM(cfg).functional_loss,
              opt_update=opt.update, lr_fn=lambda s: 0.05, n_nodes=n,
              transport=GossipTransport(n, codec=codec))
    scfg = SwarmConfig(n_nodes=n, H=2, h_mode="trace", h_max=4,
                       quantize=quantize, nonblocking=mode != "blocking",
                       overlap=mode == "overlap")
    if algo == "swarm":
        kw["scfg"] = scfg
        depth = 4
    else:
        kw.update(quantize=quantize, nonblocking=mode != "blocking")
        depth = 1
    step = make_algorithm(algo, **kw)
    join = make_join_step(scfg) if mode != "overlap" else None

    def move(x):
        if x is None or isinstance(x, torch.Tensor):
            return None if x is None else x.to(device)
        if isinstance(x, tuple):
            return tuple(move(v) for v in x)
        return {k: move(v) for k, v in x.items()}

    def run(state, s, inputs):
        sched, batches, us = inputs
        state = SwarmState(move(state.params), move(state.opt),
                           move(state.prev), s, move(state.inflight))
        perm, h, mask = sched.perms[s], sched.h[s], sched.mask[s]
        if sched.kinds is not None and sched.kinds[s] == EVENT_JOIN:
            if fault == "join_keeps_own_row":
                mask = np.zeros_like(mask)
            return join(state, perm, mask), None
        if fault == "h_to_idle":
            h = np.where(mask, h, h.max()).astype(np.int32)
        batch = {k: torch.from_numpy(v[s]).to(device)
                 for k, v in batches[depth].items()}
        return step(state, batch, perm, h, None, mask,
                    u=torch.from_numpy(us[s]).to(device))

    return run, codec, opt, cfg, scfg


def _sched_readings(card_params, cpu_params, scales, perm, ybuf):
    """`_readings`, plus the q8 coordinates at the edge of the lattice's
    reach. A node decodes its partner's codes against its own buffer y
    (`ybuf`, the CPU's), which holds only while |x_j - y_i| < 128 s_j; the
    reference wraps beyond it. Where the CPU's decode argument
    r = (y_j - y_i) / s_j (each node's encode input is its own y) lies
    within 1.5 of the edge (|r| >= 126.5), an ulp upstream decides the
    side of the wrap, and card and CPU then differ by 255/2 steps: such a
    coordinate (|d / s - 127.5| <= 1) is counted in `wrap_edge` and not in
    `beyond_one_step`; every other coordinate keeps the one-step bound."""
    import torch
    r = _readings(card_params, cpu_params, scales, perm)
    if scales is None:
        return r
    from repro_torch.core import bucket as B
    bufs = [B.pack(B.build_layout(p), p).cpu() for p in (card_params,
                                                          cpu_params)]
    n = len(perm)
    idx = torch.as_tensor(perm, dtype=torch.long)
    d = (bufs[0] - bufs[1]).abs().reshape(n, -1, 256)
    s = scales.reshape(n, -1, 1)[idx]
    y = ybuf.reshape(n, -1, 256)
    edge = ((y[idx] - y) / s).abs() >= 126.5
    flip = ((d / s) - 127.5).abs() <= 1.0
    beyond = d > s + 2e-5
    r["wrap_edge"] = int((beyond & edge & flip).sum())
    r["beyond_one_step"] = int((beyond & ~(edge & flip)).sum())
    return r


def phase_sched_reference(card: str = "cuda"):
    """The engine under scheduler traces on the card (kernels) against the
    same on the CPU (plain versions), 8 nodes of `_reduced_engine`'s model
    from one initial model (as the driver starts; distinct models would
    put the q8 decode beyond its lattice's reach, in the reference too): a
    lognormal (sigma 0.8) trace with a quarter of the nodes 8x slower,
    blocking exact and q8, non-blocking q8 and overlapped q8; a churn
    trace with two joins after gossip bins and two leaves, exact and q8; a two-tier hier:4 trace, q8; AD-PSGD q8 under the trace.
    The CPU runs every bin of the schedule; each card bin restarts from
    the CPU's state before it (comm copy and in-flight payload included),
    with the same batches, bins and uniforms, and is held to the bound of
    `_within_bound` (coordinates whose decode the CPU finds at the edge of
    the lattice's reach are counted apart, `_sched_readings`); a join bin
    must match bitwise. Two planted faults
    must fail the same bound: the bin's h given to non-participants, and a
    join that keeps the joiner's own row (planted in the join bin whose
    donor's row differs most from the joiner's). -> {case: records}."""
    import numpy as np
    import torch
    from repro_torch.core import bucket as B
    from repro_torch.core.swarm import SwarmState, pipeline_prologue
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.data import make_node_batches
    from repro_torch.models import init_params
    from repro_torch.sched import EVENT_JOIN
    from repro_torch.tree import tree_leaves, tree_map
    n = 8
    out = {}
    batches = None
    for name, algo, quantize, mode, flags, faults in SCHED_MODES:
        sched = _sched_schedule(flags, algo)
        S = sched.n_supersteps
        run, cpu_codec, opt, cfg, scfg = _sched_engine("cpu", algo, quantize,
                                                       mode)
        if batches is None:
            ds = SyntheticLMDataset(DataConfig(cfg.vocab_size, 32, seed=0),
                                    n)
            batches = {}
            for depth in (1, 4):
                nbs = [make_node_batches(ds, t, 2 * depth)
                       for t in range(12)]
                batches[depth] = {k: np.stack([nb[k].reshape(n, depth, 2, 32)
                                               for nb in nbs])
                                  for k in nbs[0]}
        check(S <= 12, f"{name}: {S} bins")
        g = torch.Generator()
        g.manual_seed(0)
        params = tree_map(lambda x: x[None].repeat((n,) + (1,) * x.ndim),
                          init_params(g, cfg, "cpu"))
        state = SwarmState(params, opt.init(params),
                           tree_map(torch.clone, params)
                           if quantize or mode == "nonblocking" else None, 0)
        rng = np.random.default_rng(2)
        us = rng.random((S + 1, n, B.build_layout(params).n_padded),
                        dtype=np.float32)
        if mode == "overlap":
            state = pipeline_prologue(scfg, state, None,
                                      u=torch.from_numpy(us[S]))
        inputs = (sched, batches, us)
        states, loss_cpu, ybufs = [state], [], []
        for s in range(S):
            n_dec = len(cpu_codec.ybufs)
            state, m = run(states[s], s, inputs)
            states.append(state)
            loss_cpu.append(None if m is None else float(m["loss"]))
            ybufs.append(cpu_codec.ybufs[-1]
                         if len(cpu_codec.ybufs) > n_dec else None)

        def scales(codec, s):
            if not quantize:
                return None
            if mode == "overlap":
                return states[s].inflight["wire"][1].reshape(-1)
            return codec.scales[-1]
        is_join = [sched.kinds is not None and sched.kinds[s] == EVENT_JOIN
                   for s in range(S)]
        loss_card, readings = [], []
        for s in range(S):
            run_c, codec, _, _, _ = _sched_engine(card, algo, quantize, mode)
            state, m = run_c(states[s], s, inputs)
            loss_card.append(None if m is None else float(m["loss"]))
            readings.append(_sched_readings(
                state.params, states[s + 1].params,
                None if is_join[s] else scales(codec, s), sched.perms[s],
                ybufs[s]))
        rec = dict(algo=algo, quantize=quantize, mode=mode, flags=flags,
                   bins=S, density=sched.density(),
                   join_bins=[s for s in range(S) if is_join[s]],
                   retired=(None if sched.retire is None
                            else sched.retire.sum(axis=1).tolist()),
                   tiers=(None if sched.tiers is None
                          else sched.tiers.tolist()),
                   hs=sched.h.tolist(), loss_card=loss_card,
                   loss_cpu=loss_cpu, readings=readings, planted={})
        def row_gap(s):
            """max |donor - joiner| over the parameters before join bin s"""
            j = int(np.nonzero(sched.mask[s])[0][0])
            d = int(sched.perms[s][j])
            return max(float((x[j] - x[d]).abs().max())
                       for x in tree_leaves(states[s].params))
        for fault in faults:
            if fault == "join_keeps_own_row":
                s_f = max((s for s in range(S) if is_join[s]), key=row_gap)
                check(row_gap(s_f) > 0, f"{name}: every join copies a row "
                      "equal to the joiner's own")
            else:
                s_f = next(s for s in range(S)
                           if (sched.h[s][~sched.mask[s]] == 0).any()
                           and sched.h[s].max() > 0)
            run_f, codec, _, _, _ = _sched_engine(card, algo, quantize, mode,
                                                  fault)
            state, _ = run_f(states[s_f], s_f, inputs)
            rec["planted"][fault] = dict(bin=s_f, **_sched_readings(
                state.params, states[s_f + 1].params,
                None if is_join[s_f] else scales(codec, s_f),
                sched.perms[s_f], ybufs[s_f]))
        out[name] = rec
        check(S >= 4 and sched.density() < 1.0,
              f"{name}: schedule of {S} bins, density {sched.density()}")
        pairs = [(a, b) for a, b in zip(loss_card, loss_cpu)
                 if a is not None]
        check(all(math.isfinite(a) for a, _ in pairs),
              f"{name}: non-finite loss on card")
        check(np.allclose([a for a, _ in pairs], [b for _, b in pairs],
                          rtol=1e-4, atol=0),
              f"{name}: card loss {loss_card} != CPU loss {loss_cpu}")
        check(all(_within_bound(r) for r in readings),
              f"{name}: card vs CPU beyond the bound: {readings}")
        check(all(readings[s]["max_abs"] == 0.0 for s in range(S)
                  if is_join[s]), f"{name}: a join bin is not bitwise")
        check(not any(_within_bound(r) for r in rec["planted"].values()),
              f"{name}: a planted fault passes the bound: {rec['planted']}")
    check(out["churn_exact"]["join_bins"] and
          sum(out["churn_exact"]["retired"]) > 0,
          "churn case: no join bin or no leave")
    check(len(set(out["hier4_q8"]["tiers"])) == 2,
          "hier:4 case: bins of one tier only")
    log("sched_reference", **out)
    return out


def phase_sched_uniform_exact():
    """--rate-profile uniform against --rate-profile none, bitwise on the
    card: 3 supersteps of 8 nodes of transformer-wmt cut to 2 layers at its
    full width in fp32, q8 blocking, under PyTorch's deterministic
    algorithms. The synchronous trace's bins are the plain run's matchings
    with an all-True mask, so any difference is the mask's path."""
    import dataclasses
    import warnings
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves
    argv = ["--arch", "transformer-wmt", "--nodes", "8", "--H", "2",
            "--steps", "3", "--quantize"]
    cfg = dataclasses.replace(get_config("transformer-wmt"), n_layers=2,
                              dtype="float32", opt_state_dtype="float32")
    _fresh_memory()
    runs = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for profile in ("none", "uniform"):
                tr = train.build(train.build_parser().parse_args(
                    argv + ["--rate-profile", profile]), cfg)
                check(profile == "none" or tr.masks.all(),
                      "uniform trace: a bin with an idle node")
                runs[profile] = []
                for t in range(3):
                    m = tr.superstep(t)
                    runs[profile].append((tree_leaves(tr.state.params),
                                          float(m["loss"]),
                                          float(m["gamma"])))
                del tr
    finally:
        torch.use_deterministic_algorithms(False)
    equal = [all(same_bits(x, y) for x, y in zip(a[0], b[0]))
             and a[1:] == b[1:]
             for a, b in zip(runs["none"], runs["uniform"])]
    log("sched_uniform_exact", n_layers=cfg.n_layers, d_model=cfg.d_model,
        bitwise_equal=equal,
        losses={p: [r[1] for r in v] for p, v in runs.items()})
    del runs
    _fresh_memory()
    check(all(equal), f"uniform != none on the card: {equal}")


# the scheduler's four commands at full transformer-wmt
# width and depth (8 nodes, bf16), 3 --steps each (4 to 9 bins)
SCHED_COMMANDS = {
    "sched_lognormal_q8": ["--quantize"] + SCHED_LOGNORMAL,
    "sched_overlap_q8": ["--quantize", "--nonblocking", "--overlap",
                         "--rate-profile", "lognormal", "--straggler",
                         "0.25:8"],
    "sched_churn_q8": ["--quantize", "--rate-profile", "uniform_async",
                       "--avail", SCHED_AVAIL],
    "sched_hier4_q8": ["--quantize", "--rate-profile", "lognormal",
                       "--topology", "hier:4"],
}


def phase_sched_full_width():
    """Each scheduled command at full width, every launch counter at 0
    just after its build (the overlapped pipeline's prologue encode is
    not counted) and just before its run; -> {path: launches}. Asserts
    finite losses, at least 4 bins, sgd_update = Σ_s max_i h_{s,i},
    quantize_mod = the gossip bins, decode_avg = the gossip bins with a
    participant, 0 codec launches in every join bin, a retire and a join
    in the churn run and both tiers in the hier run; prints the bins and
    density, each bin's wall time and their median over the gossip bins
    after the first, peak memory and the sched_cost dict priced on the
    H100's datasheet figures."""
    import torch
    from repro_torch import hardware as HW
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch import train
    base = ["--arch", "transformer-wmt", "--nodes", "8", "--steps", "3",
            "--log-every", "1"]
    by_path, out = {}, {}
    for name, flags in SCHED_COMMANDS.items():
        argv = base + flags
        args = train.build_parser().parse_args(
            argv + ["--out", os.path.join(OUT_DIR, f"chip_smoke_{name}.json")])
        _fresh_memory()
        tr = train.build(args)
        sched = tr.schedule
        S = sched.n_supersteps
        join_deltas = []
        if tr.join is not None:
            join = tr.join

            def counted_join(state, perm, mask, join=join):
                before = dict(LAUNCHES)
                state = join(state, perm, mask)
                join_deltas.append({k: LAUNCHES[k] - before[k]
                                    for k in LAUNCHES})
                return state
            tr.join = counted_join
        reset_launch_counts()
        t0 = time.time()
        hist = train.run(args, tr)
        torch.cuda.synchronize()
        run_s = time.time() - t0
        counts = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        with open(args.out) as f:
            cost = json.load(f)["sched_cost"]
        gossip = [s for s in range(S) if not tr.is_join(s)]
        want = {"sgd_update": int(sum(int(sched.h[s].max())
                                      for s in gossip)),
                "quantize_mod": len(gossip),
                "decode_avg": sum(1 for s in gossip if sched.mask[s].any())}
        check(S >= 4, f"{name}: {S} bins")
        check(len(hist) == S and all(math.isfinite(h["loss"])
                                     for h in hist if "loss" in h),
              f"{name}: non-finite or missing records {hist}")
        check(counts == want, f"{name}: launch counts {counts} != {want}")
        check(all(d["quantize_mod"] == d["decode_avg"] == 0
                  for d in join_deltas),
              f"{name}: a codec kernel ran in a join bin {join_deltas}")
        if name == "sched_churn_q8":
            check(join_deltas and sched.retire.any(),
                  f"{name}: no join or no leave in the run")
        if name == "sched_hier4_q8":
            check(len(set(sched.tiers.tolist())) == 2,
                  f"{name}: bins of one tier only")
        walls = [h["wall_s"] for h in hist]
        bin_s = [b - a for a, b in zip([0.0] + walls, walls)]
        steady = [bin_s[s] for s in gossip[1:]]
        out[name] = dict(
            argv=argv, bins=S, density=sched.density(),
            join_bins=[s for s in range(S) if tr.is_join(s)],
            tiers=None if sched.tiers is None else sched.tiers.tolist(),
            hs_max=[int(x) for x in sched.h.max(axis=1)],
            launches=counts, launches_in_join_bins=join_deltas,
            records=hist, bin_s=bin_s,
            bin_median_s=statistics.median(steady) if steady else None,
            bin_note="wall time of each bin from the driver's records; the "
                     "median is over the gossip bins after the first",
            max_memory_allocated_bytes=peak,
            max_memory_reserved_bytes=torch.cuda.max_memory_reserved(),
            run_s=run_s,
            sched_cost=cost,
            priced_on={"card": HW.CARD, "power_limit_w": HW.POWER_LIMIT_W,
                       "peak_flops_bf16": HW.PEAK_FLOPS_BF16,
                       "hbm_bw": HW.HBM_BW, "nvlink_bw": HW.NVLINK_BW,
                       "ib_ndr_bw": HW.IB_NDR_BW,
                       "kind": "datasheet peaks, not measurements"})
        by_path[name] = counts
        del tr
    _fresh_memory()
    log("sched_full_width", **out)
    return by_path


# -- slice 5 (PR 15): the codec family, compress_state, the chunk driver --

# name, --codec spec, mode, compress_state, planted faults
CODEC_CASES = (
    ("q2", "q2", "blocking", False, ("average_dropped",)),
    ("q4", "q4", "blocking", False, ("average_dropped",)),
    ("q16_nonblocking", "q16", "nonblocking", False, ("average_dropped",)),
    ("bf16", "bf16", "blocking", False, ("average_dropped",)),
    ("topk_nonblocking", "topk:0.25", "nonblocking", False,
     ("average_dropped", "residual_kept")),
    ("compress_state_q8", None, "blocking", True, ("average_dropped",)),
)


def _codec_engine(device, spec, mode: str, compress: bool, fault: str = ""):
    """A superstep of `_reduced_engine`'s model (4 nodes) with the codec
    `spec`, wrapped so that it remembers, per encode, its per-row bound
    term (the lattice scale, or top-k's largest shipped magnitude); and a
    function that runs superstep t from a state on any device. `fault`
    plants a known-wrong exchange: "average_dropped" (the receiver takes
    its partner's decoded model) or "residual_kept" (top-k's residual is
    not updated by the send)."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.exchange import GossipTransport
    from repro_torch.core.swarm import SwarmConfig, SwarmState
    from repro_torch.core.swarm import make_swarm_step
    from repro_torch.models import TransformerLM
    from repro_torch.optim import make_optimizer
    from repro_torch.quant import codecs as C

    class Codec:
        def __init__(self, codec):
            self.codec, self.rows = codec, []

        def __getattr__(self, name):
            return getattr(self.codec, name)

        def _note(self, wire):
            if isinstance(self.codec, C.LatticeCodec):
                self.rows.append(wire[1].reshape(-1).cpu())
            elif isinstance(self.codec, C.TopKCodec):
                self.rows.append(wire[0].abs().amax(dim=1).cpu())

        def encode(self, *a, **kw):
            w = self.codec.encode(*a, **kw)
            self._note(w)
            return w

        def encode_ef(self, buf, prev_buf, rng, residual, **kw):
            w, r = self.codec.encode_ef(buf, prev_buf, rng, residual, **kw)
            self._note(w)
            if fault == "residual_kept":
                r = residual.clone()
            return w, r

        def encode_state(self, buf, rng, **kw):
            return self.codec.encode_state(buf, rng, **kw)

        def decode_avg(self, wire, ybuf, matched_rows=None, **kw):
            if fault == "average_dropped":
                return self.codec.decode(wire, ybuf, **kw)
            return self.codec.decode_avg(wire, ybuf, matched_rows, **kw)

    cfg = reduced(get_config("transformer-wmt"), n_layers=1, d_model=64)
    codec = Codec(C.make_codec(spec))
    opt = make_optimizer("sgd", lr=0.05, momentum=0.9)
    scfg = SwarmConfig(n_nodes=4, H=2, quantize=True, codec=spec,
                       nonblocking=mode == "nonblocking",
                       compress_state=compress)
    step = make_swarm_step(scfg, TransformerLM(cfg).functional_loss,
                           opt.update, lambda s: 0.05,
                           transport=GossipTransport(4, codec=codec))

    def move(x):
        if x is None or isinstance(x, torch.Tensor):
            return None if x is None else x.to(device)
        if isinstance(x, tuple):
            return tuple(move(v) for v in x)
        return {k: move(v) for k, v in x.items()}

    def run(state, t, inputs):
        perms, batches, us = inputs
        state = SwarmState(move(state.params), move(state.opt),
                           move(state.prev), t, None, move(state.residual))
        batch = {k: torch.from_numpy(v[t]).to(device)
                 for k, v in batches.items()}
        return step(state, batch, perms[t], [2] * 4, None,
                    u=torch.from_numpy(us[t][0]).to(device),
                    **({"u_state": torch.from_numpy(us[t][1]).to(device)}
                       if compress else {}))

    return run, codec, opt, scfg


def _codec_readings(spec, card, cpu, rows, perm):
    """Card vs CPU after one superstep: the share of coordinates within
    2e-5 and the count beyond 2e-5 plus the codec's term — one lattice
    step of the decoded (partner's) row; 2^-7 of the value for bf16 (one
    bf16 step of the cast, which an ulp upstream may flip); half the
    largest shipped magnitude of the partner's row for top-k (an ulp may
    swap two near-equal coordinates in or out of the top k) — and, for
    top-k, the residual's share and count against the largest shipped
    magnitude of its own row."""
    import torch
    from repro_torch.core import bucket as B
    bufs = [B.pack(B.build_layout(p), p).cpu() for p in (card.params,
                                                          cpu.params)]
    n = len(perm)
    d = (bufs[0] - bufs[1]).abs().reshape(n, -1, 256)
    idx = torch.as_tensor(perm, dtype=torch.long)
    if spec == "bf16":
        term = 2.0 ** -7 * bufs[1].abs().reshape(n, -1, 256)
    else:
        term = rows.reshape(n, -1, 1)[idx]
        if spec.startswith("topk"):
            term = 0.5 * term
    r = {"max_abs": float(d.max()),
         "share_within_2e-5": float((d <= 2e-5).double().mean()),
         "beyond_bound": int((d > term + 2e-5).sum())}
    if spec.startswith("topk"):
        dr = (card.residual.cpu() - cpu.residual).abs().reshape(n, -1, 256)
        r["residual_share_within_2e-5"] = float((dr <= 2e-5).double()
                                                .mean())
        r["residual_beyond_bound"] = int(
            (dr > rows.reshape(n, -1, 1) + 2e-5).sum())
    return r


def _codec_ok(r) -> bool:
    return (r["beyond_bound"] == 0 and r["share_within_2e-5"] >= 0.999
            and r.get("residual_beyond_bound", 0) == 0
            and r.get("residual_share_within_2e-5", 1.0) >= 0.999)


def phase_codecs_reference():
    """Each new codec on the card (kernels for the lattice family) against
    the CPU (plain versions): 3 supersteps of 4 nodes of the reduced model
    from one model on the CPU, each card superstep restarted from the
    CPU's state before it (parameters, momentum, comm copy — the wire
    tuple under compress_state — and top-k's residual), with the same
    batches, matchings and uniforms, held to `_codec_readings`' bound;
    planted faults must fail it in superstep 1. Also the zero-reference
    encode and plain decode of compress_state (quantize_mod against zeros,
    decode_avg with average off against zeros) kernel against plain at
    the main path's shape, bitwise."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import bucket as B
    from repro_torch.core.graph import complete, sample_matching
    from repro_torch.core.swarm import swarm_init
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.data import make_node_batches
    from repro_torch.kernels import ref
    from repro_torch.models import init_params
    from repro_torch.quant.codecs import make_codec
    from repro_torch.tree import tree_map
    n, steps = 4, 3
    cfg = reduced(get_config("transformer-wmt"), n_layers=1, d_model=64)
    g = torch.Generator()
    g.manual_seed(0)
    one = init_params(g, cfg, "cpu")
    rng = np.random.default_rng(0)
    perms = np.stack([sample_matching(complete(n), rng)
                      for _ in range(steps)])
    ds = SyntheticLMDataset(DataConfig(cfg.vocab_size, 32, seed=0), n)
    nbs = [make_node_batches(ds, t, 4) for t in range(steps)]
    batches = {k: np.stack([nb[k].reshape(n, 2, 2, 32) for nb in nbs])
               for k in nbs[0]}
    params = tree_map(lambda x: x[None].repeat((n,) + (1,) * x.ndim), one)
    n_padded = B.build_layout(params).n_padded
    us = rng.random((steps, 2, n, n_padded), dtype=np.float32)
    inputs = (perms, batches, us)
    out = {}
    for name, spec, mode, compress, faults in CODEC_CASES:
        _, _, opt, scfg = _codec_engine("cpu", spec, mode, compress)
        ug = torch.Generator()
        ug.manual_seed(1)
        state = swarm_init(ug, scfg, lambda _: tree_map(torch.clone, one),
                           opt.init)
        states, loss_cpu = [state], []
        for t in range(steps):
            run, codec, _, _ = _codec_engine("cpu", spec, mode, compress)
            state, m = run(states[t], t, inputs)
            states.append(state)
            loss_cpu.append(float(m["loss"]))
        loss_card, readings = [], []
        for t in range(steps):
            run, codec, _, _ = _codec_engine("cuda", spec, mode, compress)
            state, m = run(states[t], t, inputs)
            loss_card.append(float(m["loss"]))
            readings.append(_codec_readings(
                spec or "q8", state, states[t + 1],
                codec.rows[0] if codec.rows else None, perms[t]))
        rec = dict(loss_card=loss_card, loss_cpu=loss_cpu,
                   readings=readings, planted={})
        for fault in faults:
            run, codec, _, _ = _codec_engine("cuda", spec, mode, compress,
                                             fault)
            state, _ = run(states[1], 1, inputs)
            rec["planted"][fault] = _codec_readings(
                spec or "q8", state, states[2],
                codec.rows[0] if codec.rows else None, perms[1])
        out[name] = rec
        check(np.allclose(loss_card, loss_cpu, rtol=1e-4, atol=0),
              f"{name}: card loss {loss_card} != CPU loss {loss_cpu}")
        check(all(_codec_ok(r) for r in readings),
              f"{name}: card vs CPU beyond the bound: {readings}")
        check(not any(_codec_ok(r) for r in rec["planted"].values()),
              f"{name}: a planted fault passes the bound: {rec['planted']}")
    # compress_state's zero-reference kernels, kernel vs plain, bitwise
    _, layout = main_path_layout(8)
    rows = 8 * layout.n_padded // 256
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    x = torch.randn((rows, 256), generator=gen, device="cuda") * 0.02
    zeros = torch.zeros_like(x)
    u = torch.rand((rows, 256), generator=gen, device="cuda")
    codec = make_codec("q8")
    wire = codec.encode_state(x, None, u=u)
    rq, rs = ref.quantize_mod(x, zeros, u)
    errs = [bitwise(wire[0], rq, "encode_state codes (main-path shape)"),
            bitwise(wire[1], rs, "encode_state scales (main-path shape)")]
    dec = codec.decode_state(wire, x.shape)
    errs.append(bitwise(dec, ref.decode_avg(rq, rs, zeros, average=False),
                        "decode_state (main-path shape)"))
    del x, zeros, u, wire, rq, rs, dec
    _fresh_memory()
    log("codecs_reference", cases=out, state_codec_max_abs_err=max(errs))


# the five codec commands at full transformer-wmt width and depth (8 nodes,
# bf16), 4 supersteps each: flags, launches sgd_update / quantize_mod /
# decode_avg (counters at 0 after the build), declared wire bytes per node
CODEC_COMMANDS = {
    "codec_q4": (["--quantize", "--codec", "q4"], (8, 4, 4), 95_184_672),
    "codec_q16": (["--quantize", "--codec", "q16"], (8, 4, 4), 372_085_536),
    "codec_bf16": (["--quantize", "--codec", "bf16"], (8, 0, 0),
                   369_201_152),
    "codec_topk_nonblocking": (["--quantize", "--codec", "topk:0.25",
                                "--nonblocking"], (8, 0, 0), 230_750_720),
    "compress_state_q8": (["--quantize", "--compress-state"], (8, 8, 8),
                          187_484_960),
}


def phase_codecs_full_width():
    """Each codec command at full width, every launch counter at 0 after
    its build and before its run; -> {path: launches}. Asserts finite
    losses, the launches (compress_state adds one zero-reference encode
    and one plain decode a superstep), the declared wire bytes per node
    (ISSUE's table), the top-k residual's size and the compressed comm
    copy's bytes; prints each command's superstep median and peak
    memory."""
    import torch
    from repro_torch.core.exchange import transport_from_config
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch import train
    from repro_torch.tree import tree_leaves
    base = ["--arch", "transformer-wmt", "--nodes", "8", "--steps", "4",
            "--log-every", "1"]
    by_path, out = {}, {}
    for name, (flags, want, wire_bytes) in CODEC_COMMANDS.items():
        argv = base + flags
        args = train.build_parser().parse_args(argv)
        _fresh_memory()
        tr = train.build(args)
        declared = transport_from_config(tr.scfg).payload_num_bytes(
            tr.state.params, quantize=True)
        prev_bytes = nbytes(*(tr.state.prev if isinstance(tr.state.prev,
                                                          tuple)
                              else tree_leaves(tr.state.prev)))
        reset_launch_counts()
        t0 = time.time()
        hist = train.run(args, tr)
        torch.cuda.synchronize()
        run_s = time.time() - t0
        counts = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        check(len(hist) == 4 and all(math.isfinite(h["loss"])
                                     and math.isfinite(h["gamma"])
                                     for h in hist),
              f"{name}: non-finite or missing records {hist}")
        want = dict(zip(("sgd_update", "quantize_mod", "decode_avg"), want))
        check(counts == want, f"{name}: launch counts {counts} != {want}")
        check(declared == wire_bytes,
              f"{name}: declared wire bytes {declared} != {wire_bytes}")
        rec = {}
        if tr.state.residual is not None:
            rec["residual_bytes"] = nbytes(tr.state.residual)
            check(rec["residual_bytes"] == 8 * 4 * 721_096 * 256,
                  f"{name}: residual bytes {rec['residual_bytes']}")
        walls = [h["wall_s"] for h in hist]
        steady = [b - a for a, b in zip(walls, walls[1:])]
        out[name] = dict(argv=argv, records=hist, launches=counts,
                         wire_bytes_per_node=declared,
                         comm_copy_bytes=prev_bytes,
                         first_superstep_s=walls[0], superstep_s=steady,
                         superstep_median_s=statistics.median(steady),
                         max_memory_allocated_bytes=peak, run_s=run_s, **rec)
        by_path[name] = counts
        del tr
    _fresh_memory()
    log("codecs_full_width", **out)
    return by_path


# the transports' reference: name, algorithm, --gossip-impl, quantize, mode
TRANSPORT_CASES = tuple(
    (f"{impl}_{'q8' if q else 'exact'}", "swarm", impl, q, "blocking")
    for impl in ("ppermute", "ppermute_pool", "gather_legacy",
                 "ppermute_legacy", "ppermute_pool_legacy")
    for q in (False, True)) + (
    ("ppermute_nonblocking_q8", "swarm", "ppermute", True, "nonblocking"),
    ("ppermute_overlap_q8", "swarm", "ppermute", True, "overlap"),
    ("ppermute_pool_nonblocking_q8", "swarm", "ppermute_pool", True,
     "nonblocking"),
    ("ppermute_pool_overlap_q8", "swarm", "ppermute_pool", True, "overlap"),
    ("adpsgd_ppermute_pool_q8", "adpsgd", "ppermute_pool", True,
     "blocking"))


def _transport_engine(device, algo, impl, quantize, mode, fault=""):
    """A superstep of the reduced transformer-wmt swarm (4 nodes, one
    layer of d_model 64) on `device` over the transport `impl` (its static
    matching or pool of 4 built from seed 0 on the complete graph), with
    the recording codec and `fault` of `_recording_classes`. -> (run(state,
    t, inputs), codec, scfg, transport); `inputs` = (perms, batches, us)
    with batches by local-step depth and us[t] a flat [n, n_padded] array
    or, for a per-leaf oracle, a list of [n, nblocks, 256] arrays."""
    import torch
    from repro_torch.algorithms import make_algorithm
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.exchange import transport_from_config
    from repro_torch.core.graph import complete
    from repro_torch.core.swarm import SwarmConfig, SwarmState
    from repro_torch.models import TransformerLM
    from repro_torch.optim import make_optimizer
    Codec, Transport = _recording_classes(fault)
    cfg = reduced(get_config("transformer-wmt"), n_layers=1, d_model=64)
    n = 4
    scfg = SwarmConfig(n_nodes=n, H=2 if algo == "swarm" else 1,
                       quantize=quantize, nonblocking=mode != "blocking",
                       overlap=mode == "overlap", gossip_impl=impl,
                       pool_size=4)
    wiring = transport_from_config(scfg, complete(n), 0)
    codec = Codec()
    tr = Transport(n, impl=impl, codec=codec,
                   static_pairs=wiring.static_pairs,
                   matching_pool=wiring.matching_pool)
    opt = make_optimizer("sgd", lr=0.05, momentum=0.9)
    kw = dict(loss_fn=TransformerLM(cfg).functional_loss,
              opt_update=opt.update, lr_fn=lambda s: 0.05, n_nodes=n,
              transport=tr)
    if algo == "swarm":
        kw["scfg"] = scfg
    else:
        kw.update(quantize=quantize, nonblocking=mode == "nonblocking")
    step = make_algorithm(algo, **kw)

    def move(x):
        if x is None or isinstance(x, torch.Tensor):
            return None if x is None else x.to(device)
        if isinstance(x, (tuple, list)):
            return type(x)(move(v) for v in x)
        return {k: move(v) for k, v in x.items()}

    def run(state, t, inputs):
        perms, batches, us = inputs
        state = SwarmState(move(state.params), move(state.opt),
                           move(state.prev), t, move(state.inflight))
        batch = {k: torch.from_numpy(v[t]).to(device)
                 for k, v in batches[scfg.h_loop_bound].items()}
        u = us[t]
        u = [torch.from_numpy(a).to(device) for a in u] \
            if isinstance(u, list) else torch.from_numpy(u).to(device)
        return step(state, batch, perms[t], [scfg.h_loop_bound] * n, None,
                    u=u)

    return run, codec, scfg, tr


class _LeafScales:
    """The per-leaf encodes' scales of the last exchange of a *_legacy
    oracle, laid out as the flat buffer's rows (every leaf segment is
    padded to whole 256-blocks, so a leaf's blocks are those rows; the
    buffer's tail rows, all zero, take a step of 1)."""

    def __init__(self):
        from repro_torch.core import exchange as E
        self.leaf, self._orig = [], E.encode_modular

    def patch(self):
        def rec(cfg, x, ref, rng=None, **kw):
            q, sc = self._orig(cfg, x, ref, rng, **kw)
            self.leaf.append(sc.cpu())
            return q, sc
        from repro_torch.core import exchange as E
        return _planted((E, "encode_modular", rec))

    def rows(self, n, rows_per_node):
        import torch
        s = torch.cat([x.reshape(n, -1) for x in self.leaf], dim=1)
        self.leaf = []
        return torch.cat([s, torch.ones((n, rows_per_node - s.shape[1]))],
                         dim=1).reshape(-1)


def phase_transports_reference():
    """Every transport but gather on the card against the CPU, on the
    reduced transformer-wmt swarm, as `phase_reference` holds the gather
    transport: three supersteps, each card superstep restarted from the
    CPU's state before it with the same batches, perm input (the static
    matching, or the pool index broadcast) and uniforms, held to
    `_within_bound` (q8: one lattice step of the partner's row, the rows a
    per-leaf oracle's encode scaled). Planted faults must fail it:
    average_dropped (exact and the per-leaf oracles), one_step_off (flat
    q8). Then the bitwise pairs on the card: each flat exact impl equals
    its *_legacy oracle over 3 supersteps; ppermute_pool fed pool indices
    equals gather fed the matchings they select (q8, same uniforms); and
    ppermute_pool's chunked run (CUDA graph replay, the pool index a
    device input) equals its per-step run, blocking and overlapped q8."""
    import warnings
    import numpy as np
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import bucket as B
    from repro_torch.core.graph import complete
    from repro_torch.core.swarm import SwarmState, pipeline_prologue
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.data import make_node_batches
    from repro_torch.launch import train
    from repro_torch.models import init_params
    from repro_torch.tree import tree_leaves, tree_map
    n, steps = 4, 3
    cfg = reduced(get_config("transformer-wmt"), n_layers=1, d_model=64)
    g = torch.Generator()
    g.manual_seed(0)
    params = tree_map(lambda x: x[None].repeat((n,) + (1,) * x.ndim),
                      init_params(g, cfg, "cpu"))
    layout = B.build_layout(params)
    rng = np.random.default_rng(0)
    ds = SyntheticLMDataset(DataConfig(cfg.vocab_size, 32, seed=0), n)
    batches = {}
    for depth in (1, 2):
        nbs = [make_node_batches(ds, t, 2 * depth) for t in range(steps)]
        batches[depth] = {k: np.stack([nb[k].reshape(n, depth, 2, 32)
                                       for nb in nbs]) for k in nbs[0]}
    flat_us = rng.random((steps + 1, n, layout.n_padded), dtype=np.float32)
    leaf_us = [[rng.random((n, -(-int(np.prod(x.shape[1:])) // 256), 256),
                           dtype=np.float32) for x in tree_leaves(params)]
               for _ in range(steps)]
    out = {}
    for name, algo, impl, quantize, mode in TRANSPORT_CASES:
        legacy = impl.endswith("_legacy")
        run, _, scfg, tr = _transport_engine("cpu", algo, impl, quantize,
                                             mode)
        rng_np = np.random.default_rng(1)
        perms = np.stack([train.sample_gossip_perm(scfg, complete(n), rng_np,
                                                   0) for _ in range(steps)])
        inputs = (perms, batches, leaf_us if legacy else flat_us)
        state = SwarmState(params, _opt_init(params),
                           tree_map(torch.clone, params)
                           if quantize and mode != "overlap" else None, 0)
        if mode == "overlap":
            state = pipeline_prologue(scfg, state, None,
                                      u=torch.from_numpy(flat_us[steps]))
        states, loss_cpu = [state], []
        for t in range(steps):
            state, m = run(states[t], t, inputs)
            states.append(state)
            loss_cpu.append(float(m["loss"]))

        def node_perm(t):
            p, _ = tr.resolve_perm(torch.as_tensor(perms[t]))
            return p.numpy()

        clean = {}

        def card_step(t, fault=""):
            run_c, codec, _, _ = _transport_engine("cuda", algo, impl,
                                                   quantize, mode, fault)
            leaf = _LeafScales()
            with leaf.patch():
                st, m = run_c(states[t], t, inputs)
            if not quantize:
                sc = None
            elif mode == "overlap":
                sc = states[t].inflight["wire"][1].reshape(-1)
            elif legacy:
                # a planted fault that encodes nothing reads the clean
                # superstep's steps
                sc = leaf.rows(n, layout.rows_per_node) if leaf.leaf \
                    else clean[t]
            else:
                sc = codec.scales[-1]
            if not fault:
                clean[t] = sc
            return _readings(st.params, states[t + 1].params, sc,
                             node_perm(t)), float(m["loss"])
        readings, loss_card = [], []
        for t in range(steps):
            r, loss = card_step(t)
            readings.append(r)
            loss_card.append(loss)
        t_fault = 0 if mode == "blocking" else 1
        faults = ("average_dropped",) if not quantize or legacy \
            else ("one_step_off",)
        planted = {f: card_step(t_fault, f)[0] for f in faults}
        out[name] = dict(perm_input=perms.tolist(), loss_card=loss_card,
                         loss_cpu=loss_cpu, readings=readings,
                         planted=planted)
        check(np.allclose(loss_card, loss_cpu, rtol=1e-4, atol=0),
              f"transports {name}: card loss {loss_card} != CPU {loss_cpu}")
        check(all(_within_bound(r) for r in readings),
              f"transports {name}: card vs CPU beyond the bound: {readings}")
        check(not any(_within_bound(r) for r in planted.values()),
              f"transports {name}: a planted fault passes: {planted}")
    out["bitwise"] = _transport_pairs(params, batches, flat_us, steps)
    # the chunk driver on the pool: the graphs gather the matching from
    # the stacked pool by the device index
    base = ["--arch", "transformer-wmt", "--reduced", "--layers", "1",
            "--d-model", "64", "--nodes", "4", "--steps", "6", "--batch",
            "2", "--seq", "32", "--gossip-impl", "ppermute_pool",
            "--pool-size", "4", "--quantize"]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for case, flags in (("pool_q8", []),
                                ("pool_overlap_q8", ["--overlap"])):
                out["bitwise"][f"replay_{case}"] = _replay_vs_eager(
                    case, base + flags, None)
    finally:
        torch.use_deterministic_algorithms(False)
    _fresh_memory()
    log("transports_reference", **out)


def _opt_init(params):
    from repro_torch.optim import make_optimizer
    return make_optimizer("sgd", lr=0.05, momentum=0.9).init(params)


def _transport_pairs(params, batches, us, steps) -> dict:
    """The bitwise pairs of the transports, on the card, from `params`
    (reduced transformer-wmt, 4 nodes): -> {pair: True}; each pair must
    hold."""
    import numpy as np
    import torch
    from repro_torch.core import bucket as B
    from repro_torch.core.swarm import SwarmState
    from repro_torch.tree import tree_map

    def chain(impl, quantize, perms, u=us):
        run, _, _, tr = _transport_engine("cuda", "swarm", impl, quantize,
                                          "blocking")
        st = SwarmState(params, _opt_init(params),
                        tree_map(torch.clone, params) if quantize else None,
                        0)
        for t in range(steps):
            st, _ = run(st, t, (perms, batches, u))
        return B.pack(B.build_layout(st.params), st.params)

    out = {}
    pool = _transport_engine("cpu", "swarm", "ppermute_pool", False,
                             "blocking")[3].matching_pool
    rng = np.random.default_rng(2)
    idx = [int(rng.integers(len(pool))) for _ in range(steps)]
    pool_in = np.stack([np.full((4,), i, np.int32) for i in idx])
    gather_in = np.stack([pool[i] for i in idx])
    static = _transport_engine("cpu", "swarm", "ppermute", False,
                               "blocking")[3].static_pairs
    static_in = np.stack([B._perm_from_pairs(4, static)] * steps)
    for base, perms in (("gather", gather_in), ("ppermute", static_in),
                        ("ppermute_pool", pool_in)):
        out[f"{base}_exact_equals_legacy"] = same_bits(
            chain(base, False, perms), chain(base + "_legacy", False, perms))
    out["pool_equals_gather_q8"] = same_bits(chain("ppermute_pool", True,
                                                   pool_in),
                                             chain("gather", True, gather_in))
    check(all(out.values()), f"transports: a bitwise pair fails: {out}")
    return out


TRANSPORT_COMMANDS = {
    "transports_ppermute_q8": ["--quantize", "--gossip-impl", "ppermute"],
    "transports_pool_overlap_q8": ["--quantize", "--gossip-impl",
                                   "ppermute_pool", "--nonblocking",
                                   "--overlap"],
    "transports_gather_legacy_q8": ["--quantize", "--gossip-impl",
                                    "gather_legacy"],
}


def phase_transports_full_width(main_median_s):
    """The transports at full width: transformer-wmt x 8 nodes (as
    `main_path`), 3 supersteps each of `--quantize` under ppermute, under
    ppermute_pool --nonblocking --overlap and under the gather_legacy
    per-leaf oracle, every launch counter at 0 after the build, the q8
    wrap counter on; -> {path: launches}. Asserts finite records and the
    launches (flat: 6 / 3 / 3; the per-leaf oracle runs its codec in
    plain torch: 6 / 0 / 0), and prints the superstep times beside
    `main_path`'s median of this call, peak memory and the wraps."""
    import torch
    from repro_torch.core import bucket as B
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch import train
    base = ["--arch", "transformer-wmt", "--nodes", "8", "--H", "2",
            "--steps", "3", "--log-every", "1"]
    by_path, out = {}, {"main_path_superstep_median_s": main_median_s}
    for name, flags in TRANSPORT_COMMANDS.items():
        argv = base + flags
        args = train.build_parser().parse_args(argv)
        _fresh_memory()
        tr = train.build(args)
        reset_launch_counts()
        B.WRAPS = {}
        try:
            t0 = time.time()
            hist = train.run(args, tr)
            torch.cuda.synchronize()
            run_s = time.time() - t0
            wraps = _read_wraps()
        finally:
            B.WRAPS = None
        counts = dict(LAUNCHES)
        check(len(hist) == 3 and all(math.isfinite(h["loss"])
                                     and math.isfinite(h["gamma"])
                                     for h in hist),
              f"{name}: non-finite or missing records {hist}")
        want = {"sgd_update": 6, "quantize_mod": 3, "decode_avg": 3} \
            if "legacy" not in name else \
            {"sgd_update": 6, "quantize_mod": 0, "decode_avg": 0}
        check(counts == want, f"{name}: launch counts {counts} != {want}")
        walls = [h["wall_s"] for h in hist]
        steady = [b - a for a, b in zip(walls, walls[1:])]
        out[name] = dict(argv=argv, records=hist, launches=counts,
                         first_superstep_s=walls[0], superstep_s=steady,
                         superstep_median_s=statistics.median(steady),
                         max_memory_allocated_bytes=torch.cuda
                         .max_memory_allocated(),
                         max_memory_reserved_bytes=torch.cuda
                         .max_memory_reserved(), q8_wraps=wraps, run_s=run_s)
        by_path[name] = counts
        del tr
    _fresh_memory()
    log("transports_full_width", **out)
    return by_path


# the chunk driver's bitwise cases: name, flags. The geometric one's
# seed gives graph keys (min h, max h) (1,4) (1,3) (1,4) (1,3) (1,3) (1,4):
# its two graphs replay out of their capture order
SCAN_CASES = (
    ("blocking_q8", ["--quantize"]),
    ("overlap_q8", ["--quantize", "--overlap"]),
    ("geometric_overlap_q8", ["--quantize", "--overlap", "--h-mode",
                              "geometric", "--seed", "1"]),
    ("topk_nonblocking", ["--quantize", "--codec", "topk:0.25",
                          "--nonblocking"]),
    ("lognormal_masked_q8", ["--quantize"] + SCHED_LOGNORMAL),
    ("allreduce", ["--algo", "allreduce"]),
    ("localsgd", ["--algo", "localsgd", "--H", "2"]),
    ("dpsgd", ["--algo", "dpsgd", "--graph", "ring"]),
    ("adpsgd_q8", ["--algo", "adpsgd", "--quantize", "--nonblocking"]),
    ("sgp_q8", ["--algo", "sgp", "--quantize"]),
)


# the cases run again with ``remat`` on (each block recomputed in the
# captured superstep's backward pass), as `<name>_remat`
SCAN_REMAT_CASES = ("blocking_q8", "geometric_overlap_q8")


def _in_capture_order(keys) -> bool:
    """Whether a run's graph keys repeat the order of their first
    appearance (the order a shared pool is documented as safe for)."""
    order = list(dict.fromkeys(keys))
    return all(k == order[t % len(order)] for t, k in enumerate(keys))


def _pool_sites(pool) -> list:
    """[size, allocating function] of each block live in the CUDA graph
    pool `pool`, from the allocator's history (recorded around the run):
    the frame that names a cuBLAS workspace, else the first few frames."""
    import torch
    out = []
    for seg in torch.cuda.memory._snapshot()["segments"]:
        if tuple(seg["segment_pool_id"]) != tuple(pool):
            continue
        for b in seg["blocks"]:
            if b["state"] == "active_allocated":
                names = [f["name"] for f in b.get("frames", [])]
                site = next((x for x in names if "setWorkspaceForHandle" in x),
                            " < ".join(names[:8]))
                out.append([b["size"], site])
    return out


def _replay_vs_eager(name, argv, cfg, traced: bool = False) -> dict:
    """One chunked run (chunks of 4) against the per-step driver on the
    card, from `argv` through `train.build(args, cfg)`: the final state
    (params, momentum, comm copy, residual, in-flight payload), each
    superstep's loss and Γ, and the launch counts must be equal, bitwise.
    With `traced`, what the captures leave in the graphs' shared pool is
    traced to its allocation site. -> the case's record."""
    import numpy as np
    import torch
    from repro_torch.core.exchange import local_signature
    from repro_torch.core.scan import _POOL_ALLOWANCE, _state_leaves
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch import train
    args = train.build_parser().parse_args(argv)
    _fresh_memory()
    tr = train.build(args, cfg)
    n = tr.n_steps
    reset_launch_counts()
    per = [tr.superstep(t) for t in range(n)]
    per_loss = [float(m["loss"]) for m in per]
    per_gamma = [float(m["gamma"]) for m in per]
    per_counts = dict(LAUNCHES)
    per_state = [x.clone() for x in _state_leaves(tr.state)]
    del tr, per
    _fresh_memory()
    tr = train.build(args, cfg)
    if traced:
        torch.cuda.memory._record_memory_history(max_entries=200000)
    reset_launch_counts()
    ms = [tr.chunk(t, min(4, n - t),
                   [tr.node_batches(s) for s in range(t, min(t + 4, n))])
          for t in range(0, n, 4)]
    counts = dict(LAUNCHES)
    loss = [float(x) for m in ms for x in m["loss"]]
    gamma = [float(x) for m in ms for x in m["gamma"]]
    got = _state_leaves(tr.state)
    equal = len(got) == len(per_state) and all(
        same_bits(a, b) for a, b in zip(got, per_state))
    keys = [local_signature(tuple(int(x) for x in h), args.h_max)
            for h in tr.hs]
    out = dict(supersteps=n, graphs=len(tr.chunker.graphs),
               state_bitwise=equal,
               metrics_bitwise=loss == per_loss and gamma == per_gamma,
               launches_chunked=counts, launches_per_step=per_counts,
               loss=loss, pool_bytes_after_capture={
                   str(k): v for k, v in tr.chunker.pool_bytes.items()},
               pool_reserved_bytes=tr.chunker.pool_reserved(),
               local_keys=[list(k) for k in keys])
    if traced:
        sites = _pool_sites(tr.chunker._pool.id)
        torch.cuda.memory._record_memory_history(enabled=None)
        out["pool_blocks"] = sites
        check(len(tr.chunker.graphs) > 1 and not _in_capture_order(keys),
              f"scan {name}: its graphs replay in capture order ({keys}), "
              "so it tests nothing")
        check(all("setWorkspaceForHandle" in site for _, site in sites)
              and sum(b for b, _ in sites) <= _POOL_ALLOWANCE,
              f"scan {name}: the graphs' pool holds more than the cuBLAS "
              f"workspaces: {sites}")
    del tr, per_state, got
    check(equal and loss == per_loss and gamma == per_gamma,
          f"scan {name}: replay != per-step: {out} (per-step losses "
          f"{per_loss})")
    check(counts == per_counts,
          f"scan {name}: launches {counts} != {per_counts}")
    check(np.isfinite(loss).all(), f"scan {name}: {loss}")
    return out


def phase_scan_bitwise():
    """The chunk driver (CUDA graph replay) against the per-step driver
    (eager) on the card, bitwise: every case's final state (params,
    momentum, comm copy, residual, in-flight payload) and each superstep's
    loss and Γ, and the same launch counts, over 6 supersteps (chunks 4 +
    2; a schedule's bins likewise) of 8 nodes of transformer-wmt cut to 2
    layers at its full width (d_model 1024, vocab 32768, bf16 as the main
    path), under PyTorch's deterministic algorithms (the cuBLAS workspace
    is pinned in `main`), so that the two runs' own arithmetic reproduces.
    The geometric case's graphs replay out of capture order, and what its
    captures leave in the graphs' shared pool is traced to its allocation
    site: only the cuBLAS workspaces `core/scan.py` allows (none once an
    earlier driver of the process made them on the shared capture
    stream). The cases run with ``remat`` off, and those of
    SCAN_REMAT_CASES again with it on."""
    import dataclasses
    import warnings
    import torch
    from repro_torch.configs import get_config
    base = ["--arch", "transformer-wmt", "--nodes", "8", "--steps", "6",
            "--batch", "2", "--seq", "64", "--h-max", "4"]
    cfg = dataclasses.replace(get_config("transformer-wmt"), n_layers=2,
                              remat=False)
    out = {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "dtype": cfg.dtype}
    cases = [(name, flags, cfg) for name, flags in SCAN_CASES] + \
        [(f"{name}_remat", flags, dataclasses.replace(cfg, remat=True))
         for name, flags in SCAN_CASES if name in SCAN_REMAT_CASES]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for name, flags, c in cases:
                out[name] = _replay_vs_eager(
                    name, base + flags, c,
                    traced=name == "geometric_overlap_q8")
                out[name]["remat"] = c.remat
    finally:
        torch.use_deterministic_algorithms(False)
    _fresh_memory()
    log("scan_bitwise", **out)


# both at the main path's 8 nodes: under expandable segments the
# overlapped geometric command fits (with the allocator's fixed segments
# it ran out of the card's 79.18 GiB in its first capture)
SCAN_FULL_WIDTH = {
    "scan_blocking_q8": ["--nodes", "8", "--quantize"],
    "scan_overlap_q8_geometric": ["--nodes", "8", "--h-mode", "geometric",
                                  "--h-max", "8", "--quantize",
                                  "--nonblocking", "--overlap", "--non-iid",
                                  "0.5", "--eval-mean"],
}


def phase_scan_full_width(main_records):
    """The two commands with --scan-chunk 4 at full width (8 nodes), 8
    supersteps (two chunks: the first captures, the
    second replays what it can), launch
    counters at 0 just before each; -> {path: launches}. The blocking one
    is `main_path`'s command, whose per-step median of this call is
    printed beside the second chunk's time per superstep. Asserts finite
    records, launches (blocking: 16/8/8; overlapped: Σ_t max_i h_{t,i} /
    8 / 8, no prologue encode counted) and records every superstep, and
    that the blocking command's supersteps 0-3 have `main_path`'s loss and
    Γ bit for bit (the same command, per-step, earlier in this call)."""
    import numpy as np
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch import train
    base = ["--arch", "transformer-wmt", "--H", "2", "--steps", "8",
            "--log-every", "1", "--scan-chunk", "4"]
    by_path, out = {}, {}
    for name, flags in SCAN_FULL_WIDTH.items():
        argv = base + flags
        args = train.build_parser().parse_args(
            argv + ["--out", os.path.join(OUT_DIR, f"chip_smoke_{name}.json")])
        _fresh_memory()
        start = torch.cuda.memory_allocated()
        tr = train.build(args)
        reset_launch_counts()
        t0 = time.time()
        hist = train.run(args, tr)
        torch.cuda.synchronize()
        run_s = time.time() - t0
        counts = dict(LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        hs = np.asarray(tr.hs)
        want = {"sgd_update": int(hs.max(axis=1).sum()), "quantize_mod": 8,
                "decode_avg": 8}
        check([h["step"] for h in hist] == list(range(8))
              and all(math.isfinite(h["loss"]) for h in hist),
              f"{name}: non-finite or missing records {hist}")
        check(counts == want, f"{name}: launches {counts} != {want}")
        if name == "scan_blocking_q8":
            got = [(h["loss"], h["gamma"]) for h in hist[:4]]
            ref = [(h["loss"], h["gamma"]) for h in main_records]
            check(got == ref, f"{name}: chunked supersteps 0-3 {got} != "
                  f"the per-step main path's {ref}")
        # a chunk's records are logged once it ends: its last record's
        # wall time is the chunk's end (host batch staging included)
        ends = [hist[3]["wall_s"], hist[7]["wall_s"]]
        out[name] = dict(argv=argv, records=hist, hs=hs.tolist(),
                         launches=counts, graphs=len(tr.chunker.graphs),
                         keys=[list(k) for k in tr.chunker.graphs],
                         pool_bytes_after_capture={
                             str(k): v
                             for k, v in tr.chunker.pool_bytes.items()},
                         pool_reserved_bytes=tr.chunker.pool_reserved(),
                         chunk_end_s=ends,
                         second_chunk_superstep_s=(ends[1] - ends[0]) / 4,
                         first_chunk_s=ends[0],
                         max_memory_allocated_bytes=peak,
                         start_allocated_bytes=start,
                         max_memory_reserved_bytes=torch.cuda
                         .max_memory_reserved(), run_s=run_s)
        MEASURED_PEAKS[name] = peak - start
        by_path[name] = counts
        del tr
    walls = [h["wall_s"] for h in main_records]
    out["scan_blocking_q8"]["per_step_median_s_this_call"] = \
        statistics.median(b - a for a, b in zip(walls, walls[1:]))
    _fresh_memory()
    log("scan_full_width", **out)
    return by_path


# -- the dry run: the measured commands traced on fake tensors --

# name (a key of MEASURED_PEAKS) -> the flags of ``repro_torch.launch.
# dryrun`` for the same command: `main_path`'s blocking q8 driver and
# `scan_full_width`'s overlapped geometric one (8 transformer-wmt nodes
# on one card, a node's local step 4 x 128 tokens), and the decode step
# of `_profile_decode_step` (8 lanes over a 520-row cache)
DRYRUN_COMMANDS = {
    "main_path": ["--shape", "train_4k", "--nodes-per-gpu", "8", "--batch",
                  "4", "--seq", "128", "--quantize"],
    "scan_overlap_q8_geometric": ["--shape", "train_4k", "--nodes-per-gpu",
                                  "8", "--batch", "4", "--seq", "128",
                                  "--h-mode", "geometric", "--h-max", "8",
                                  "--quantize", "--overlap"],
    "serve_decode_transformer-wmt": ["--shape", "decode_32k",
                                     "--nodes-per-gpu", "1", "--batch", "8",
                                     "--seq", "520"],
}
# the fields a trace counts, equal on every device
DRYRUN_COUNTED = ("flops_per_dev", "argument_bytes", "temp_bytes",
                  "peak_bytes", "coll_bytes_per_dev", "coll_raw",
                  "wire_bytes_per_node", "h_traced")
# measured / predicted: a training command's peak allocated against the
# trace's peak; the decode step's allocation above its start against the
# trace's temp_bytes (its arguments are live before it starts). The trace
# leaves out only the allocator's rounding of a block up to 512 B and
# cuBLAS's workspaces (two of 32 MiB at the card's first matmuls):
# 1.0016 / 1.00002 / 1.000005 in the first measurement on the card
DRYRUN_BOUND = (0.995, 1.01)


# the most a dry run on fake CUDA tensors may hold on the card at once:
# torch's fake mode probes the CUDA context with a one-element tensor and
# moves host constants for real, one 512 B allocator block each, freed at
# once (512 or 1024 B at the peak in the runs measured: one or two
# blocks); the step holds nothing
DRYRUN_TOUCH_BYTES = 4096


def _fake_touch_ok(rec) -> bool:
    return rec["device_allocated_after_bytes"] == 0 and \
        rec["device_allocated_bytes"] <= DRYRUN_TOUCH_BYTES


def _dryrun_start(commands: dict, devices,
                  arch: str = "transformer-wmt") -> dict:
    """Start ``repro_torch.launch.dryrun`` of `arch` for every (command,
    device), all at once, one process each; -> the processes."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    out = os.path.join(OUT_DIR, "dryrun")
    procs = {}
    for name, flags in commands.items():
        for dev in devices:
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--device", dev, "--out", out, "--tag",
                   dev] + flags
            procs[name, dev] = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, env=env)
    return procs


def _dryrun_jobs(commands: dict, devices, procs=None,
                 arch: str = "transformer-wmt") -> dict:
    """Run ``repro_torch.launch.dryrun`` of `arch` for every (command,
    device), all at once, one process each (or wait for `procs`, which
    `_dryrun_start` started); -> {(name, device): record}."""
    procs = procs or _dryrun_start(commands, devices, arch)
    records = {}
    for key, p in procs.items():
        stdout, stderr = p.communicate(timeout=900)
        check(p.returncode == 0, f"dry run {key} failed:\n{stderr[-3000:]}")
        records[key] = json.loads(stdout.splitlines()[0])
    return records


def _measure_decode_step():
    """`serve_full_width`'s decode step alone (transformer-wmt at full
    width, 8 lanes over 512 prefilled rows), for ``--only dryrun``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config("transformer-wmt")
    _fresh_memory()
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg,
                         "cuda")
    log("decode_step", arch=cfg.name, **_profile_decode_step(cfg, params))
    del params
    _fresh_memory()


def phase_dryrun():
    """Each command of DRYRUN_COMMANDS traced by the dry run on fake CUDA
    tensors and on fake CPU tensors: every counted field equal, no device
    memory allocated; each predicted peak beside what its phase measured
    (MEASURED_PEAKS), the ratio within DRYRUN_BOUND."""
    import torch
    records = _dryrun_jobs(DRYRUN_COMMANDS, ("cuda", "cpu"))
    out = {}
    for name in DRYRUN_COMMANDS:
        cuda, cpu = records[name, "cuda"], records[name, "cpu"]
        differ = [k for k in DRYRUN_COUNTED if cuda.get(k) != cpu.get(k)]
        check(not differ, f"dry run {name}: cuda and cpu records differ in "
              f"{differ}")
        check(_fake_touch_ok(cuda), f"dry run {name} allocated "
              f"{cuda['device_allocated_bytes']} B on the card at its peak, "
              f"{cuda['device_allocated_after_bytes']} B at its end")
        decode = cuda["kind"] == "decode"
        predicted = cuda["temp_bytes"] if decode else cuda["peak_bytes"]
        measured = MEASURED_PEAKS[name]
        ratio = measured / predicted
        out[name] = dict(
            predicted_bytes=predicted, measured_bytes=measured,
            measured_over_predicted=ratio,
            compared="allocated above the step's start vs the trace's "
            "temp_bytes" if decode else "peak allocated vs the trace's "
            "peak_bytes",
            record={k: cuda[k] for k in (
                "argument_bytes", "temp_bytes", "peak_bytes",
                "device_allocated_bytes", "device_allocated_after_bytes",
                "flops_per_dev", "flops_analytic_per_dev",
                "model_flops_per_dev", "compute_s", "memory_s",
                "bottleneck", "fits", "t_trace_s", "wire_bytes_per_node")})
    log("dryrun", card=torch.cuda.get_device_name(0), bound=DRYRUN_BOUND,
        total_memory_bytes=torch.cuda.get_device_properties(0).total_memory,
        **out)
    for name, r in out.items():
        lo, hi = DRYRUN_BOUND
        check(lo <= r["measured_over_predicted"] <= hi,
              f"dry run {name}: measured {r['measured_bytes']} over "
              f"predicted {r['predicted_bytes']} = "
              f"{r['measured_over_predicted']:.4f} outside {DRYRUN_BOUND}")


# -- serving: the model's inference modes, the engine, checkpoints --

SERVE_REF_ARCHS = ("transformer-wmt", "olmo-1b", "mamba2-780m")
SERVE_FULL_ARCHS = ("transformer-wmt", "mamba2-780m")
SERVE_BOUND = 2e-5
SERVE_LENS = (3, 8, 5, 1, 7)         # ragged prompts of the engine checks


class _planted:
    """Replace module attributes for the body of a `with` (a planted
    fault on the card side), restored after."""

    def __init__(self, *patches):
        self.patches = patches            # (module, name, replacement)

    def __enter__(self):
        self.saved = [(m, n, getattr(m, n)) for m, n, _ in self.patches]
        for m, n, f in self.patches:
            setattr(m, n, f)

    def __exit__(self, *exc):
        for m, n, f in self.saved:
            setattr(m, n, f)


def _serve_faults():
    """name -> (archs it applies to, the patches that plant it)."""
    import torch
    from repro_torch.models import attention, ssm
    from repro_torch.models import transformer as tf
    write = tf._cache_write
    gather = attention.gather_pages
    mask = ssm.mask_padded_dt
    return {
        "cache_at_len_plus_1": (
            ("transformer-wmt", "olmo-1b"),
            ((tf, "_cache_write",
              lambda c, new, idx: write(c, new, idx + 1)),)),
        "page_table_shifted": (
            ("transformer-wmt", "olmo-1b"),
            ((attention, "gather_pages",
              lambda pool, pages: gather(pool,
                                         torch.roll(pages, 1, dims=-1))),)),
        "padded_dt_nonzero": (
            ("mamba2-780m",),
            ((ssm, "mask_padded_dt",
              lambda dt, nv: mask(dt, nv + 1)),)),
    }


def _serve_readings(cfg, params, dev, prompts, chunks, step_tokens,
                    tp=None):
    """The model's serving modes on `dev` from `params`: prefill logits,
    teacher-forced decode logits (the tokens `step_tokens` fed to every
    device), the same decode through page pools (attention archs) and
    ragged chunk-mode logits and states -> dict of CPU fp32 tensors. On
    the model axis (`tp`, `params` a GPU's slices) the logits, whole on
    every GPU; the states are the GPU's and are left out."""
    import torch
    from repro_torch.launch.serve import make_serve_fns
    from repro_torch.models import forward, init_cache, logits_head
    from repro_torch.serve import paged as P
    from repro_torch.serve.engine import grow_cache
    from repro_torch.tree import keystr, tree_key_paths, tree_leaves
    prefill, decode_step = make_serve_fns(cfg, tp)
    toks = torch.from_numpy(prompts).to(dev)
    B, L = toks.shape
    logits, c = prefill(params, toks)
    out = {"prefill": logits}
    cache = grow_cache(init_cache(cfg, B, 16, device=dev, tp=tp), c)
    steps = []
    for t in step_tokens:
        lg, cache = decode_step(params, cache, torch.from_numpy(t).to(dev))
        steps.append(lg)
    out["decode"] = torch.cat(steps, dim=1)
    if P.attn_layer_entries(cfg):
        dense = grow_cache(init_cache(cfg, B, 16, device=dev, tp=tp), c)
        lane, rows = P.strip_attn_kv(cfg, dense)
        lane["len"] = torch.full((B,), L, dtype=torch.int32, device=dev)
        tables = torch.tensor([[5, 1, 7, 3], [2, 6, 0, 4]],
                              dtype=torch.int32, device=dev)
        pools = P.scatter_tree(
            P.build_pools(cfg, 8, 4, torch.float32, dev, tp), rows, tables,
            torch.zeros(B, dtype=torch.int64, device=dev),
            torch.full((B,), L, dtype=torch.int64, device=dev),
            torch.ones(B, dtype=torch.bool, device=dev), 4)
        lane["pages"] = tables
        steps = []
        for t in step_tokens:
            h, c2, _ = forward(cfg, params, torch.from_numpy(t).to(dev),
                               mode="decode", cache=lane, pools=pools,
                               tp=tp)
            c2, new_rows = P.split_new_rows(c2)
            pools = P.scatter_tree(pools, new_rows, tables, lane["len"],
                                   torch.ones(B, dtype=torch.int64,
                                              device=dev),
                                   torch.ones(B, dtype=torch.bool,
                                              device=dev), 4)
            lane = c2
            steps.append(logits_head(cfg, params, h, tp))
        out["paged_decode"] = torch.cat(steps, dim=1)
    cache = init_cache(cfg, B, 16, device=dev, tp=tp)
    for ch, nv in chunks:
        h, cache, _ = forward(cfg, params, torch.from_numpy(ch).to(dev),
                              mode="chunk", cache=cache,
                              n_valid=torch.tensor(nv, device=dev),
                              moe_per_lane=True, tp=tp)
        out.setdefault("chunk", []).append(logits_head(cfg, params, h, tp))
    out["chunk"] = torch.cat(out["chunk"], dim=1)
    for path, leaf in zip(tree_key_paths(cache), tree_leaves(cache)):
        if leaf.is_floating_point() and tp is None:
            out["chunk_state" + keystr(path)] = leaf
    return {k: v.detach().float().cpu() for k, v in out.items()}


def _serve_engine_tokens(cfg, params, dev, prompts, tp=None, **kw):
    """Greedy tokens of the engine on `dev` over ragged `prompts` (on the
    model axis `tp`, `params` a GPU's slices)."""
    from repro_torch.serve import EngineConfig, Request, ServeEngine
    eng = ServeEngine(cfg, EngineConfig(max_slots=2, prompt_len=8,
                                        max_new_tokens=8, queue_depth=16,
                                        **kw), params=params, device=dev,
                      tp=tp)
    for i, p in enumerate(prompts):
        eng.submit(Request(i, p))
    eng.drain()
    s = eng.metrics.summary()
    return {c.rid: c.tokens.tolist() for c in eng.completions}, s


def phase_serve_reference():
    """Reduced serving (2 layers, d_model 32, fp32) of transformer-wmt,
    olmo-1b and mamba2-780m on the card against the CPU from the same
    weights and prompts: prefill, teacher-forced decode, paged decode and
    ragged chunk logits and states within 2e-5; one-shot greedy tokens
    and the dense, paged (page 4) and chunked (chunk 4) engines' tokens
    equal the CPU's; planted faults (the cache written at len + 1, a page
    table shifted by one page, padded chunk tokens with dt != 0) must
    fail the bound."""
    import argparse
    import numpy as np
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.serve import make_generators, run_oneshot
    from repro_torch.models import init_params
    from repro_torch.tree import tree_map
    faults = _serve_faults()
    out = {}
    for arch in SERVE_REF_ARCHS:
        cfg = reduced(get_config(arch), n_layers=2, d_model=32)
        gen = torch.Generator().manual_seed(0)
        cpu_p = init_params(gen, cfg, "cpu")
        card_p = tree_map(lambda x: x.to("cuda"), cpu_p)
        rng = np.random.default_rng(0)
        prompts = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
        steps = [rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int64)
                 for _ in range(6)]
        chunks = [(rng.integers(0, cfg.vocab_size, (2, 4)).astype(np.int64),
                   nv) for nv in ([4, 4], [4, 1], [2, 0])]
        want = _serve_readings(cfg, cpu_p, "cpu", prompts, chunks, steps)

        def reading(got):
            return {k: float((got[k] - want[k]).abs().max()) for k in want}
        clean = reading(_serve_readings(cfg, card_p, "cuda", prompts,
                                        chunks, steps))
        planted = {}
        for name, (archs, patches) in faults.items():
            if arch in archs:
                with _planted(*patches):
                    planted[name] = reading(_serve_readings(
                        cfg, card_p, "cuda", prompts, chunks, steps))
        one = {}
        for dev, p in (("cpu", cpu_p), ("cuda", card_p)):
            args = argparse.Namespace(device=dev, gen=8, temperature=0.0,
                                      batch=2, prompt_len=8)
            one[dev] = run_oneshot(cfg, args, p, make_generators(0, dev),
                                   prompts=prompts)["tokens"].tolist()
        ragged = [rng.integers(0, cfg.vocab_size, L).astype(np.int32)
                  for L in SERVE_LENS]
        engines = {}
        for mode, kw in (("dense", {}),
                         ("paged", dict(paged=True, page_size=4)),
                         ("chunked", dict(prefill_chunk=4)),
                         ("chunked_paged", dict(prefill_chunk=4, paged=True,
                                                page_size=4))):
            cpu_tok, _ = _serve_engine_tokens(cfg, cpu_p, "cpu", ragged,
                                              **kw)
            card_tok, s = _serve_engine_tokens(cfg, card_p, "cuda", ragged,
                                               **kw)
            engines[mode] = dict(equal=card_tok == cpu_tok,
                                 decode_cache_misses=s["decode_cache_misses"],
                                 prefill_cache_misses=s[
                                     "prefill_cache_misses"])
        out[arch] = dict(max_abs=clean, planted=planted,
                         oneshot_tokens_equal=one["cpu"] == one["cuda"],
                         engines=engines)
        check(all(v <= SERVE_BOUND for v in clean.values()),
              f"{arch}: card vs CPU beyond {SERVE_BOUND}: {clean}")
        check(one["cpu"] == one["cuda"], f"{arch}: one-shot tokens differ")
        check(all(e["equal"] and e["decode_cache_misses"] == 0
                  and e["prefill_cache_misses"] == 0
                  for e in engines.values()),
              f"{arch}: engine tokens or signatures {engines}")
        for name, r in planted.items():
            check(any(v > SERVE_BOUND for v in r.values()),
                  f"{arch}: planted fault {name} passes the bound: {r}")
    log("serve_reference", bound=SERVE_BOUND, **out)


def _profile_decode_step(cfg, params, batch: int = 8, plen: int = 512):
    """One decode step of the one-shot path (8 lanes over 512 cached
    rows) under torch.profiler, after two warm-up steps: its wall time
    (host clock to a sync, profiler on), device busy time (union of the
    kernel, memcpy and memset intervals), idle share, kernels launched and
    the top kernels (``repro_torch.launch.profile.summarize``)."""
    import tempfile
    import torch
    from repro_torch.launch.profile import summarize
    from repro_torch.launch.serve import make_serve_fns
    from repro_torch.models import init_cache
    from repro_torch.serve.engine import grow_cache
    prefill, decode_step = make_serve_fns(cfg)
    toks = torch.randint(0, cfg.vocab_size, (batch, plen), device="cuda",
                         generator=torch.Generator(
                             device="cuda").manual_seed(2))
    logits, c = prefill(params, toks)
    cache = grow_cache(init_cache(cfg, batch, plen + 8, device="cuda"), c)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    for _ in range(2):
        logits, cache = decode_step(params, cache, tok)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    # one step unprofiled: what it allocates above the params, cache and
    # token it is given (and whatever else is live)
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    logits, cache = decode_step(params, cache, tok)
    torch.cuda.synchronize()
    above = torch.cuda.max_memory_allocated() - start
    MEASURED_PEAKS[f"serve_decode_{cfg.name}"] = above
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        logits, cache = decode_step(params, cache, tok)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "decode_trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            s = summarize(json.load(f), wall_ms, top=5)
    return {**{k: s[k] for k in ("wall_ms", "device_busy_ms", "idle_share",
                                 "n_kernels", "top_kernels")},
            "allocated_above_start_bytes": above}


def _serve_engine_run(cfg, params, prompts, *, swap=None, slots=8,
                      new_tokens=64, **kw):
    """The engine at full width: `slots` slots (8), the prompts' length,
    `new_tokens` new tokens (64); `swap` = (params, decode steps before
    the publish). -> (completions, summary, peak bytes, wall s)."""
    import torch
    from repro_torch.serve import EngineConfig, Request, ServeEngine
    _fresh_memory()
    eng = ServeEngine(cfg, EngineConfig(max_slots=slots,
                                        prompt_len=len(prompts[0]),
                                        max_new_tokens=new_tokens,
                                        queue_depth=32, **kw),
                      params=params, device="cuda")
    for i, p in enumerate(prompts):
        eng.submit(Request(i, p))
    t0 = time.time()
    if swap is not None:
        new, n_steps = swap
        eng.step()                       # admits (and prefills) 8 lanes
        while min(len(ln.tokens) for ln in eng.lanes if ln.active) \
                < 1 + n_steps:
            eng.step()
        eng.swap.publish(new, tag="B")
    eng.drain()
    torch.cuda.synchronize()
    wall = time.time() - t0
    return (eng.completions, eng.metrics.summary(),
            torch.cuda.max_memory_allocated(), wall)


def phase_serve_full_width():
    """Both serving configurations at full width and depth in bf16: the
    one-shot command (--batch 8 --prompt-len 512 --gen 64) through
    ``repro_torch.launch.serve``, then the engine (8 slots, 16 requests of
    512 tokens, 64 new) four ways: dense blocking, dense --prefill-chunk
    128, paged --page-size 16 with chunk 128, and dense blocking with a
    hot swap after 8 decode steps. Asserts paged == dense bitwise under
    the same prefill schedule, the swap's first lanes bitwise the no-swap
    run's on generation 1 and the later ones on generation 2, nothing
    dropped, no shape signature added by a swap or by chunking (a bf16
    SSM bank's one widening apart) and finite logits; prints the chunked
    schedule's agreement with blocking and the largest logit difference of
    one prompt prefilled both ways, from the bank before and after its
    first decode; launches 0/0/0."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch import serve
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models import forward, init_cache, init_params, \
        logits_head
    from repro_torch.tree import tree_map_with_path
    out, by_path = {}, {}
    for arch in SERVE_FULL_ARCHS:
        cfg = get_config(arch)
        _fresh_memory()
        reset_launch_counts()
        argv = ["--arch", arch, "--batch", "8", "--prompt-len", "512",
                "--gen", "64"]
        one = serve.main(argv)
        one_peak = torch.cuda.max_memory_allocated()
        check(one["finite"] and one["tokens"].shape == (8, 64),
              f"{arch}: one-shot logits not finite or tokens missing")
        gen = torch.Generator(device="cuda").manual_seed(0)
        pA = init_params(gen, cfg, "cuda")
        pB = init_params(gen, cfg, "cuda")
        step_profile = _profile_decode_step(cfg, pA)
        prompts = make_prompts(cfg, 16, 512,
                               torch.Generator().manual_seed(1))
        runs = {}
        for name, kw in (("dense_blocking", {}),
                         ("dense_chunked", dict(prefill_chunk=128)),
                         ("paged_chunked", dict(paged=True, page_size=16,
                                                prefill_chunk=128)),
                         ("dense_swap", dict(swap=(pB, 8)))):
            done, s, peak, wall = _serve_engine_run(cfg, pA, prompts, **kw)
            runs[name] = dict(tokens={c.rid: (c.tokens.tolist(), c.gen)
                                      for c in done},
                              summary=s, peak=peak, wall_s=wall)
        counts = dict(LAUNCHES)
        toks = {k: v["tokens"] for k, v in runs.items()}
        # a bf16 SSM state widens to fp32 once, at the bank's first decode,
        # as the reference's does: one more signature for the decode step
        # and for the chunk step (which runs before and after it); a swap
        # and chunked admission add none
        widen = int(cfg.dtype != "float32" and any(
            mx == "mamba" for mx, _ in cfg.pattern + cfg.tail_pattern))
        for name, r in runs.items():
            s = r["summary"]
            chunked = name.endswith("chunked")
            check(s["completed"] == 16 and s["dropped_in_flight"] == 0
                  and s["decode_cache_misses"] == widen
                  and s["prefill_cache_misses"] == widen * chunked,
                  f"{arch} {name}: {s} (the bank's widening: {widen})")
        check(toks["paged_chunked"] == toks["dense_chunked"],
              f"{arch}: paged != dense under chunked prefill")
        before = [r for r in range(16) if toks["dense_swap"][r][1] == 1]
        check(before and all(toks["dense_swap"][r] == toks[
            "dense_blocking"][r] for r in before)
              and all(toks["dense_swap"][r][1] == 2
                      for r in range(16) if r not in before),
              f"{arch}: hot swap: lanes before it differ or later lanes "
              "not on generation 2")
        agree = np.mean([a == b for r in range(16) for a, b in
                         zip(toks["dense_chunked"][r][0],
                             toks["dense_blocking"][r][0])])
        # one prompt prefilled blocking vs in 4 chunks of 128, from a
        # cache as the engine's bank holds it before its first decode (the
        # SSM state in the model's dtype: the engine's first wave) and
        # after it (the SSM state in fp32: every later admission)
        p0 = torch.from_numpy(prompts[:1]).to("cuda")
        hb, _, _ = forward(cfg, pA, p0, mode="prefill")
        lb = logits_head(cfg, pA, hb[:, -1:])
        chunk_diff = {}
        for bank, ssm_dtype in (("first_wave", None),
                                ("after_first_decode", torch.float32)):
            cache = init_cache(cfg, 1, 576, device="cuda")
            if ssm_dtype is not None:
                cache = tree_map_with_path(
                    lambda p, x: x.to(ssm_dtype) if p[-1] == "ssm" else x,
                    cache)
            for c in range(4):
                hc, cache, _ = forward(
                    cfg, pA, p0[:, 128 * c:128 * (c + 1)], mode="chunk",
                    cache=cache, n_valid=128)
            lc = logits_head(cfg, pA, hc[:, -1:])
            check(bool(torch.isfinite(lb).all()
                       and torch.isfinite(lc).all()),
                  f"{arch}: non-finite logits")
            chunk_diff[bank] = float((lb - lc).abs().max())
        out[arch] = dict(
            oneshot=dict(argv=argv, prefill_ms=one["prefill_ms"],
                         decode_ms_per_token=one["decode_ms_per_token"],
                         tokens_per_s=8e3 / one["decode_ms_per_token"],
                         max_memory_allocated_bytes=one_peak),
            decode_step_profile=step_profile,
            engine={k: dict(wall_s=v["wall_s"],
                            max_memory_allocated_bytes=v["peak"],
                            **{m: v["summary"][m] for m in (
                                "tokens", "tokens_per_s", "latency_p50_ms",
                                "latency_p99_ms", "ttft_p50_ms",
                                "ttft_p99_ms", "kv_bytes", "kv_dense_bytes",
                                "kv_pool_pages", "pool_pages_peak",
                                "swaps_adopted", "decode_cache_misses",
                                "prefill_cache_misses")})
                    for k, v in runs.items()},
            swap_lanes_before=before,
            chunked_vs_blocking_token_agreement=float(agree),
            chunked_vs_blocking_max_logit_diff=chunk_diff,
            launches=counts)
        check(counts == {"sgd_update": 0, "quantize_mod": 0,
                         "decode_avg": 0}, f"{arch}: launches {counts}")
        by_path[f"serve_{arch}"] = counts
        del pA, pB
    _fresh_memory()
    log("serve_full_width", **out)
    return by_path


def _by_rows(fn, *ts, rows_a_part: int = 1 << 20):
    """`fn` (a plain version that works row by row) over slices of about
    `rows_a_part` rows of `ts`, its outputs concatenated: bitwise the one
    call, with fp32 temporaries of at most ~1 GiB at a large model's
    shape."""
    import torch
    n = ts[0].shape[0]
    outs = [fn(*(t[i:i + rows_a_part] for t in ts))
            for i in range(0, n, rows_a_part)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(o) for o in zip(*outs))
    return torch.cat(outs)


SERVE_CKPT_CASES = (("transformer-wmt", ("q8", "q4", "bf16")),
                    ("mamba2-780m", ("q8", "q4", "bf16")),
                    ("granite-moe-3b-a800m", ("q8",)))


def phase_serve_checkpoint():
    """Serving checkpoints of both full-width models, q8, q4 and bf16, and
    of granite-moe-3b-a800m (its [E, D, F] expert leaves in the flat
    buffer), q8: export then load, launch counters at 0 just before
    each. Asserts
    quantize_mod 1 / decode_avg 0 on export and 0 / 1 on load for a
    lattice codec (0 / 0 for bf16); for a lattice codec, the exported wire
    and the kernel's encode of the export's buffer and uniforms each
    bitwise the plain encode of them; the load bitwise a plain decode of
    the same wire, the wire bytes the codec's declared layout, and
    the loaded model's greedy tokens those of the plain decode's; prints
    the codec times at these shapes (CUDA events) and the bytes."""
    import argparse
    import shutil
    import numpy as np
    import torch
    from repro_torch.checkpoint import load_checkpoint, load_metadata
    from repro_torch.configs import get_config
    from repro_torch.core import bucket as B
    from repro_torch.kernels import LAUNCHES, ops, ref, reset_launch_counts
    from repro_torch.launch.serve import (make_generators, params_like,
                                          run_oneshot)
    from repro_torch.models import init_params
    from repro_torch.quant.codecs import make_codec
    from repro_torch.serve import (export_serving_checkpoint,
                                   load_serving_checkpoint)
    from repro_torch.tree import tree_leaves
    root = os.path.join(ROOT, "build", "chip_smoke_serve_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    out, by_path = {}, {}
    for arch, specs in SERVE_CKPT_CASES:
        cfg = get_config(arch)
        _fresh_memory()
        params = init_params(torch.Generator(device="cuda").manual_seed(0),
                             cfg, "cuda")
        like = params_like(cfg)
        flat = B.build_flat_layout(like)
        for spec in specs:
            codec = make_codec(spec)
            lattice = spec != "bf16"
            path = os.path.join(root, f"{arch}_{spec}")
            reset_launch_counts()
            n_bytes = export_serving_checkpoint(path, params, spec)
            torch.cuda.synchronize()
            c_export = dict(LAUNCHES)
            reset_launch_counts()
            loaded = load_serving_checkpoint(path, like, device="cuda")
            torch.cuda.synchronize()
            c_load = dict(LAUNCHES)
            meta = load_metadata(path)
            rows = flat.n_padded // codec.block
            wire_like = {f"wire_{g.name}": torch.empty(
                (rows, g.cols), device="cuda",
                dtype=torch.bfloat16 if g.dtype == "bfloat16"
                else getattr(torch, g.dtype))
                for g in codec.wire_layout().groups}
            wire_t = load_checkpoint(path, wire_like)
            wire = tuple(wire_t[f"wire_{n}"] for n in meta["wire_groups"])
            del wire_t, wire_like
            zero = torch.zeros((rows, codec.block), device="cuda")
            # the plain version of the same decode, on the card
            dec = _by_rows(lambda *t: ref.decode_avg(
                *t, bits=codec.quant.bits, average=False,
                pack4=codec.packed), *wire, zero) \
                if lattice else codec.decode(wire, zero)
            plain = B.unpack_flat(flat, dec.reshape(-1))
            del dec
            same = all(same_bits(a, b) for a, b in
                       zip(tree_leaves(loaded), tree_leaves(plain)))
            declared = codec.payload_num_bytes(flat.n_padded)
            real = sum(w.numel() * w.element_size() for w in wire)
            args = argparse.Namespace(device="cuda", gen=8, temperature=0.0,
                                      batch=2, prompt_len=64)
            prompts = np.random.default_rng(0).integers(
                0, cfg.vocab_size, (2, 64)).astype(np.int32)
            tk = [run_oneshot(cfg, args, p, make_generators(0, "cuda"),
                              prompts=prompts)["tokens"].tolist()
                  for p in (loaded, plain)]
            del loaded, plain
            timing, encode_checks = {}, {}
            if lattice:
                # the export's own buffer and uniforms (seed 0, drawn as
                # export_serving_checkpoint draws them): the exported wire
                # and the kernel's encode are each bitwise the plain encode
                q = codec.quant
                buf = B.pack_flat(flat, params)
                zbuf = zero.reshape(-1)
                u = torch.rand(buf.shape, generator=torch.Generator(
                    device="cuda").manual_seed(0), dtype=torch.float32,
                    device="cuda")
                enc = dict(bits=q.bits, pack4=codec.packed)
                qkw = dict(safety=q.safety, min_scale=q.min_scale, **enc)
                pq, ps = _by_rows(lambda *t: ref.quantize_mod(*t, **qkw),
                                  *(t.reshape(rows, codec.block)
                                    for t in (buf, zbuf, u)))
                kq, ks, _ = ops.quantize_mod(buf, zbuf, u, **qkw)
                encode_checks = dict(
                    export_wire_bitwise_plain=same_bits(wire[0], pq)
                    and same_bits(wire[1], ps),
                    encode_bitwise_plain=same_bits(kq, pq)
                    and same_bits(ks, ps))
                del pq, ps, kq, ks
                # each kernel alone at this model's shape, beside its bound
                e_ms = time_ms(lambda: ops.quantize_mod(buf, zbuf, u, **qkw))
                d_ms = time_ms(lambda: ops.decode_avg(*wire, zbuf,
                                                      average=False, **enc))
                eb_ms, eb_by = bound(nbytes(buf, zbuf, u, *wire),
                                     7 * buf.numel())
                db_ms, db_by = bound(nbytes(*wire, zbuf, buf),
                                     9 * buf.numel())
                timing = dict(rows=rows, encode_ms=e_ms, encode_bound_ms=eb_ms,
                              encode_bound_by=eb_by, decode_ms=d_ms,
                              decode_bound_ms=db_ms, decode_bound_by=db_by)
                del buf, zbuf, u
            want_e = {"sgd_update": 0, "quantize_mod": int(lattice),
                      "decode_avg": 0}
            want_l = {"sgd_update": 0, "quantize_mod": 0,
                      "decode_avg": int(lattice)}
            out[f"{arch}_{spec}"] = dict(
                launches_export=c_export, launches_load=c_load,
                load_bitwise_plain=same, wire_bytes=n_bytes,
                declared_bytes=declared, file_bytes=os.path.getsize(
                    path + ".npz"), greedy_tokens_equal=tk[0] == tk[1],
                n_padded=flat.n_padded, **encode_checks, **timing)
            by_path[f"serve_ckpt_{arch}_{spec}"] = {
                k: c_export[k] + c_load[k] for k in c_export}
            check(c_export == want_e and c_load == want_l,
                  f"{arch} {spec}: launches {c_export} {c_load}")
            check(all(encode_checks.values()),
                  f"{arch} {spec}: encode != plain encode {encode_checks}")
            check(same, f"{arch} {spec}: kernel decode != plain decode")
            check(n_bytes == declared == real,
                  f"{arch} {spec}: wire bytes {n_bytes} {declared} {real}")
            check(tk[0] == tk[1], f"{arch} {spec}: greedy tokens differ")
            del wire, zero
            os.remove(path + ".npz")
            os.remove(path + ".json")
        del params
    shutil.rmtree(root, ignore_errors=True)
    _fresh_memory()
    log("serve_checkpoint", **out)
    return by_path


def phase_serve_follow():
    """The port's training driver writes two --compress-state checkpoints
    of transformer-wmt x 4 nodes at full width; ``repro_torch.launch.serve
    --source follow`` serves 8 requests from them; the two checkpoints then
    land one after the other beside a running engine, which adopts both
    in order (the follower reads the params and leaves the comm copy's
    wire undecoded, as the reference does: 0 decode_avg launches); then
    ``--source live`` serves across more than one generation. The
    checkpoints are deleted after."""
    import shutil
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch import serve, train
    from repro_torch.serve import (CheckpointFollower, EngineConfig,
                                   Request, ServeEngine)
    from repro_torch.launch.serve import make_prompts, params_like
    run_dir = os.path.join(ROOT, "build", "chip_smoke_follow")
    landing = os.path.join(ROOT, "build", "chip_smoke_follow_landing")
    for d in (run_dir, landing):
        shutil.rmtree(d, ignore_errors=True)
    by_path, out = {}, {}
    _fresh_memory()
    reset_launch_counts()
    hist = train.main(["--arch", "transformer-wmt", "--nodes", "4",
                       "--steps", "4", "--quantize", "--compress-state",
                       "--ckpt", run_dir, "--ckpt-every", "2",
                       "--log-every", "1"])
    torch.cuda.synchronize()
    by_path["serve_follow_train"] = dict(LAUNCHES)
    # counted from before the build: the comm copy's first encode is in
    check(by_path["serve_follow_train"] == {"sgd_update": 8,
                                            "quantize_mod": 9,
                                            "decode_avg": 8},
          f"follow: training launches {by_path['serve_follow_train']}")
    check(sorted(os.listdir(run_dir)) == [
        "step_000002.json", "step_000002.npz", "step_000004.json",
        "step_000004.npz"], f"follow: checkpoints {os.listdir(run_dir)}")
    _fresh_memory()
    reset_launch_counts()
    argv = ["--arch", "transformer-wmt", "--source", "follow", "--follow",
            run_dir, "--nodes", "4", "--requests", "8", "--slots", "8",
            "--prompt-len", "64", "--gen", "16"]
    done, s_cli = serve.main(argv)
    by_path["serve_follow"] = dict(LAUNCHES)
    check(s_cli["completed"] == 8 and s_cli["dropped_in_flight"] == 0
          and s_cli["decode_cache_misses"] == 0
          and s_cli["swaps_adopted"] == 1
          and all(c.gen == 1 for c in done),
          f"follow CLI: {s_cli}")
    # the two checkpoints land one after the other beside the engine
    cfg = get_config("transformer-wmt")
    _fresh_memory()
    os.makedirs(landing)
    fol = CheckpointFollower(landing, params_like(cfg), 4, device="cuda")
    eng = ServeEngine(cfg, EngineConfig(max_slots=4, prompt_len=64,
                                        max_new_tokens=16, queue_depth=16),
                      source=fol, device="cuda")
    prompts = make_prompts(cfg, 8, 64, torch.Generator().manual_seed(0))
    reset_launch_counts()
    for wave, step in enumerate((2, 4)):
        for ext in (".npz", ".json"):          # the json marks it complete
            name = f"step_{step:06d}{ext}"
            shutil.move(os.path.join(run_dir, name),
                        os.path.join(landing, name))
        os.utime(os.path.join(landing, name))  # it lands now
        for i in range(4 * wave, 4 * wave + 4):
            eng.submit(Request(i, prompts[i]))
        eng.drain()
    by_path["serve_follow_landing"] = dict(LAUNCHES)
    s_land = eng.metrics.summary()
    tags = [os.path.basename(eng.swap.tag(g)) for g in (1, 2)]
    gens = {c.rid: c.gen for c in eng.completions}
    check(tags == ["step_000002", "step_000004"]
          and s_land["swaps_adopted"] == 2
          and all(gens[r] == 1 + r // 4 for r in range(8))
          and len(s_land["time_to_fresh_s"]) == 2
          and s_land["dropped_in_flight"] == 0
          and s_land["decode_cache_misses"] == 0,
          f"follow landing: tags {tags} gens {gens} {s_land}")
    del eng, fol
    shutil.rmtree(run_dir)
    shutil.rmtree(landing)
    _fresh_memory()
    reset_launch_counts()
    done, s_live = serve.main(["--arch", "transformer-wmt", "--source",
                               "live", "--nodes", "4", "--live-steps", "6",
                               "--requests", "8", "--slots", "4",
                               "--prompt-len", "64", "--gen", "16"])
    by_path["serve_live"] = dict(LAUNCHES)
    live_gens = sorted({c.gen for c in done})
    check(s_live["completed"] == 8 and len(live_gens) > 1
          and s_live["dropped_in_flight"] == 0,
          f"live: {s_live} generations {live_gens}")
    check(by_path["serve_live"] == {"sgd_update": 6, "quantize_mod": 0,
                                    "decode_avg": 0},
          f"live launches {by_path['serve_live']}")
    for k in ("serve_follow", "serve_follow_landing"):
        check(by_path[k] == {"sgd_update": 0, "quantize_mod": 0,
                             "decode_avg": 0}, f"{k}: {by_path[k]}")
    out = dict(train_records=hist, follow_cli=dict(argv=argv, **s_cli),
               landing=dict(tags=tags, **s_land),
               live=dict(generations=live_gens, **s_live),
               launches=by_path)
    _fresh_memory()
    log("serve_follow", **out)
    return by_path


ZOO_ARCHS = ("chatglm3-6b", "gemma3-4b", "gemma3-27b",
             "granite-moe-3b-a800m", "qwen3-moe-30b-a3b",
             "jamba-1.5-large-398b", "paligemma-3b", "musicgen-large")
ZOO_LAYERS = {"gemma3-4b": 8, "gemma3-27b": 8, "jamba-1.5-large-398b": 8}
ZOO_SEQ = 192          # > window 64 + its query chunk 64: the band path


def _route_choices(cfg, params, tokens, tp=None, drops=None):
    """Every MoE layer's expert choices [T, k] of one train forward, in
    layer order (route recorded on the way); `tp`: the forward of a
    GPU's slices on the model axis; `drops`, a list, gets each layer's
    count of choices dropped by capacity."""
    from repro_torch.models import forward, moe
    seen = []
    route, positions = moe.route, moe.dispatch_positions

    def recording(*a, **kw):
        out = route(*a, **kw)
        seen.append(out[1].cpu())
        return out

    def counting(*a, **kw):
        out = positions(*a, **kw)
        if drops is not None:
            drops.append(int((~out[1]).sum()))
        return out
    with _planted((moe, "route", recording),
                  (moe, "dispatch_positions", counting)):
        forward(cfg, params, tokens, tp=tp)
    return seen


def _loss_without_aux(cfg, params, hidden, aux, targets, tp=None):
    """The planted fault of zoo_reference: the router's aux loss dropped
    (in place of ``models/transformer.py`` ``train_loss``, which every
    training loss ends in)."""
    from repro_torch.models.layers import chunked_softmax_xent
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return chunked_softmax_xent(hidden[:, -targets.shape[1]:], table,
                                targets, softcap=cfg.logit_softcap)


def phase_zoo_reference():
    """Each of the eight newly ported archs at ``reduced`` (d_model 64;
    gemma3 and jamba at 8 layers, so that the 5:1 and 1:7 patterns hold a
    global attention layer), fp32, 4 nodes, sequences of 192 (the
    sliding-window layers' band path): one blocking q8 superstep on the
    card (kernels) against the CPU (plain versions) from the same state,
    weights, batches, matching and uniforms, held to `_within_bound` and
    the loss to 1e-4 relative, as `phase_reference` holds them, and the
    same superstep with exact gossip within 2e-5. A deeper stack's local
    steps differ more card vs CPU (jamba at 8 layers: 8.0e-6 with exact
    gossip), so more q8 codes sit within that noise of a rounding edge
    and flip (0.33% of them on the H100) than the share of 99.9% within
    2e-5 allows; where the exact superstep holds 2e-5, the q8 one passes
    with every coordinate within one lattice step of its row. It prints
    the codes that flip and the coordinates beyond 2e-5 that no flipped
    code of the node or its partner explains. Counts the
    MoE routing choices (expert index of every token and choice, every
    layer and node) that differ between card and CPU from the same
    weights: 0 at fp32 reduced. A planted fault — the router's aux loss
    dropped from the loss on the card — must fail the bound."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import bucket as B
    from repro_torch.core.graph import complete, sample_matching
    from repro_torch.core.swarm import SwarmState
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.data import make_node_batches
    from repro_torch.models import init_params
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_map
    n, H, S = 4, 2, ZOO_SEQ
    out = {}
    for arch in ZOO_ARCHS:
        cfg = reduced(get_config(arch), n_layers=ZOO_LAYERS.get(arch, 2),
                      d_model=64)
        g = torch.Generator().manual_seed(0)
        params = tree_map(lambda x: x[None].repeat((n,) + (1,) * x.ndim),
                          init_params(g, cfg, "cpu"))
        rng = np.random.default_rng(0)
        perm = sample_matching(complete(n), rng)
        ds = SyntheticLMDataset(DataConfig(cfg.vocab_size, S, seed=0), n)
        nb = make_node_batches(ds, 0, 2 * H)
        batches = {H: {k: v.reshape(1, n, H, 2, S) for k, v in nb.items()}}
        us = rng.random((1, n, B.build_layout(params).n_padded),
                        dtype=np.float32)
        inputs = (perm[None], batches, us, {"fixed": np.full((1, n), H,
                                                             np.int32)})
        run, cpu_codec, opt, _ = _reduced_engine("cpu", True, cfg=cfg)
        state = SwarmState(params, opt.init(params),
                           tree_map(torch.clone, params), 0)
        want, m_cpu = run(state, 0, inputs)

        def card(fault=None):
            run, codec, _, _ = _reduced_engine("cuda", True, cfg=cfg)
            if fault is None:
                got, m = run(state, 0, inputs)
            else:
                with _planted((tf, "train_loss", fault)):
                    got, m = run(state, 0, inputs)
            r = _readings(got.params, want.params, codec.scales[-1], perm)
            r["loss_card"], r["loss_cpu"] = float(m["loss"]), \
                float(m_cpu["loss"])
            r["loss_rel"] = abs(r["loss_card"] - r["loss_cpu"]) / \
                abs(r["loss_cpu"])
            # a coordinate whose own or partner's q8 code differs card vs
            # CPU moves by half a lattice step; any other must agree
            flips = (codec.codes[-1] != cpu_codec.codes[-1]).reshape(n, -1)
            r["code_flips"] = int(flips.sum())
            d = (B.pack(B.build_layout(got.params), got.params).cpu() -
                 B.pack(B.build_layout(want.params), want.params)).abs()
            explained = flips | flips[torch.as_tensor(perm,
                                                      dtype=torch.long)]
            r["unexplained_beyond_2e-5"] = int(
                ((d.reshape(n, -1) > 2e-5) & ~explained).sum())
            r["within"] = r["loss_rel"] <= 1e-4 and (
                _within_bound(r) or r["beyond_one_step"] == 0)
            return r
        # exact gossip from the same state: the local steps alone
        run_x, _, _, _ = _reduced_engine("cpu", False, cfg=cfg)
        sx = SwarmState(params, opt.init(params), None, 0)
        want_x, _ = run_x(sx, 0, inputs)
        run_x, _, _, _ = _reduced_engine("cuda", False, cfg=cfg)
        got_x, _ = run_x(sx, 0, inputs)
        exact = _readings(got_x.params, want_x.params, None, perm)
        check(_within_bound(exact),
              f"{arch}: exact superstep card vs CPU beyond 2e-5: {exact}")
        rec = card()
        rec["exact"] = exact
        # routing from the same weights on both devices, every node
        flips = total = 0
        if cfg.moe is not None:
            for i in range(n):
                p_i = tree_map(lambda x: x[i], params)
                toks = torch.from_numpy(nb["tokens"][i, :2].astype(np.int64))
                a = _route_choices(cfg, p_i, toks)
                b = _route_choices(cfg, tree_map(lambda x: x.cuda(), p_i),
                                   toks.cuda())
                flips += sum(int((x != y).sum()) for x, y in zip(a, b))
                total += sum(x.numel() for x in a)
            rec["planted"] = {"aux_dropped": card(_loss_without_aux)}
        rec["routing_choices"], rec["routing_flips"] = total, flips
        out[arch] = rec
        check(math.isfinite(rec["loss_card"]), f"{arch}: non-finite loss")
        check(rec["within"], f"{arch}: card vs CPU beyond the bound: {rec}")
        check(flips == 0, f"{arch}: {flips} of {total} routing choices "
              "differ between card and CPU")
        for name, r in rec.get("planted", {}).items():
            check(not r["within"],
                  f"{arch}: planted fault {name} passes the bound: {r}")
    log("zoo_reference", seq=S, nodes=n, **out)


ZOO_TRAIN_ARCH = "granite-moe-3b-a800m"
ZOO_TRAIN_LAYERS = 4       # full width; depth cut from 32 to fit 4 nodes


def phase_zoo_train_full_width():
    """granite-moe-3b-a800m at its full width (d_model 1536, 24 / 8
    heads, 40 experts top-8 of d_ff 512, vocab 49,155, bf16 params, fp32
    momentum), depth cut to 4 layers, 4 nodes: ``repro_torch.launch.train
    --arch granite-moe-3b-a800m --nodes 4 --H 2 --quantize --steps 4``
    through `launch/train.py`'s build / run, launch counters at 0 just
    before. Asserts finite losses and router aux, and 8 / 4 / 4 launches
    of sgd_update / quantize_mod / decode_avg; prints superstep times and
    peak allocated and reserved memory."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch import train
    from repro_torch.models import forward
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(get_config(ZOO_TRAIN_ARCH),
                              n_layers=ZOO_TRAIN_LAYERS)
    argv = ["--arch", ZOO_TRAIN_ARCH, "--nodes", "4", "--H", "2",
            "--steps", "4", "--quantize", "--log-every", "1"]
    _fresh_memory()
    args = train.build_parser().parse_args(argv)
    tr = train.build(args, cfg)
    torch.cuda.synchronize()
    reset_launch_counts()
    hist = train.run(args, tr)
    torch.cuda.synchronize()
    counts = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    # the router's aux of node 0's model on its last batch
    p0 = tree_map(lambda x: x[0], tr.state.params)
    toks = torch.from_numpy(tr.node_batches(3)["tokens"][0, :args.batch])
    with torch.no_grad():
        _, _, aux = forward(cfg, p0, toks.to(torch.int64).to("cuda"))
    aux = float(aux)
    walls = [h["wall_s"] for h in hist]
    steady = [b - a for a, b in zip(walls, walls[1:])]
    rec = dict(argv=argv, n_layers=ZOO_TRAIN_LAYERS,
               params_per_node=cfg.n_params(),
               active_params_per_node=cfg.n_active_params(), records=hist,
               router_aux=aux, launches=counts, first_superstep_s=walls[0],
               superstep_s=steady,
               superstep_median_s=statistics.median(steady),
               max_memory_allocated_bytes=peak,
               max_memory_reserved_bytes=reserved)
    log("zoo_train_full_width", **rec)
    check(len(hist) == 4 and all(math.isfinite(h["loss"])
                                 and math.isfinite(h["gamma"])
                                 for h in hist) and math.isfinite(aux)
          and aux > 0, f"zoo train: non-finite records or aux {hist} {aux}")
    check(counts == {"sgd_update": 8, "quantize_mod": 4, "decode_avg": 4},
          f"zoo train launch counts {counts}")
    del tr, p0
    _fresh_memory()
    return {"zoo_train_granite_q8": counts}


ZOO_SERVE = {
    # arch: (requests, prompt, new tokens, slots, chunk, runs); the swap
    # run takes half a wave of requests more, admitted after the swap
    # (granite's requests cut from 16 to one wave of 8 to keep the script
    # near 480 s: its eager decode step takes ~155 ms)
    "granite-moe-3b-a800m": (8, 512, 64, 8, 128,
                             ("dense_blocking", "dense_chunked",
                              "paged_chunked", "dense_swap")),
    "gemma3-4b": (8, 3072, 32, 4, 512,
                  ("dense_blocking", "dense_chunked", "paged_chunked")),
}


def phase_zoo_serve_full_width():
    """Serving at full width and depth in bf16 through the engine:
    granite-moe-3b-a800m (8 requests of 512 + 64 tokens on 8 slots; 12
    with the hot swap, 4 of them admitted after it) and
    gemma3-4b (8 requests of 3072 + 32 on 4 slots: the rings of 1024
    rows wrap, and a prefill of 3072 > window 1024 + query chunk 1024
    takes the band path), each dense blocking, dense chunked (128; 512 <=
    the window) and paged (page 16) + chunked, granite also blocking with
    a hot swap after 8 decode steps. Asserts paged == dense and swap == no
    swap bitwise, nothing dropped, no added shape signature, and finite
    logits of the one-shot command (``repro_torch.launch.serve``, the
    first requests' shape) for each; prints tokens/s, decode ms a token,
    TTFT p50/p99, KV bytes, one profiled decode step (8 lanes over 512
    cached rows) and the greedy agreement between chunked and blocking
    (exact only where no expert overflows). paligemma-3b runs the
    one-shot path with its 256-row prefix (8 x 512 + 64) and the engine
    must refuse it; launches 0/0/0."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch import serve
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models import init_params
    from repro_torch.serve import EngineConfig, ServeEngine
    out, by_path = {}, {}
    reset_launch_counts()
    for arch, (n_req, plen, new, slots, chunk, names) in ZOO_SERVE.items():
        cfg = get_config(arch)
        _fresh_memory()
        argv = ["--arch", arch, "--batch", str(slots), "--prompt-len",
                str(plen), "--gen", str(new)]
        one = serve.main(argv)
        one_peak = torch.cuda.max_memory_allocated()
        check(one["finite"] and one["tokens"].shape == (slots, new),
              f"{arch}: one-shot logits not finite or tokens missing")
        gen = torch.Generator(device="cuda").manual_seed(0)
        pA = init_params(gen, cfg, "cuda")
        pB = init_params(gen, cfg, "cuda") if "dense_swap" in names \
            else None
        step_profile = _profile_decode_step(cfg, pA)
        prompts = make_prompts(cfg, n_req + slots // 2, plen,
                               torch.Generator().manual_seed(1))
        kws = {"dense_blocking": {},
               "dense_chunked": dict(prefill_chunk=chunk),
               "paged_chunked": dict(paged=True, page_size=16,
                                     prefill_chunk=chunk),
               "dense_swap": dict(swap=(pB, 8))}
        runs = {}
        for name in names:
            n = n_req + slots // 2 if name == "dense_swap" else n_req
            done, s, peak, wall = _serve_engine_run(
                cfg, pA, prompts[:n], slots=slots, new_tokens=new,
                **kws[name])
            runs[name] = dict(tokens={c.rid: (c.tokens.tolist(), c.gen)
                                      for c in done},
                              summary=s, peak=peak, wall_s=wall)
        toks = {k: v["tokens"] for k, v in runs.items()}
        for name, r in runs.items():
            s = r["summary"]
            check(s["completed"] == len(r["tokens"]) >= n_req
                  and s["dropped_in_flight"] == 0
                  and s["decode_cache_misses"] == 0
                  and s["prefill_cache_misses"] == 0,
                  f"{arch} {name}: {s}")
        check(toks["paged_chunked"] == toks["dense_chunked"],
              f"{arch}: paged != dense under chunked prefill")
        before = []
        if "dense_swap" in toks:
            swapped = toks["dense_swap"]
            before = [r for r in sorted(swapped) if swapped[r][1] == 1]
            check(before and all(r < n_req and swapped[r] == toks[
                "dense_blocking"][r] for r in before)
                  and len(before) < len(swapped)
                  and all(swapped[r][1] == 2
                          for r in swapped if r not in before),
                  f"{arch}: hot swap: lanes before it differ or later "
                  "lanes not on generation 2")
        agree = np.mean([a == b for r in range(n_req) for a, b in
                         zip(toks["dense_chunked"][r][0],
                             toks["dense_blocking"][r][0])])
        out[arch] = dict(
            oneshot=dict(argv=argv, prefill_ms=one["prefill_ms"],
                         decode_ms_per_token=one["decode_ms_per_token"],
                         tokens_per_s=slots * 1e3 /
                         one["decode_ms_per_token"],
                         max_memory_allocated_bytes=one_peak),
            n_params=cfg.n_params(), decode_step_profile=step_profile,
            engine={k: dict(wall_s=v["wall_s"],
                            max_memory_allocated_bytes=v["peak"],
                            **{m: v["summary"][m] for m in (
                                "tokens", "tokens_per_s", "latency_p50_ms",
                                "latency_p99_ms", "ttft_p50_ms",
                                "ttft_p99_ms", "kv_bytes", "kv_dense_bytes",
                                "kv_pool_pages", "pool_pages_peak",
                                "swaps_adopted", "decode_cache_misses",
                                "prefill_cache_misses")})
                    for k, v in runs.items()},
            swap_lanes_before=before,
            chunked_vs_blocking_token_agreement=float(agree))
        del pA, pB
    # the frontend arch: one-shot with its prefix; the engine refuses it
    cfg = get_config("paligemma-3b")
    _fresh_memory()
    argv = ["--arch", "paligemma-3b", "--batch", "8", "--prompt-len",
            "512", "--gen", "64"]
    one = serve.main(argv)
    check(one["finite"] and one["tokens"].shape == (8, 64),
          "paligemma-3b: one-shot logits not finite or tokens missing")
    try:
        ServeEngine(cfg, EngineConfig(), device="cuda")
        refused = None
    except ValueError as e:
        refused = str(e)
    check(refused is not None and "one-shot path" in refused,
          f"paligemma-3b: the engine did not refuse it ({refused})")
    out["paligemma-3b"] = dict(
        oneshot=dict(argv=argv, n_prefix=cfg.frontend.n_prefix,
                     prefill_ms=one["prefill_ms"],
                     decode_ms_per_token=one["decode_ms_per_token"],
                     max_memory_allocated_bytes=torch.cuda
                     .max_memory_allocated()),
        n_params=cfg.n_params(), engine_refusal=refused)
    counts = dict(LAUNCHES)
    check(counts == {"sgd_update": 0, "quantize_mod": 0, "decode_avg": 0},
          f"zoo serving launches {counts}")
    by_path["zoo_serve"] = counts
    _fresh_memory()
    log("zoo_serve_full_width", **out)
    return by_path


# ---------------------------------------------------------------------------
# The node mesh: one node a GPU, NCCL between them (phases 28 and 29)
# ---------------------------------------------------------------------------

MS_DIR = os.path.join(ROOT, "build", "chip_smoke_multi_shard")
MS_STEPS = 4
MS_ENGINES = (("exact", "blocking"), ("q8", "blocking"),
              ("q8", "nonblocking"), ("q8", "overlap"))
# the full-width commands: name -> (algorithm, gossip impl, codec (None:
# exact), mode)
MS_COMMANDS = {
    "multi_shard_ppermute_q8": ("swarm", "ppermute", "q8", "blocking"),
    "multi_shard_pool_overlap_q8": ("swarm", "ppermute_pool", "q8",
                                    "overlap"),
    "multi_shard_ppermute_legacy_exact": ("swarm", "ppermute_legacy", None,
                                          "blocking"),
    "multi_shard_gather_q8": ("swarm", "gather", "q8", "blocking"),
    "multi_shard_gather_topk_nonblocking": ("swarm", "gather", "topk:0.25",
                                            "nonblocking"),
    "multi_shard_gather_compress_q8": ("swarm", "gather", "q8", "compress"),
    "multi_shard_allreduce": ("allreduce", "gather", None, "blocking"),
    "multi_shard_localsgd": ("localsgd", "gather", None, "blocking"),
    "multi_shard_dpsgd": ("dpsgd", "gather", None, "blocking"),
    "multi_shard_adpsgd_q8": ("adpsgd", "gather", "q8", "blocking"),
    "multi_shard_sgp": ("sgp", "gather", None, "blocking"),
    # --scan-chunk 4 on the mesh (MS_SCAN_STEPS supersteps, two chunks),
    # run by `_ms_scan_full_width` against the same command per step
    "multi_shard_gather_q8_scan": ("swarm", "gather", "q8", "blocking"),
    "multi_shard_pool_overlap_q8_scan": ("swarm", "ppermute_pool", "q8",
                                         "overlap"),
}
MS_SCAN_STEPS, MS_CHUNK = 8, 4
# the chunked commands' h: fixed H 2, or geometric (mean 2, h_max 8) as
# the one-card `scan_full_width` overlapped command
MS_SCAN_H_MODE = {"multi_shard_gather_q8_scan": "fixed",
                  "multi_shard_pool_overlap_q8_scan": "geometric"}
# each command's launches of sgd_update / quantize_mod / decode_avg on
# every rank over MS_STEPS supersteps: one sweep a local step (H 2 for the
# swarm and Local SGD, 1 for the others), one encode and one decode an
# exchange; compress_state also re-encodes and decodes its comm copy
MS_WANT = {name: dict(zip(("sgd_update", "quantize_mod", "decode_avg"), n))
           for name, n in (
               ("multi_shard_ppermute_q8", (8, 4, 4)),
               ("multi_shard_pool_overlap_q8", (8, 4, 4)),
               ("multi_shard_ppermute_legacy_exact", (8, 0, 0)),
               ("multi_shard_gather_q8", (8, 4, 4)),
               ("multi_shard_gather_topk_nonblocking", (8, 0, 0)),
               ("multi_shard_gather_compress_q8", (8, 8, 8)),
               ("multi_shard_allreduce", (4, 0, 0)),
               ("multi_shard_localsgd", (8, 0, 0)),
               ("multi_shard_dpsgd", (4, 0, 0)),
               ("multi_shard_adpsgd_q8", (4, 4, 4)),
               ("multi_shard_sgp", (4, 0, 0)),
               # over MS_SCAN_STEPS supersteps; under geometric h a rank
               # sweeps its own h a superstep (None: Σ_t h_t,rank)
               ("multi_shard_gather_q8_scan", (16, 8, 8)),
               ("multi_shard_pool_overlap_q8_scan", (None, 8, 8)))}


def _ms_want(name: str, hs, rank: int) -> dict:
    """MS_WANT[name] on `rank`, its sweeps from its h where it has none."""
    want = dict(MS_WANT[name])
    if want["sgd_update"] is None:
        want["sgd_update"] = int(sum(int(h[rank]) for h in hs))
    return want


def _ms_world(n_gpus: int) -> int:
    """Ranks of the mesh: 4 with 4 or more GPUs, else 2 (one node a GPU;
    an even count, so the static matching pairs every node)."""
    return 4 if n_gpus >= 4 else 2


def _ms_perm(world: int):
    """The reference cases' static matching: i <-> i + world / 2."""
    import numpy as np
    return (np.arange(world) + world // 2) % world


def _ms_pool(world: int):
    """A pool of three: the identity, adjacent pairs, and one pair (0,
    world / 2) with every other node unmatched."""
    import numpy as np
    part = np.arange(world)
    part[0], part[world // 2] = world // 2, 0
    return [np.arange(world), np.arange(world) ^ 1, part]


def _ms_quants() -> dict:
    """The reference cases' wires by name (None: exact fp32)."""
    from repro_torch.quant.codecs import make_codec
    from repro_torch.quant.schemes import ModularQuantConfig
    return {"exact": None, "q4": ModularQuantConfig(bits=4),
            "q8": ModularQuantConfig(), "q16": ModularQuantConfig(bits=16),
            "bf16": make_codec("bf16")}


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _ms_spawn(fn, world: int, *args) -> None:
    """Run fn(rank, world, port, *args) in `world` spawned processes, one
    a GPU, rendezvous on a free localhost port; a rank's exception fails
    the phase and the other ranks are stopped."""
    import torch.multiprocessing as mp
    mp.spawn(fn, args=(world, _free_port()) + args, nprocs=world,
             join=True)


def _ms_mesh(rank: int, world: int, port: int, device: str,
             model_parallel: int = 1, timeout=None):
    """A rank's setup: the mesh (NCCL on cuda; `model_parallel` GPUs a
    node; `timeout` bounds its collectives' waits), the card's fp32
    matmuls without TF32, as in `main`; NCCL's registration of captured
    buffers off before the group starts, as the mesh's chunk driver asks
    (``core/scan.py``)."""
    import torch
    os.environ["NCCL_GRAPH_REGISTER"] = "0"
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.launch.mesh import init_node_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return init_node_mesh(device, rank=rank, world_size=world,
                          init_method=f"tcp://localhost:{port}",
                          model_parallel=model_parallel, timeout=timeout)


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class _Events:
    """Elapsed ms between marks on the current stream: CUDA events on
    the card (read after a sync), the host clock elsewhere."""

    def __init__(self, dev):
        self.dev, self.marks = dev, []

    def mark(self):
        import torch
        if self.dev.type == "cuda":
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def spans_ms(self) -> list:
        """Pairs of marks (0-1, 2-3, ...) as ms; clears them."""
        _sync(self.dev)
        m, self.marks = self.marks, []
        if self.dev.type == "cuda":
            return [a.elapsed_time(b) for a, b in zip(m[::2], m[1::2])]
        return [(b - a) * 1e3 for a, b in zip(m[::2], m[1::2])]


def _ms_reference_inputs(world: int, cfg) -> dict:
    """The CPU's side of `multi_shard_reference`: one shard, every node in
    this process, plain kernel versions — the flat exchanges, the payload
    permutes and the per-leaf oracles of the reduced cases, and 3
    supersteps of each engine case (reduced transformer-wmt, the
    ppermute transport), with the states before each superstep, the
    uniforms, the batches and the encode's scales."""
    import numpy as np
    import torch
    from repro_torch.core import bucket as B
    from repro_torch.core import exchange as E
    from repro_torch.core.swarm import SwarmConfig, make_swarm_step
    from repro_torch.core.swarm import swarm_init
    from repro_torch.models import TransformerLM, init_params
    from repro_torch.optim import make_optimizer
    from repro_torch.quant.codecs import LatticeCodec
    from repro_torch.quant.schemes import ModularQuantConfig
    from repro_torch.tree import tree_map

    rng = np.random.default_rng(5)
    n_pad = 8192

    def arr(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    buf = arr(world, n_pad)
    prev = buf + 0.01 * arr(world, n_pad)
    u = torch.from_numpy(rng.random((world, n_pad)).astype(np.float32))
    mask = torch.ones(world, dtype=torch.bool)
    mask[world // 2] = False
    pairs = B.pairs_from_perm(_ms_perm(world))
    pool = _ms_pool(world)
    quants = _ms_quants()
    out = {"buf": buf, "prev": prev, "u": u, "mask": mask, "flat": {},
           "scales": {}}
    for name, q in quants.items():
        if name not in ("exact", "bf16"):
            out["scales"][name] = B.as_codec(q).encode(
                buf, prev, None, u=u)[1].reshape(world, -1)
        for masked in (False, True):
            kw = dict(quant=q, prev_buf=prev, u=u,
                      mask=mask if masked else None)
            out["flat"][(name, masked, "static")] = B.gossip_flat_ppermute(
                buf, pairs, **kw)
            out["flat"][(name, masked, "pool")] = \
                B.gossip_flat_ppermute_pool(buf, pool, 2, **kw)
    payload = (buf, torch.from_numpy(
        rng.integers(0, 256, size=(world * 8, 256)).astype(np.uint8)))
    out["payload"] = payload
    out["permuted"] = {
        "static": B.permute_payload_ppermute(payload, pairs, world),
        "pool": B.permute_payload_pool(payload, pool, 2, world)}
    tree = {"a": arr(world, 6, 16), "b": arr(world, 300),
            "c": arr(world, 3, 5).to(torch.bfloat16)}
    tprev = tree_map(lambda x: (x.float() + 0.01).to(x.dtype), tree)
    u_leaf = [torch.from_numpy(rng.random(
        (1, -(-x[0].numel() // 256), 256)).astype(np.float32))
        for x in (tree["a"], tree["b"], tree["c"])]
    out.update(tree=tree, tprev=tprev, u_leaf=u_leaf, leaf={})
    for name, q in (("exact", None), ("q8", ModularQuantConfig())):
        out["leaf"][name] = E.gossip_ppermute(
            tree, pairs, q, tprev, None,
            u=[x.repeat(world, 1, 1) for x in u_leaf])
    # the engine cases: each superstep's state, and where it went
    model = TransformerLM(cfg)
    h, batch, seq = 2, 2, 16
    out["engines"] = {}
    for codec, mode in MS_ENGINES:
        q8 = codec == "q8"
        scfg = SwarmConfig(n_nodes=world, H=h, quantize=q8,
                           nonblocking=mode != "blocking",
                           overlap=mode == "overlap", gossip_impl="ppermute")
        opt = make_optimizer("sgd", lr=0.05, momentum=0.9)
        step = make_swarm_step(scfg, model.functional_loss, opt.update,
                               lambda s: 0.05, transport=E.GossipTransport(
                                   world, impl="ppermute",
                                   static_pairs=pairs))
        gen = torch.Generator().manual_seed(0)
        state = swarm_init(gen, scfg, lambda g: init_params(g, cfg, "cpu"),
                           opt.init)
        if not q8:    # distinct nodes, so the exact exchange moves them
            state.params = tree_map(
                lambda x: x + 0.01 * torch.randn(x.shape, generator=gen),
                state.params)
        n_pad_m = B.build_layout(state.params).n_padded
        traj = []
        for t in range(3):
            tok = torch.randint(0, cfg.vocab_size, (world, h, batch, seq + 1),
                                generator=gen)
            b = {"tokens": tok[..., :-1], "targets": tok[..., 1:]}
            ut = torch.rand((world, n_pad_m), generator=gen)
            scales = []
            orig = LatticeCodec.encode

            def enc(codec_, *a, **kw):
                q_, s_ = orig(codec_, *a, **kw)
                scales.append(s_.reshape(world, -1))
                return q_, s_
            LatticeCodec.encode = enc
            try:
                nxt, m = step(state, b, _ms_perm(world),
                              np.full(world, h), None, u=ut)
            finally:
                LatticeCodec.encode = orig
            if mode == "overlap":
                s = state.inflight["wire"][1].reshape(world, -1)
            else:
                s = scales[0] if scales else None
            traj.append({"state": state, "batch": b, "u": ut, "scales": s,
                         "after": nxt.params, "loss": float(m["loss"]),
                         "gamma": float(m["gamma"])})
            state = nxt
        out["engines"][(codec, mode)] = traj
    out["gather"] = dict(_ms_gather_reference_inputs(world, cfg, out),
                         cfg=cfg)
    return out


def _ms_rows(x, r: int, n: int = 1):
    """Rank r's rows of a node-stacked tree / tuple / tensor, to its
    device later."""
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(_ms_rows(v, r, n) for v in x)
    if isinstance(x, dict):
        return {k: _ms_rows(v, r, n) for k, v in x.items()}
    return x[r * n:(r + 1) * n]


def _ms_to(x, dev):
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(_ms_to(v, dev) for v in x)
    if isinstance(x, dict):
        return {k: _ms_to(v, dev) for k, v in x.items()}
    return x.to(dev)


class _MsRun:
    """One run of a mesh command on this rank: its step, state (the rank's
    node), the run's generator, the presampled (perm, h) rows (or the
    given `perms`) and its node's batches of the synthetic data, as
    `_ms_full_width_rank` builds them; per-step and chunked drivers."""

    def __init__(self, cfg, mesh, algo, impl, codec_spec, mode, *,
                 h_mode="fixed", perms=None, steps=MS_SCAN_STEPS, seed=0,
                 batch=4, seq=128, h=2):
        import numpy as np
        import torch
        from repro_torch.algorithms import make_algorithm
        from repro_torch.algorithms.sgp import sgp_init_state
        from repro_torch.core import bucket as B
        from repro_torch.core import exchange as E
        from repro_torch.core.graph import make_graph
        from repro_torch.core.swarm import SwarmConfig, swarm_init
        from repro_torch.data import DataConfig, SyntheticLMDataset
        from repro_torch.launch.train import presample_inputs
        from repro_torch.models import TransformerLM, init_params
        from repro_torch.optim import make_optimizer
        world, dev = mesh.size, mesh.device
        self.mesh, self.dev, self.batch_size, self.seq = mesh, dev, batch, seq
        self.scfg = scfg = SwarmConfig(
            n_nodes=world, H=h if algo in ("swarm", "localsgd") else 1,
            h_mode=h_mode, quantize=codec_spec is not None,
            codec=None if codec_spec in (None, "q8") else codec_spec,
            nonblocking=mode in ("nonblocking", "overlap"),
            overlap=mode == "overlap", compress_state=mode == "compress",
            gossip_impl=impl, pool_size=8)
        graph = make_graph("complete", world)
        kw = {}
        if impl.startswith("ppermute_pool"):
            kw["matching_pool"] = E.make_matching_pool(graph, 8, seed)
        elif impl.startswith("ppermute"):
            kw["static_pairs"] = B.pairs_from_perm(
                E.static_ppermute_matching(graph, seed))
        self.tr = E.GossipTransport(world, impl=impl, quant=scfg.quant,
                                    codec=scfg.make_codec(), mesh=mesh, **kw)
        self.model = TransformerLM(cfg)
        self.opt = make_optimizer("sgd", lr=0.05, momentum=0.9,
                                  state_dtype=cfg.opt_state_dtype)
        akw = dict(loss_fn=self.model.functional_loss,
                   opt_update=self.opt.update, lr_fn=lambda s: 0.05,
                   n_nodes=world, transport=self.tr, mesh=mesh)
        if algo == "swarm":
            akw["scfg"] = scfg
        if algo == "localsgd":
            akw["H"] = h
        if algo == "dpsgd":
            akw["graph"] = make_graph("ring", world)
        if algo in ("adpsgd", "sgp"):
            akw["quantize"] = scfg.quantize
        self.step = make_algorithm(algo, **akw)
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(seed)
        self.state = swarm_init(self.gen, scfg,
                                lambda g: init_params(g, cfg, dev),
                                self.opt.init, mesh=mesh)
        if algo == "sgp":
            self.state = sgp_init_state(self.state, world, scfg.quantize,
                                        mesh=mesh)
        self.ds = SyntheticLMDataset(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=seq, seed=seed),
            n_nodes=world)
        self.perms, self.hs = presample_inputs(
            scfg, graph, np.random.default_rng(seed), steps, seed=seed)
        if perms is not None:
            self.perms = np.asarray(perms)
        self.chunker = None

    def batch(self, t) -> dict:
        import torch
        from repro_torch.data import make_node_batches
        hb = self.scfg.h_loop_bound
        nb = make_node_batches(self.ds, t, self.batch_size * hb)
        r = self.mesh.rank
        return {k: torch.from_numpy(v[r:r + 1].reshape(
            1, hb, self.batch_size, self.seq)).to(self.dev)
            for k, v in nb.items()}

    def _barrier(self) -> None:
        import torch
        import torch.distributed as dist
        dist.all_reduce(torch.zeros((1,), device=self.dev))
        _sync(self.dev)

    def per_step(self, t0, t1) -> tuple:
        """Supersteps t0..t1-1 -> (metrics, seconds a superstep: the
        ranks in step before each, synchronised after)."""
        ms, secs = [], []
        for t in range(t0, t1):
            _ms_progress(self.mesh, f"superstep {t}")
            b = self.batch(t)
            self._barrier()
            t_start = time.perf_counter()
            self.state, m = self.step(self.state, b, self.perms[t],
                                      self.hs[t], self.gen)
            m = {k: float(v) for k, v in m.items()}
            _sync(self.dev)
            secs.append(time.perf_counter() - t_start)
            ms.append(m)
        return ms, secs

    def chunked(self, t0, t1) -> tuple:
        """Chunks of MS_CHUNK from t0 to t1 -> (metrics, seconds a chunk:
        the ranks in step before each, its metrics read after)."""
        import torch
        from repro_torch.core.scan import make_superstep_scan
        if self.chunker is None:
            self.chunker = make_superstep_scan(self.step)
        ms, secs = [], []
        for t in range(t0, t1, MS_CHUNK):
            _ms_progress(self.mesh, f"chunk at {t}")
            k = min(MS_CHUNK, t1 - t)
            bs = [self.batch(s) for s in range(t, t + k)]
            batch = {n: torch.stack([b[n] for b in bs]) for n in bs[0]}
            self._barrier()
            t_start = time.perf_counter()
            self.state, m = self.chunker(self.state, self.gen, batch,
                                         self.perms[t:t + k],
                                         self.hs[t:t + k])
            m = {n: v.tolist() for n, v in m.items()}
            secs.append(time.perf_counter() - t_start)
            ms.extend({n: v[i] for n, v in m.items()} for i in range(k))
        return ms, secs

    def close(self) -> None:
        """Release the chunk driver's graphs and pool (every rank calls
        it, as `SuperstepChunk.close` asks)."""
        if self.chunker is not None:
            self.chunker.close()
            self.chunker = None

    def leaves(self) -> list:
        """The state's tensors (params, momentum, comm copy, residual, the
        in-flight payload), cloned."""
        from repro_torch.core.scan import _state_leaves
        return [x.clone() for x in _state_leaves(self.state)]

    def ckpt_tree(self) -> dict:
        """What a resume needs: the codec tree (an overlapped state
        drained), the momentum and the run's generator state (on the
        device, a row a rank)."""
        from repro_torch.core.swarm import (codec_checkpoint_tree,
                                            pipeline_epilogue)
        st = pipeline_epilogue(self.scfg, self.state) \
            if self.scfg.overlap else self.state
        return {"codec": codec_checkpoint_tree(st), "opt": st.opt,
                "rng": self.gen.get_state()[None].to(self.dev)}

    def restore(self, tree, t) -> None:
        from repro_torch.core.swarm import SwarmState, restore_codec_state
        st = restore_codec_state(self.state, tree["codec"])
        self.state = SwarmState(st.params, tree["opt"], st.prev, t,
                                st.inflight, st.residual)
        self.gen.set_state(tree["rng"][0].cpu())


_MS_STACKS: dict = {}


def _ms_progress(mesh, what: str) -> None:
    """A line in this rank's progress file under OUT_DIR; if no line
    follows within 150 s the rank writes its thread stacks beside it (a
    stalled run shows where it stood) and exits, which fails the phase
    and stops the other ranks."""
    import faulthandler
    r = mesh.world_rank
    with open(os.path.join(OUT_DIR, f"ms_progress_rank{r}.txt"),
              "a") as f:
        f.write(f"{time.time():.3f} {what}\n")
    stacks = _MS_STACKS.get(r)
    if stacks is None:
        stacks = _MS_STACKS[r] = open(os.path.join(
            OUT_DIR, f"ms_stacks_rank{r}.txt"), "w")
    faulthandler.dump_traceback_later(150, exit=True, file=stacks)


def _ms_same(a, b) -> bool:
    """Two lists of tensors (or trees' leaves) equal bit for bit."""
    return len(a) == len(b) and all(same_bits(x, y) for x, y in zip(a, b))


def _ms_cycle_perms(world: int, steps: int):
    """Matchings whose partners change every superstep: i <-> i ^ c for c
    cycling over 1 .. world-1 (world a power of 2)."""
    import numpy as np
    return np.stack([np.arange(world) ^ (1 + t % (world - 1))
                     for t in range(steps)])


# the long run's other chunked cases at reduced size: name -> (algorithm,
# impl, codec, mode, h mode); with the gather q8 run they capture every
# kind of NCCL work a mesh step posts (P2P by the pool entry and by SGP's
# shift, per leaf, all-gathers, all-reduces)
MS_LONG_RUN_CASES = {
    "pool_overlap_q8_geometric": ("swarm", "ppermute_pool", "q8", "overlap",
                                  "geometric"),
    "compress_q8": ("swarm", "gather", "q8", "compress", "fixed"),
    "ppermute_legacy_exact": ("swarm", "ppermute_legacy", None, "blocking",
                              "fixed"),
    "allreduce": ("allreduce", "gather", None, "blocking", "fixed"),
    "dpsgd": ("dpsgd", "gather", None, "blocking", "fixed"),
    "sgp_q8": ("sgp", "gather", "q8", "blocking", "fixed"),
}


def _ms_long_run_rank(mesh, cfg, inp, out_dir) -> dict:
    """The long run's reduced cases on this rank (`multi_shard_reference`):
    μ of the CPU's node-stacked tree from the rank's rows, rank 0's
    one-card μ of the whole tree on its card, the mesh save beside rank
    0's one-card save and a planted save of the rank's row only, the load;
    then the reduced transformer-wmt gather q8 blocking run under
    deterministic algorithms, per step and chunked (replay == eager), a
    chunked resume from a mesh checkpoint at the chunk boundary, a
    planted chunk whose graph keys lack the peers (partners change every
    superstep, h does not), and MS_LONG_RUN_CASES chunked against their
    per-step runs."""
    import warnings
    import torch
    from repro_torch.checkpoint import (load_checkpoint, mean_model_tree,
                                        save_checkpoint)
    from repro_torch.core.potential import mean_model
    from repro_torch.tree import tree_flatten
    dev, r, world = mesh.device, mesh.rank, mesh.size
    out = {}
    rows = _ms_to(_ms_rows(inp["tree"], r), dev)
    out["mu_tree"] = _ms_to(mean_model_tree(rows, mesh=mesh), "cpu")
    out["mu_leaf"] = _ms_to(mean_model(rows, mesh=mesh), "cpu")
    meta = {"nodes": world}
    if r == 0:
        full = _ms_to(inp["tree"], dev)
        out["mu_tree_one"] = _ms_to(mean_model_tree(full), "cpu")
        out["mu_leaf_one"] = _ms_to(mean_model(full), "cpu")
        save_checkpoint(os.path.join(out_dir, "long_one"), full, meta)
        # planted fault: a save that writes only the rank's row
        save_checkpoint(os.path.join(out_dir, "long_own_row"), rows, meta)
    path = os.path.join(out_dir, "long_mesh")
    save_checkpoint(path, rows, meta, mesh=mesh)
    got = load_checkpoint(path, rows, mesh=mesh)
    out["load_bitwise"] = _ms_same(tree_flatten(got)[0],
                                   tree_flatten(rows)[0])

    steps = MS_SCAN_STEPS
    perms = _ms_cycle_perms(world, steps)

    def run():
        return _MsRun(cfg, mesh, "swarm", "gather", "q8", "blocking",
                      perms=perms, steps=steps, seq=16)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            eager = run()
            ms_e, _ = eager.per_step(0, steps)
            want = eager.leaves()
            chk = run()
            ms_c, _ = chk.chunked(0, steps)
            out["chunk_bitwise"] = _ms_same(chk.leaves(), want) and \
                ms_c == ms_e
            out["graphs"] = [str(k) for k in chk.chunker.graphs]
            chk.close()
            first = run()
            first.chunked(0, MS_CHUNK)
            path = os.path.join(out_dir, "long_resume")
            save_checkpoint(path, first.ckpt_tree(), meta, mesh=mesh)
            # the resume's driver is built after the first one is closed
            first.close()
            second = run()
            second.restore(load_checkpoint(path, second.ckpt_tree(),
                                           mesh=mesh), MS_CHUNK)
            ms_r, _ = second.chunked(MS_CHUNK, steps)
            out["resume_bitwise"] = _ms_same(second.leaves(), want) and \
                ms_r == ms_e[MS_CHUNK:]
            second.close()
            if world >= 4:
                # planted fault: the graph key without the peers replays
                # superstep 0's partners
                fault = run()
                fault.step.peers_fn = None
                fault.chunked(0, steps)
                out["keyless_graphs"] = len(fault.chunker.graphs)
                out["keyless_differs"] = not _ms_same(fault.leaves(), want)
                fault.close()
            # every other kind of NCCL work a chunk captures: chunked ==
            # per step
            out["cases"] = {}
            for name, (algo, impl, codec, mode, h_mode) in \
                    MS_LONG_RUN_CASES.items():
                def case():
                    return _MsRun(cfg, mesh, algo, impl, codec, mode,
                                  h_mode=h_mode, steps=steps, seq=16)
                e = case()
                ms_e, _ = e.per_step(0, steps)
                c = case()
                ms_c, _ = c.chunked(0, steps)
                out["cases"][name] = {
                    "bitwise": _ms_same(c.leaves(), e.leaves()) and
                    ms_c == ms_e, "graphs": len(c.chunker.graphs)}
                c.close()
                del e, c
            del eager, chk, first, second
    finally:
        torch.use_deterministic_algorithms(False)
    _sync(dev)
    return out


def _ms_reference_rank(rank, world, port, path, device):
    """A rank of `multi_shard_reference`: every reduced case on its GPU
    from the CPU's inputs (engine supersteps restarted from the CPU's
    state), and the planted faults; saves its results beside `path`."""
    import numpy as np
    import torch
    mesh = _ms_mesh(rank, world, port, device)
    dev = mesh.device
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import bucket as B
    from repro_torch.core import exchange as E
    from repro_torch.core.swarm import SwarmConfig, SwarmState
    from repro_torch.core.swarm import make_swarm_step
    from repro_torch.models import TransformerLM
    from repro_torch.optim import make_optimizer
    from repro_torch.quant.schemes import ModularQuantConfig
    inp = torch.load(path, weights_only=False)
    pairs = B.pairs_from_perm(_ms_perm(world))
    pool = _ms_pool(world)
    quants = _ms_quants()
    buf, prev, u = (_ms_to(_ms_rows(inp[k], rank), dev)
                    for k in ("buf", "prev", "u"))
    mask = inp["mask"].to(dev)
    out = {"flat": {}, "leaf": {}, "faults": {}, "engines": {}}
    try:
        for name, q in quants.items():
            for masked in (False, True):
                kw = dict(quant=q, prev_buf=prev, u=u,
                          mask=mask if masked else None, mesh=mesh)
                out["flat"][(name, masked, "static")] = \
                    B.gossip_flat_ppermute(buf, pairs, **kw).cpu()
                out["flat"][(name, masked, "pool")] = \
                    B.gossip_flat_ppermute_pool(buf, pool, 2, **kw).cpu()
        pay = _ms_to((_ms_rows(inp["payload"][0], rank),
                      _ms_rows(inp["payload"][1], rank, 8)), dev)
        out["permuted"] = {
            "static": _ms_to(B.permute_payload_ppermute(
                pay, pairs, world, mesh=mesh), "cpu"),
            "pool": _ms_to(B.permute_payload_pool(
                pay, pool, 2, world, mesh=mesh), "cpu")}
        tree, tprev = (_ms_to(_ms_rows(inp[k], rank), dev)
                       for k in ("tree", "tprev"))
        u_leaf = [x.to(dev) for x in inp["u_leaf"]]
        for name, q in (("exact", None), ("q8", ModularQuantConfig())):
            out["leaf"][name] = _ms_to(E.gossip_ppermute(
                tree, pairs, q, tprev, None, u=u_leaf, mesh=mesh), "cpu")
        # planted faults on the masked q8 exchange
        q8 = quants["q8"]
        out["faults"]["mask_ignored"] = B.gossip_flat_ppermute(
            buf, pairs, quant=q8, prev_buf=prev, u=u, mesh=mesh).cpu()
        shifted = [(s, (d + 1) % world) for s, d in pairs]
        out["faults"]["partner_off_by_one"] = B.gossip_flat_ppermute(
            buf, shifted, quant=q8, prev_buf=prev, u=u, mask=mask,
            mesh=mesh).cpu()
        wait = B.Posted.wait

        def missed(posted):
            # the decode reads the receive buffers as they were before
            # the transfer landed (the work itself is waited, so the
            # channel stays in step)
            return tuple(torch.zeros_like(x) for x in wait(posted))
        B.Posted.wait = missed
        try:
            out["faults"]["missed_wait"] = B.gossip_flat_ppermute(
                buf, pairs, quant=q8, prev_buf=prev, u=u, mask=mask,
                mesh=mesh).cpu()
        finally:
            B.Posted.wait = wait
        cfg = reduced(get_config("transformer-wmt"), n_layers=1, d_model=32)
        model = TransformerLM(cfg)
        for (codec, mode), traj in inp["engines"].items():
            scfg = SwarmConfig(n_nodes=world, H=2, quantize=codec == "q8",
                               nonblocking=mode != "blocking",
                               overlap=mode == "overlap",
                               gossip_impl="ppermute")
            opt = make_optimizer("sgd", lr=0.05, momentum=0.9)
            step = make_swarm_step(
                scfg, model.functional_loss, opt.update, lambda s: 0.05,
                transport=E.GossipTransport(world, impl="ppermute",
                                            static_pairs=pairs, mesh=mesh),
                mesh=mesh)
            res = []
            for t, rec in enumerate(traj):
                s0 = rec["state"]
                rpn = None if s0.inflight is None else \
                    s0.inflight["sbuf"].shape[1] // 256
                infl = None if s0.inflight is None else {
                    "sbuf": _ms_rows(s0.inflight["sbuf"], rank),
                    "prev": _ms_rows(s0.inflight["prev"], rank),
                    "wire": _ms_rows(s0.inflight["wire"], rank, rpn)}
                st = SwarmState(*(_ms_to(_ms_rows(x, rank), dev) for x in
                                  (s0.params, s0.opt, s0.prev)), t,
                                _ms_to(infl, dev))
                b = _ms_to(_ms_rows(rec["batch"], rank), dev)
                nxt, m = step(st, b, _ms_perm(world), np.full(world, 2),
                              None, u=_ms_rows(rec["u"], rank).to(dev))
                res.append({"after": _ms_to(nxt.params, "cpu"),
                            "loss": float(m["loss"]),
                            "gamma": float(m["gamma"])})
            out["engines"][(codec, mode)] = res
        out["gather"] = _ms_gather_reference_rank(rank, world, mesh, inp,
                                                  inp["gather"])
        out["long_run"] = _ms_long_run_rank(mesh, cfg, inp,
                                            os.path.dirname(path))
        _sync(dev)
    finally:
        mesh.close()
    torch.save(out, os.path.join(os.path.dirname(path),
                                 f"reference_rank{rank}.pt"))


# the gather transport, the baselines and the join on the node mesh
MS_GATHER_CODECS = ("exact", "q4", "q8", "q16", "bf16", "topk")
# (algorithm, codec, mode) of the reduced step cases, 3 steps each
MS_GATHER_STEPS = (("swarm", "exact", "blocking"), ("swarm", "q8", "blocking"),
                   ("swarm", "topk", "nonblocking"),
                   ("swarm", "q8", "overlap"), ("swarm", "q8", "compress"),
                   ("allreduce", "exact", "masked"),
                   ("localsgd", "exact", "blocking"),
                   ("dpsgd", "exact", "masked"), ("adpsgd", "q8", "masked"),
                   ("sgp", "exact", "masked"), ("sgp", "q8", "blocking"))


def _ms_gather_perms(world: int) -> dict:
    """The gather cases' perms: the reference cases' matching and SGP's
    cyclic shift by one (not an involution for 3 or more ranks)."""
    import numpy as np
    return {"match": _ms_perm(world),
            "shift": (np.arange(world) - 1) % world}


def _ms_gather_codec(name):
    from repro_torch.quant.codecs import make_codec
    return None if name == "exact" else \
        make_codec("topk:0.25" if name == "topk" else name)


def _ms_gather_step(case, cfg, world, mesh=None):
    """The step of a reduced step case (transformer-wmt cut to 1 layer of
    d_model 32), on `mesh` (None: one shard, every node here) ->
    (step, its SwarmConfig for init, its optimizer)."""
    from repro_torch.algorithms import make_algorithm
    from repro_torch.core import exchange as E
    from repro_torch.core.graph import make_graph
    from repro_torch.core.swarm import SwarmConfig
    from repro_torch.models import TransformerLM
    from repro_torch.optim import make_optimizer
    from repro_torch.quant.schemes import ModularQuantConfig
    algo, codec, mode = case
    quant = ModularQuantConfig(safety=16.0)
    opt = make_optimizer("sgd", lr=0.05, momentum=0.9)
    kw = dict(loss_fn=TransformerLM(cfg).functional_loss,
              opt_update=opt.update, lr_fn=lambda s: 0.05, n_nodes=world,
              mesh=mesh)
    if algo == "swarm":
        scfg = SwarmConfig(n_nodes=world, H=2, quantize=codec != "exact",
                           quant=quant,
                           codec="topk:0.25" if codec == "topk" else None,
                           nonblocking=mode in ("nonblocking", "overlap"),
                           overlap=mode == "overlap",
                           compress_state=mode == "compress")
        kw.update(scfg=scfg, transport=E.GossipTransport(
            world, quant=quant, codec=scfg.make_codec(), mesh=mesh))
        return make_algorithm("swarm", **kw), scfg, opt
    scfg = SwarmConfig(n_nodes=world, H=2 if algo == "localsgd" else 1,
                       quantize=codec != "exact", quant=quant)
    kw["transport"] = E.GossipTransport(world, quant=quant, mesh=mesh)
    if algo == "localsgd":
        kw["H"] = 2
    if algo == "dpsgd":
        kw["graph"] = make_graph("ring", world)
    if algo in ("adpsgd", "sgp"):
        kw["quantize"] = codec != "exact"
    return make_algorithm(algo, **kw), scfg, opt


def _ms_gather_reference_inputs(world: int, cfg, inp: dict) -> dict:
    """The CPU's one-shard side of the gather cases of
    `multi_shard_reference`, on `inp`'s buffers: the flat gather exchange
    at every codec by a matching and by SGP's shift (masked and not), the
    node mean and the dense mix, the per-leaf oracle, 3 restarted steps of
    each of MS_GATHER_STEPS with their states, and one join bin."""
    import numpy as np
    import torch
    from repro_torch.algorithms.dpsgd import metropolis_weights
    from repro_torch.algorithms.sgp import sgp_init_state
    from repro_torch.core import bucket as B
    from repro_torch.core import exchange as E
    from repro_torch.core.graph import make_graph, sample_matching
    from repro_torch.core.swarm import (SwarmConfig, SwarmState,
                                        make_join_step, swarm_init)
    from repro_torch.models import init_params
    from repro_torch.quant.codecs import LatticeCodec, TopKCodec
    from repro_torch.quant.schemes import ModularQuantConfig
    from repro_torch.tree import tree_map
    buf, prev, u, mask = inp["buf"], inp["prev"], inp["u"], inp["mask"]
    gen = torch.Generator().manual_seed(9)
    res = 0.01 * torch.randn(buf.shape, generator=gen)
    W = torch.from_numpy(metropolis_weights(make_graph("ring", world))
                         .astype(np.float32))
    out = {"res": res, "W": W, "flat": {}, "scales": {}, "steps": {}}
    for pname, perm in _ms_gather_perms(world).items():
        pt = torch.as_tensor(perm)
        for name in MS_GATHER_CODECS:
            codec = B.as_codec(_ms_gather_codec(name))
            for masked in (False, True):
                matched = pt != torch.arange(world)
                if masked:
                    matched = matched & mask
                if codec is None:
                    got = (B.gossip_flat_exact(buf, pt, matched if masked
                                               else None), None)
                else:
                    got = B.gossip_flat_coded(
                        codec, buf, prev, pt, matched, None, u=u,
                        residual=res if codec.carries_residual else None)
                out["flat"][(name, pname, masked)] = got
    for name in MS_GATHER_CODECS[1:]:
        codec = B.as_codec(_ms_gather_codec(name))
        if isinstance(codec, LatticeCodec):
            out["scales"][name] = codec.encode(buf, prev, None, u=u)[1]
        elif isinstance(codec, TopKCodec):
            out["scales"][name] = codec.encode_ef(buf, prev, None, res)[0][
                0].abs().amax(dim=1)
    out["mean"] = {m: B.gossip_flat_mean(buf, mask if m else None)
                   .contiguous() for m in (False, True)}
    out["matrix"] = B.gossip_flat_matrix(W, buf)
    tree, tprev = inp["tree"], inp["tprev"]
    u_leaf = [torch.rand((world,) + tuple(x.shape[1:]), generator=gen)
              for x in inp["u_leaf"]]
    out["u_leaf_all"] = u_leaf
    perm = torch.as_tensor(_ms_gather_perms(world)["shift"])
    m_all = (perm != torch.arange(world)) & mask
    out["leaf"] = {"exact": E.gossip_exact(tree, perm, m_all),
                   "q8": E.gossip_quantized(ModularQuantConfig(), tree,
                                            tprev, perm, m_all, None,
                                            u=u_leaf)}
    # the step cases: each step's state, inputs and where it went
    rng = np.random.default_rng(4)
    graph = make_graph("complete", world)
    for case in MS_GATHER_STEPS:
        algo, codec, mode = case
        step, scfg, opt = _ms_gather_step(case, cfg, world)
        state = swarm_init(torch.Generator().manual_seed(0), scfg,
                           lambda g: init_params(g, cfg, "cpu"), opt.init)
        if codec == "exact" and algo != "allreduce":
            # distinct nodes, so the exchange moves them
            state.params = tree_map(
                lambda x: x + 0.01 * torch.randn(x.shape, generator=gen),
                state.params)
        if algo == "sgp":
            state = sgp_init_state(state, world, codec != "exact")
        h = 2 if algo in ("swarm", "localsgd") else 1
        traj = []
        for t in range(3):
            tok = torch.randint(0, cfg.vocab_size, (world, h, 2, 17),
                                generator=gen)
            b = {"tokens": tok[..., :-1], "targets": tok[..., 1:]}
            n_pad = B.build_layout(state.params).n_padded
            ut = torch.rand((world, n_pad), generator=gen)
            us = torch.rand((world, n_pad), generator=gen)
            p = sample_matching(graph, rng)
            m = mask.numpy() if mode == "masked" else None
            rows = []
            orig = (LatticeCodec.encode, TopKCodec.encode_ef)

            def enc(c, *a, **k):
                q_, s_ = orig[0](c, *a, **k)
                rows.append(s_.reshape(-1))
                return q_, s_

            def enc_ef(c, *a, **k):
                w_, r_ = orig[1](c, *a, **k)
                rows.append(w_[0].abs().amax(dim=1))
                return w_, r_
            LatticeCodec.encode, TopKCodec.encode_ef = enc, enc_ef
            try:
                nxt, met = step(state, b, p, np.full(world, h), None, m,
                                u=ut, **({"u_state": us}
                                         if mode == "compress" else {}))
            finally:
                LatticeCodec.encode, TopKCodec.encode_ef = orig
            if mode == "overlap":
                term = state.inflight["wire"][1]
            else:
                term = rows[0] if rows else None
            partner = (np.arange(world) - 2 ** (t % max(1, int(
                np.log2(world))))) % world if algo == "sgp" else p
            traj.append({"state": state, "batch": b, "perm": p, "mask": m,
                         "u": ut, "u_state": us, "term": term,
                         "partner": partner, "after": nxt,
                         "loss": float(met["loss"])})
            state = nxt
        out["steps"][case] = traj
    # one join bin: the last rank joins from donor 0
    scfg = SwarmConfig(n_nodes=world, quantize=True, codec="topk:0.25")
    st = swarm_init(torch.Generator().manual_seed(1), scfg,
                    lambda g: init_params(g, cfg, "cpu"), lambda p: {})
    st = SwarmState(tree_map(lambda x: x + 0.01 * torch.randn(
        x.shape, generator=gen).to(x.dtype), st.params), {},
        tree_map(torch.clone, st.params), 0, None,
        torch.randn(st.residual.shape, generator=gen))
    jperm = np.arange(world)
    jperm[0], jperm[world - 1] = world - 1, 0
    jm = np.arange(world) == world - 1
    out["join"] = {"state": st, "perm": jperm, "jm": jm,
                   "after": make_join_step(scfg)(st, jperm, jm)}
    return out


def _ms_faulty_peers(perm, mesh, land=None):
    """A planted fault: the rank sends to perm[rank] (and so receives from
    the j with perm[j] == rank) — right on a matching, backwards on a
    shift."""
    import numpy as np
    p = np.asarray(perm).reshape(-1)
    r = mesh.rank
    src = int(np.flatnonzero(p == r)[0])
    return ([int(p[r])] if p[r] != r else []), (src if src != r else None)


def _ms_gather_reference_rank(rank, world, mesh, inp, g):
    """A rank's gather cases of `multi_shard_reference` on its GPU from the
    CPU's inputs `inp` and gather inputs `g` (steps restarted from the
    CPU's state), and the planted faults -> results on the CPU."""
    import numpy as np
    import torch
    from repro_torch.core import bucket as B
    from repro_torch.core import exchange as E
    from repro_torch.core.swarm import SwarmState, make_join_step
    from repro_torch.core.swarm import SwarmConfig
    from repro_torch.quant.schemes import ModularQuantConfig
    dev = mesh.device

    def mine(x, n=1):
        return _ms_to(_ms_rows(x, rank, n), dev)
    buf, prev, u, res = (mine(inp["buf"]), mine(inp["prev"]), mine(inp["u"]),
                         mine(g["res"]))
    mask = inp["mask"].to(dev)
    out = {"flat": {}, "steps": {}, "faults": {}}
    for pname, perm in _ms_gather_perms(world).items():
        for name in MS_GATHER_CODECS:
            codec = B.as_codec(_ms_gather_codec(name))
            for masked in (False, True):
                matched = torch.as_tensor(perm != np.arange(world),
                                          device=dev)
                if masked:
                    matched = matched & mask
                m_r = matched[rank:rank + 1]
                if codec is None:
                    got = (B.gossip_flat_exact(buf, perm, m_r if masked
                                               else None, mesh=mesh), None)
                else:
                    got = B.gossip_flat_coded(
                        codec, buf, prev, perm, m_r, None, u=u,
                        residual=res if codec.carries_residual else None,
                        mesh=mesh)
                out["flat"][(name, pname, masked)] = _ms_to(got, "cpu")
    out["mean"] = {m: B.gossip_flat_mean(buf, mask if m else None,
                                         mesh=mesh).cpu() for m in (False,
                                                                    True)}
    out["matrix"] = B.gossip_flat_matrix(g["W"].to(dev), buf,
                                         mesh=mesh).cpu()
    perm = _ms_gather_perms(world)["shift"]
    m_r = torch.as_tensor((perm != np.arange(world))[rank:rank + 1],
                          device=dev) & mask[rank:rank + 1]
    tree, tprev = mine(inp["tree"]), mine(inp["tprev"])
    u_leaf = [mine(x) for x in g["u_leaf_all"]]
    out["leaf"] = {
        "exact": _ms_to(E.gossip_exact(tree, perm, m_r, mesh=mesh), "cpu"),
        "q8": _ms_to(E.gossip_quantized(ModularQuantConfig(), tree, tprev,
                                        perm, m_r, None, u=u_leaf,
                                        mesh=mesh), "cpu")}
    # the step cases, each step restarted from the CPU's state
    cfg = g["cfg"]
    for case, traj in g["steps"].items():
        step, _, _ = _ms_gather_step(case, cfg, world, mesh)
        got = []
        for t, rec in enumerate(traj):
            s0 = rec["state"]
            infl = None
            if s0.inflight is not None:
                rpn = s0.inflight["sbuf"].shape[1] // 256
                infl = {"sbuf": mine(s0.inflight["sbuf"]),
                        "prev": mine(s0.inflight["prev"]),
                        "wire": mine(s0.inflight["wire"], rpn)}
            prev_s = s0.prev
            if isinstance(prev_s, tuple):
                prev_s = mine(prev_s, rec["u"].shape[1] // 256)
            else:
                prev_s = mine(prev_s)
            st = SwarmState(mine(s0.params), mine(s0.opt), prev_s, t, infl,
                            mine(s0.residual))
            kw = {"u": mine(rec["u"])}
            if case[2] == "compress":
                kw["u_state"] = mine(rec["u_state"])
            h = 2 if case[0] in ("swarm", "localsgd") else 1
            nxt, met = step(st, mine(rec["batch"]), rec["perm"],
                            [h] * world, None, rec["mask"], **kw)
            got.append({"params": _ms_to(nxt.params, "cpu"),
                        "residual": _ms_to(nxt.residual, "cpu"),
                        "loss": float(met["loss"])})
        out["steps"][case] = got
    j = g["join"]
    st = make_join_step(SwarmConfig(n_nodes=world, quantize=True,
                                    codec="topk:0.25"), mesh=mesh)(
        SwarmState(mine(j["state"].params), {}, mine(j["state"].prev), 0,
                   None, mine(j["state"].residual)), j["perm"], j["jm"])
    out["join"] = SwarmState(_ms_to(st.params, "cpu"), {},
                             _ms_to(st.prev, "cpu"), 1, None,
                             st.residual.cpu())
    # planted faults
    peers = B.gather_peers
    B.gather_peers = _ms_faulty_peers
    try:
        out["faults"]["send_to_perm"] = B.gossip_flat_exact(
            buf, perm, None, mesh=mesh).cpu()
    finally:
        B.gather_peers = peers
    rows_fn = B.all_gather_rows
    B.all_gather_rows = lambda x, mesh_: x.expand(
        (mesh_.size,) + tuple(x.shape[1:]))
    try:
        out["faults"]["own_row_mean"] = B.gossip_flat_mean(
            buf, mesh=mesh).cpu()
    finally:
        B.all_gather_rows = rows_fn
    wrong = (rank + 1) % world
    out["faults"]["wrong_row"] = B.gossip_flat_matrix(
        g["W"].to(dev), B.all_gather_rows(buf, mesh))[wrong:wrong + 1].cpu()
    wait = B.Posted.wait
    B.Posted.wait = lambda posted: tuple(torch.zeros_like(x)
                                         for x in wait(posted))
    try:
        out["faults"]["missed_wait"] = B.gossip_flat_coded(
            B.as_codec(ModularQuantConfig()), buf, prev, perm,
            torch.ones(1, dtype=torch.bool, device=dev), None, u=u,
            mesh=mesh)[0].cpu()
    finally:
        B.Posted.wait = wait
    return out


def phase_multi_shard_reference(world: int, device: str = "cuda"):
    """`multi_shard_reference`: the reduced cases of
    ``tests/test_torch_multishard.py`` on a mesh of `world` ranks, one a
    GPU over NCCL, against the CPU's one-shard port (plain versions) on
    the same inputs — the flat exchange at every codec, masked and not,
    static and pool; the payload permutes; the per-leaf oracles; 3
    supersteps of the reduced transformer-wmt engine blocking exact and
    q8, non-blocking and overlapped q8, each restarted from the CPU's
    state — held to `phase_reference`'s bound, with planted faults (a
    mask ignored, a partner off by one, a missed wait on the received
    tensors) that must fail it; and the long run (`_ms_long_run_rank`):
    the mesh's mean model and checkpoint bitwise rank 0's one-card ones
    on its card, each load its slab, the reduced gather q8 chunk ==
    its per-step run and a chunked resume == the uninterrupted run on
    every rank, with a save of one row and a graph key without the peers
    planted to fail."""
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import bucket as B
    os.makedirs(MS_DIR, exist_ok=True)
    path = os.path.join(MS_DIR, "reference_inputs.pt")
    cfg = reduced(get_config("transformer-wmt"), n_layers=1, d_model=32)
    inp = _ms_reference_inputs(world, cfg)
    torch.save(inp, path)
    t0 = time.time()
    _ms_spawn(_ms_reference_rank, world, path, device)
    ranks = [torch.load(os.path.join(MS_DIR, f"reference_rank{r}.pt"),
                        weights_only=False) for r in range(world)]
    perm = _ms_perm(world)
    cases, bitwise_pairs = {}, {}

    def scales_of(name, form):
        if name not in inp["scales"]:
            return None
        p = perm if form == "static" else _ms_pool(world)[2]
        return inp["scales"][name][torch.as_tensor(p)]

    def readings(got, want, s):
        d = (got - want).abs()
        r = {"max_abs": float(d.max()),
             "share_within_2e-5": float((d <= 2e-5).double().mean()),
             "finite": bool(torch.isfinite(got).all())}
        if s is not None:
            d = d.reshape(world, -1, 256)
            r["beyond_one_step"] = int((~(d <= s.reshape(world, -1, 1)
                                         + 2e-5)).sum())
        return r

    def ok(r):
        return r["finite"] and _within_bound(r)
    for key, want in inp["flat"].items():
        got = torch.cat([r["flat"][key] for r in ranks])
        r = readings(got, want, scales_of(key[0], key[2]))
        cases["flat_{}_{}_{}".format(key[0], "masked" if key[1] else "full",
                                     key[2])] = r
        bitwise_pairs["flat_{}_{}_{}".format(*key)] = same_bits(got, want)
        check(ok(r), f"multi_shard_reference: flat {key} {r}")
    for form, want in inp["permuted"].items():
        matched = torch.as_tensor(
            (perm if form == "static" else _ms_pool(world)[2])
            != list(range(world)))
        for i, w in enumerate(want):
            got = torch.cat([r["permuted"][form][i] for r in ranks])
            rows = got.reshape(world, -1, *got.shape[1:])
            same = same_bits(rows[matched],
                             w.reshape(rows.shape)[matched]) and \
                not rows[~matched].any()
            bitwise_pairs[f"permuted_{form}_{i}"] = same
            check(same, f"multi_shard_reference: payload permute {form}")
    for name, want in inp["leaf"].items():
        for k in want:
            got = torch.cat([r["leaf"][name][k] for r in ranks])
            r = readings(got.float(), want[k].float(), None)
            cases[f"leaf_{name}_{k}"] = r
            check(r["finite"] and r["share_within_2e-5"] >= 0.999 and
                  (name != "exact" or r["max_abs"] <= 2e-5),
                  f"multi_shard_reference: per-leaf {name} {k} {r}")
    for (codec, mode), traj in inp["engines"].items():
        for t, rec in enumerate(traj):
            got = [r["engines"][(codec, mode)][t] for r in ranks]
            lay = B.build_layout(rec["after"])
            want = B.pack(lay, rec["after"])
            card = torch.cat([B.pack(B.build_layout(g["after"]), g["after"])
                              for g in got])
            r = readings(card, want, None if rec["scales"] is None else
                         rec["scales"][torch.as_tensor(perm)])
            r["loss_rel"] = abs(got[0]["loss"] - rec["loss"]) / \
                abs(rec["loss"])
            r["gamma"] = [got[0]["gamma"], rec["gamma"]]
            cases[f"engine_{codec}_{mode}_{t}"] = r
            check(ok(r) and r["loss_rel"] < 1e-4 and
                  len({g["loss"] for g in got}) == 1 and
                  len({g["gamma"] for g in got}) == 1,
                  f"multi_shard_reference: engine {codec} {mode} t={t} {r}")
    faults = {}
    want = inp["flat"][("q8", True, "static")]
    for name in ("mask_ignored", "partner_off_by_one", "missed_wait"):
        got = torch.cat([r["faults"][name] for r in ranks])
        r = readings(got, want, scales_of("q8", "static"))
        faults[name] = {"fails_bound": not ok(r), **r}
        check(not ok(r), f"multi_shard_reference: planted fault {name} "
              f"passes the bound {r}")
    _ms_gather_reference_checks(world, inp["gather"],
                                [r["gather"] for r in ranks], cases,
                                bitwise_pairs, faults)
    _ms_long_run_checks(world, inp, [r["long_run"] for r in ranks], cases,
                        bitwise_pairs, faults, device)
    log("multi_shard_reference", ranks=world, seconds=time.time() - t0,
        bitwise_card_vs_cpu=bitwise_pairs, cases=cases,
        planted_faults=faults)


def _ms_same_files(a: str, b: str) -> bool:
    """Two checkpoints with the same json and bitwise the same arrays."""
    import numpy as np
    with open(a + ".json") as f, open(b + ".json") as g:
        if json.load(f) != json.load(g):
            return False
    with np.load(a + ".npz") as x, np.load(b + ".npz") as y:
        return sorted(x.files) == sorted(y.files) and all(
            x[k].dtype == y[k].dtype and x[k].shape == y[k].shape and
            x[k].tobytes() == y[k].tobytes() for k in x.files)


def _ms_long_run_checks(world, inp, lr, cases, bitwise_pairs, faults,
                        device):
    """The long run's cases of `multi_shard_reference` (`lr`, a rank
    each): every rank's mesh μ bitwise rank 0's one-card μ on its card
    (and against the CPU's, reported), the mesh save bitwise rank 0's
    one-card save, each rank's load its slab, the chunk == the per-step
    driver and the chunked resume == the uninterrupted run on every rank;
    the planted save of one row and, on the card (where a chunk replays
    graphs; the CPU's runs its body eagerly), the keyless chunk must
    fail."""
    from repro_torch.checkpoint import mean_model_tree
    from repro_torch.tree import tree_flatten

    def leaves(t):
        return tree_flatten(t)[0]
    for form in ("tree", "leaf"):
        ok = all(_ms_same(leaves(x[f"mu_{form}"]),
                          leaves(lr[0][f"mu_{form}_one"])) for x in lr)
        bitwise_pairs[f"long_run_mean_model_{form}_mesh_vs_one_card"] = ok
        check(ok, f"multi_shard_reference: mesh μ ({form}) != the one-card "
              "μ on the card")
    cases["long_run_mean_model_card_vs_cpu"] = {"max_abs": max(
        float((a - b).abs().max()) for a, b in zip(
            leaves(lr[0]["mu_tree_one"]), leaves(mean_model_tree(
                inp["tree"]))))}
    same = _ms_same_files(os.path.join(MS_DIR, "long_mesh"),
                          os.path.join(MS_DIR, "long_one"))
    bitwise_pairs["long_run_mesh_save_vs_one_card"] = same
    check(same, "multi_shard_reference: the mesh save != rank 0's one-card "
          "save")
    own = _ms_same_files(os.path.join(MS_DIR, "long_own_row"),
                         os.path.join(MS_DIR, "long_one"))
    faults["save_own_row"] = {"fails": not own}
    check(not own, "multi_shard_reference: planted fault save_own_row "
          "passes")
    for what in ("load_bitwise", "chunk_bitwise", "resume_bitwise"):
        got = [x[what] for x in lr]
        bitwise_pairs[f"long_run_{what}"] = got
        check(all(got), f"multi_shard_reference: {what} {got}")
    for name in MS_LONG_RUN_CASES:
        got = [x["cases"][name]["bitwise"] for x in lr]
        bitwise_pairs[f"long_run_chunk_{name}"] = got
        cases[f"long_run_graphs_{name}"] = [x["cases"][name]["graphs"]
                                            for x in lr]
        check(all(got), f"multi_shard_reference: chunked {name} != per "
              f"step {got}")
    cases["long_run_graphs"] = [x["graphs"] for x in lr]
    if world >= 4:
        got = [x["keyless_differs"] for x in lr]
        faults["graph_key_without_peers"] = {
            "fails": got, "graphs": [x["keyless_graphs"] for x in lr]}
        check(all(got) or device != "cuda", "multi_shard_reference: planted "
              f"fault graph_key_without_peers replays bitwise {got}")
    else:
        faults["graph_key_without_peers"] = {
            "ran": False, "why": f"{world} ranks have one matching"}


def _ms_gather_reference_checks(world, g, gr, cases, bitwise_pairs, faults):
    """The gather cases of `multi_shard_reference`, card (`gr`, a rank
    each) against the CPU's one-shard port (`g`): each codec's bound of
    `codecs_reference` (exact within 2e-5), the join bitwise, the planted
    faults failing the bound; -> into `cases`, `bitwise_pairs`,
    `faults`."""
    import types
    import torch
    from repro_torch.tree import tree_leaves, tree_map

    def cat(trees):
        return tree_map(lambda *xs: torch.cat(xs), *trees)

    def held(name, card, cpu, term, partner):
        if name == "exact":
            r = _readings(card.params, cpu.params, None, partner)
            return r, _within_bound(r)
        spec = "topk:0.25" if name == "topk" else name
        r = _codec_readings(spec, card, cpu, term, partner)
        return r, _codec_ok(r)

    def ns(params, residual=None):
        return types.SimpleNamespace(params=params, residual=residual)
    for key, (want, want_res) in g["flat"].items():
        name, pname, masked = key
        got = torch.cat([r["flat"][key][0] for r in gr])
        res = None if want_res is None else \
            torch.cat([r["flat"][key][1] for r in gr])
        partner = _ms_gather_perms(world)[pname]
        r, good = held(name, ns({"b": got}, res), ns({"b": want}, want_res),
                       g["scales"].get(name), partner)
        tag = "gather_flat_{}_{}_{}".format(name, pname,
                                            "masked" if masked else "full")
        cases[tag] = r
        bitwise_pairs[tag] = same_bits(got, want)
        check(good, f"multi_shard_reference: {tag} {r}")
    for what, want in (("mean_full", g["mean"][False]),
                       ("mean_masked", g["mean"][True]),
                       ("matrix", g["matrix"])):
        got = torch.cat([r["mean"][what == "mean_masked"] if
                         what.startswith("mean") else r["matrix"]
                         for r in gr])
        r = {"max_abs": float((got - want).abs().max())}
        cases[f"gather_{what}"] = r
        bitwise_pairs[f"gather_{what}"] = same_bits(got, want)
        check(r["max_abs"] <= 2e-5, f"multi_shard_reference: {what} {r}")
    for name, want in g["leaf"].items():
        for k in want:
            got = torch.cat([r["leaf"][name][k] for r in gr]).float()
            d = (got - want[k].float()).abs()
            r = {"max_abs": float(d.max()),
                 "share_within_2e-5": float((d <= 2e-5).double().mean())}
            cases[f"gather_leaf_{name}_{k}"] = r
            check(r["share_within_2e-5"] >= 0.999 and
                  (name != "exact" or r["max_abs"] <= 2e-5),
                  f"multi_shard_reference: gather per-leaf {name} {k} {r}")
    for case, traj in g["steps"].items():
        tag = "_".join(case)
        for t, rec in enumerate(traj):
            got = [r["steps"][case][t] for r in gr]
            card = ns(cat([x["params"] for x in got]),
                      None if got[0]["residual"] is None else
                      torch.cat([x["residual"] for x in got]))
            r, good = held(case[1], card, rec["after"], rec["term"],
                           rec["partner"])
            r["loss_rel"] = abs(got[0]["loss"] - rec["loss"]) / \
                abs(rec["loss"])
            cases[f"gather_{tag}_{t}"] = r
            check(good and r["loss_rel"] < 1e-4 and
                  len({x["loss"] for x in got}) == 1,
                  f"multi_shard_reference: {tag} t={t} {r}")
    j, got = g["join"], [r["join"] for r in gr]
    after = j["after"]
    same = all(same_bits(a, b) for a, b in zip(
        tree_leaves(cat([x.params for x in got])) +
        tree_leaves(cat([x.prev for x in got])) +
        [torch.cat([x.residual for x in got])],
        tree_leaves(after.params) + tree_leaves(after.prev) +
        [after.residual]))
    bitwise_pairs["gather_join"] = same
    check(same, "multi_shard_reference: the join bin != the CPU's")
    perms = _ms_gather_perms(world)
    planted = {
        "send_to_perm": (g["flat"][("exact", "shift", False)][0],
                         "exact", None, None),
        "own_row_mean": (g["mean"][False], "exact", None, None),
        "wrong_row": (g["matrix"], "exact", None, None),
        "missed_wait": (g["flat"][("q8", "shift", False)][0], "q8",
                        g["scales"]["q8"], perms["shift"])}
    if world < 3:
        del planted["send_to_perm"]    # a shift of 2 is an involution
    for name, (want, spec, term, partner) in planted.items():
        got = torch.cat([r["faults"][name] for r in gr])
        r, good = held(spec, ns({"b": got}), ns({"b": want}), term,
                       partner if partner is not None else perms["match"])
        faults[f"gather_{name}"] = {"fails_bound": not good, **r}
        check(not good, f"multi_shard_reference: planted fault gather "
              f"{name} passes the bound {r}")


def _ms_full_width_rank(rank, world, port, cfg_name, out_dir, device):
    """A rank of `multi_shard_full_width`: its node of transformer-wmt at
    full width (or `cfg_name`, a reduced stand-in for a CPU rehearsal) in
    each of the MS_COMMANDS, MS_STEPS supersteps each; after each
    superstep rank 0 reruns its exchange, node mean or dense mix on one
    device through the one-shard path from every rank's gathered
    inputs."""
    import dataclasses
    import numpy as np
    import torch
    import torch.distributed as dist
    mesh = _ms_mesh(rank, world, port, device)
    dev = mesh.device
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import bucket as B
    from repro_torch.core import exchange as E
    from repro_torch.core.potential import gamma_potential
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch.profile import summarize
    from repro_torch.quant.codecs import LatticeCodec

    cfg = get_config("transformer-wmt") if cfg_name is None else \
        reduced(get_config("transformer-wmt"), n_layers=2, d_model=64)
    batch, seq = 4, 128 if cfg_name is None else 16

    def gather(x):
        """Every rank's `x` (one node's rows), stacked in rank order."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        return torch.cat(parts)

    def all_layout(layout):
        return dataclasses.replace(layout, n_nodes=world)

    results = {}
    events = _Events(dev)
    for name, (algo, impl, codec_spec, mode) in MS_COMMANDS.items():
        if name in MS_SCAN_H_MODE:
            continue              # chunked: `_ms_scan_full_width`
        _ms_progress(mesh, name)
        run = _MsRun(cfg, mesh, algo, impl, codec_spec, mode,
                     steps=MS_STEPS, batch=batch, seq=seq)
        tr, step, gen, state = run.tr, run.step, run.gen, run.state
        perms, hs, quantize = run.perms, run.hs, codec_spec is not None
        ugen = torch.Generator(device=dev)
        ugen.manual_seed(1000 + rank)
        n_pad = B.build_layout(state.params).n_padded
        # warm-up: NCCL sets up a pair's connection at its first exchange
        # and a collective's ring at its first call
        warm = (torch.zeros(1, 256, device=dev),)
        if impl == "gather":
            for p in (perms[0], (np.arange(world) - 1) % world,
                      (np.arange(world) - 2) % world):
                B.post_gather(warm, mesh, p).wait()
        else:
            B.post_exchange(warm, mesh, tr.mesh_pairs(perms[0])).wait()
        B.all_gather_rows(warm[0], mesh)
        stash = {}
        orig = {"mix": E.GossipTransport.mix_pair,
                "mean": E.GossipTransport.global_mean,
                "matrix": E.GossipTransport.matrix_mix,
                "decode": LatticeCodec.decode_avg,
                "post": B.post_exchange, "post_gather": B.post_gather,
                "wait": B.Posted.wait, "rows": B.all_gather_rows}

        def mix(self, tree, perm, matched, **kw_):
            out = orig["mix"](self, tree, perm, matched, **kw_)
            stash.update(kind="mix", tree=tree, perm=perm, matched=matched,
                         out=out, **kw_)
            return out

        def mean(self, tree, mask=None):
            out = orig["mean"](self, tree, mask)
            stash.update(kind="mean", tree=tree, mask=mask, out=out)
            return out

        def matrix(self, tree, W):
            out = orig["matrix"](self, tree, W)
            stash.update(kind="matrix", tree=tree, W=W, out=out)
            return out

        def decode(self, wire, ybuf, matched_rows=None, **kw_):
            out = orig["decode"](self, wire, ybuf, matched_rows, **kw_)
            stash.update(recv=wire, ybuf=ybuf, m_rows=matched_rows,
                         decoded=out)
            return out

        def post(payload, mesh_, pairs):
            events.mark()
            return orig["post"](payload, mesh_, pairs)

        def post_gather(payload, mesh_, perm, land=None):
            events.mark()
            return orig["post_gather"](payload, mesh_, perm, land)

        def wait(posted):
            got = orig["wait"](posted)
            events.mark()
            return got

        def rows(x, mesh_):
            events.mark()
            got = orig["rows"](x, mesh_)
            events.mark()
            return got

        def hooks(on: bool):
            E.GossipTransport.mix_pair = mix if on else orig["mix"]
            E.GossipTransport.global_mean = mean if on else orig["mean"]
            E.GossipTransport.matrix_mix = matrix if on else orig["matrix"]
            LatticeCodec.decode_avg = decode if on else orig["decode"]
            B.post_exchange = post if on else orig["post"]
            B.post_gather = post_gather if on else orig["post_gather"]
            B.Posted.wait = wait if on else orig["wait"]
            B.all_gather_rows = rows if on else orig["rows"]

        def check_exchange(t, sent):
            """Rank 0 reruns superstep t's exchange (or mean, or mix)
            through the one-shard path from every rank's gathered inputs;
            -> into `rec`."""
            if mode == "overlap":
                q_all, s_all = (gather(w) for w in sent)
                sb_all = gather(stash["ybuf"])
                mr_all = gather(stash["m_rows"].to(torch.uint8))
                out_all = gather(stash["decoded"])
                recv_all = tuple(gather(w) for w in stash["recv"])
                if rank == 0:
                    recv1 = B.permute_payload_pool(
                        (q_all, s_all), tr.matching_pool,
                        torch.tensor([int(perms[t][0])], device=dev), world)
                    out1 = tr.codec.decode_avg(recv1, sb_all, mr_all.bool())
                    rec["recv_bitwise"].append(all(
                        same_bits(a, b) for a, b in zip(recv1, recv_all)))
                    rec["exchange_bitwise"].append(same_bits(out1, out_all))
                return
            ef = isinstance(stash["out"], tuple)
            out_tree = stash["out"][0] if ef else stash["out"]
            tree = stash["tree"]
            lay = B.build_layout(tree)
            lay_all = all_layout(lay)
            buf_all = gather(B.pack(lay, tree))
            out_all = gather(B.pack(lay, out_tree))

            def same_tree(one):
                return same_bits(B.pack(lay_all, B.unpack(lay_all, one)),
                                 out_all)
            if stash["kind"] == "mean":
                if rank == 0:
                    rec["exchange_bitwise"].append(same_tree(
                        B.gossip_flat_mean(buf_all, stash["mask"])))
                return
            if stash["kind"] == "matrix":
                if rank == 0:
                    rec["exchange_bitwise"].append(same_tree(
                        B.gossip_flat_matrix(stash["W"], buf_all)))
                return
            if impl == "gather":
                m_all = gather(stash["matched"].to(torch.uint8)).bool()
                if quantize:
                    pb = stash.get("prev_buf")
                    pb_all = gather(pb if pb is not None
                                    else B.pack(lay, stash["prev"]))
                    u_all = None if stash.get("u") is None \
                        else gather(stash["u"])
                    r_all = None if stash.get("residual") is None \
                        else gather(stash["residual"])
                    nr_all = gather(stash["out"][1]) if ef else None
                    if rank == 0:
                        one, one_r = B.gossip_flat_coded(
                            tr.codec, buf_all, pb_all,
                            torch.as_tensor(stash["perm"], device=dev),
                            m_all, None, u=u_all, residual=r_all)
                        rec["exchange_bitwise"].append(
                            same_tree(one) and
                            (not ef or same_bits(one_r, nr_all)))
                elif rank == 0:
                    rec["exchange_bitwise"].append(same_tree(
                        B.gossip_flat_exact(
                            buf_all, torch.as_tensor(stash["perm"],
                                                     device=dev),
                            m_all if stash.get("mask") is not None
                            else None)))
                return
            pairs = tr.mesh_pairs(perms[t])
            if quantize:
                pb_all = gather(B.pack(lay, stash["prev"]))
                u_all = gather(stash["u"])
                if rank == 0:
                    one = B.gossip_flat_ppermute(buf_all, pairs,
                                                 quant=tr.codec,
                                                 prev_buf=pb_all, u=u_all)
                    rec["exchange_bitwise"].append(same_tree(one))
            elif rank == 0:
                leaf = B.pack(lay_all, E.gossip_ppermute(
                    B.unpack(lay_all, buf_all), pairs))
                flat = B.gossip_flat_ppermute(buf_all, pairs)
                rec["exchange_bitwise"].append(same_bits(leaf, out_all))
                rec["flat_equals_per_leaf"].append(same_bits(
                    B.pack(lay_all, B.unpack(lay_all, flat)), leaf))

        def barrier():
            """Every rank at the same point, its device idle."""
            dist.all_reduce(torch.zeros((1,), device=dev))
            _sync(dev)

        hooks(True)
        rec = {"superstep_s": [], "nccl_ms": [], "losses": [], "gamma": [],
               "peak_bytes": 0, "exchange_bitwise": [],
               "flat_equals_per_leaf": [], "recv_bitwise": []}
        try:
            reset_launch_counts()
            for t in range(MS_STEPS):
                bt = run.batch(t)
                u = torch.rand((1, n_pad), generator=ugen, device=dev) \
                    if quantize else None
                extra = {"u_state": torch.rand(
                    (1, n_pad), generator=ugen, device=dev)} \
                    if mode == "compress" else {}
                sent = state.inflight["wire"] if mode == "overlap" else None
                stash.clear()
                _sync(dev)
                if dev.type == "cuda":
                    torch.cuda.reset_peak_memory_stats(dev)
                profiled = mode == "overlap" and t == 2 and rank == 0 \
                    and dev.type == "cuda"
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) if profiled \
                    else None
                if prof is not None:
                    prof.__enter__()
                barrier()
                t0 = time.perf_counter()
                state, m = step(state, bt, perms[t], hs[t], gen, u=u,
                                **extra)
                m = {k: float(v) for k, v in m.items()}
                _sync(dev)
                dt = time.perf_counter() - t0
                if prof is not None:
                    prof.__exit__(None, None, None)
                    trace = os.path.join(out_dir, "overlap_trace.json")
                    prof.export_chrome_trace(trace)
                    with open(trace) as f:
                        rec["profile"] = summarize(json.load(f), dt * 1e3)
                    rec["profile"].pop("spans")
                rec["superstep_s"].append(dt)
                rec["nccl_ms"].append(sum(events.spans_ms()))
                rec["losses"].append(m["loss"])
                rec["gamma"].append(m["gamma"])
                if dev.type == "cuda":
                    rec["peak_bytes"] = max(
                        rec["peak_bytes"],
                        torch.cuda.max_memory_allocated(dev))
                counts = dict(LAUNCHES)
                # the check: rank 0 reruns this exchange on one device
                # through the one-shard path (its launches not counted)
                hooks(False)
                check_exchange(t, sent)
                stash.clear()
                hooks(True)
                LAUNCHES.update(counts)
            rec["launches"] = dict(LAUNCHES)
        finally:
            hooks(False)
        if algo in ("allreduce", "localsgd", "dpsgd"):
            # every other rank's packed rows arrive at each rank
            rec["allgather_bytes_per_rank"] = (world - 1) * \
                tr.payload_num_bytes(state.params, False)
        else:
            rec["wire_bytes_per_node"] = tr.payload_num_bytes(
                state.params, quantize)
        if algo == "sgp":
            rec["sum_w"] = float(gather(state.params["w"]).sum())
        results[name] = rec
        last = state.params["model"] if algo == "sgp" else state.params
        del state, step, tr, sent, run
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    # Γ on the mesh: one all-reduce of the packed buffer, one of a scalar
    g_ms = []
    for _ in range(5):
        events.mark()
        gamma_potential(last, mesh=mesh)
        events.mark()
        g_ms.extend(events.spans_ms())
    buf = B.pack(B.build_layout(last), last)[0]
    ar_ms = []
    for _ in range(5):
        events.mark()
        dist.all_reduce(buf)
        events.mark()
        ar_ms.extend(events.spans_ms())
    results["gamma_ms"] = g_ms
    results["allreduce_ms"] = ar_ms
    results["allreduce_bytes"] = buf.numel() * buf.element_size()
    del last, buf
    results["clean_gather_q8"] = _ms_clean_peak(mesh, cfg, batch, seq)
    results.update(_ms_scan_full_width(mesh, cfg, out_dir, batch, seq))
    mesh.close()
    with open(os.path.join(out_dir, f"full_width_rank{rank}.json"), "w") as f:
        json.dump(results, f)




def _ms_clean_peak(mesh, cfg, batch, seq) -> dict:
    """`multi_shard_gather_q8` (blocking gather q8) for 2 supersteps with
    no check hooked in: the rank's peak allocated above what was live
    before it was built (None off the card), which the dry run's
    ``--nodes`` trace predicts (`phase_multi_shard_full_width`)."""
    import gc
    import torch
    dev = mesh.device
    cuda = dev.type == "cuda"
    gc.collect()
    _sync(dev)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    start = torch.cuda.memory_allocated(dev) if cuda else 0
    run = _MsRun(cfg, mesh, "swarm", "gather", "q8", "blocking", steps=2,
                 batch=batch, seq=seq)
    run.per_step(0, 2)
    _sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) - start if cuda else None
    del run
    if cuda:
        torch.cuda.empty_cache()
    return {"peak_above_start_bytes": peak}


def _ms_scan_full_width(mesh, cfg, out_dir, batch, seq) -> dict:
    """This rank's chunked commands (MS_SCAN_H_MODE) at full width, under
    deterministic algorithms: each per step, then chunked
    (MS_SCAN_STEPS supersteps in chunks of MS_CHUNK) from the same state,
    launch counters at 0 before the chunked run; the state and every
    superstep's metrics compared bitwise. The gather command's chunk
    boundary also evaluates the mean model (through the graphs' pool) and
    writes a mesh checkpoint of what a resume needs, which a fresh run
    reloads and resumes from in a new driver, built after the first is
    closed and the allocator's cache emptied. -> {name: record}."""
    import gc
    import warnings
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    dev, rank = mesh.device, mesh.rank
    on_card = dev.type == "cuda"

    def fresh():
        gc.collect()
        _sync(dev)
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
    out = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for name, h_mode in MS_SCAN_H_MODE.items():
                algo, impl, codec_spec, mode = MS_COMMANDS[name]

                def run():
                    return _MsRun(cfg, mesh, algo, impl, codec_spec, mode,
                                  h_mode=h_mode, batch=batch, seq=seq)
                fresh()
                _ms_progress(mesh, f"{name} eager")
                eager = run()
                ms_e, secs_e = eager.per_step(0, MS_SCAN_STEPS)
                want = eager.leaves()
                del eager
                fresh()
                _ms_progress(mesh, f"{name} chunk 0")
                chk = run()
                rec = {"hs": chk.hs.tolist()}
                reset_launch_counts()
                ms_c, secs_c = chk.chunked(0, MS_CHUNK)
                loaded = None
                if name == "multi_shard_gather_q8_scan":
                    counts = dict(LAUNCHES)
                    rec["checkpoint"], loaded = _ms_scan_checkpoint(
                        chk, out_dir, batch, seq)
                    LAUNCHES.update(counts)
                _ms_progress(mesh, f"{name} chunk 1")
                m2, s2 = chk.chunked(MS_CHUNK, MS_SCAN_STEPS)
                ms_c, secs_c = ms_c + m2, secs_c + s2
                rec.update(
                    launches=dict(LAUNCHES),
                    want=_ms_want(name, chk.hs, rank),
                    state_bitwise=_ms_same(chk.leaves(), want),
                    metrics_bitwise=ms_c == ms_e,
                    losses=[m["loss"] for m in ms_c],
                    superstep_s_eager=secs_e, chunk_s=secs_c,
                    graphs=len(chk.chunker.graphs),
                    keys=[str(k) for k in chk.chunker.graphs],
                    pool_bytes_after_capture={
                        str(k): v
                        for k, v in chk.chunker.pool_bytes.items()},
                    pool_reserved_bytes=chk.chunker.pool_reserved())
                if on_card:
                    rec.update(peak_bytes=torch.cuda.max_memory_allocated(
                        dev), peak_reserved_bytes=torch.cuda
                        .max_memory_reserved(dev))
                final = chk.leaves() if loaded is not None else None
                chk.close()
                if loaded is not None:
                    # a new driver resumes from what the boundary's
                    # checkpoint reloaded
                    fresh()
                    _ms_progress(mesh, f"{name} resume")
                    res = run()
                    res.restore(loaded, MS_CHUNK)
                    del loaded
                    ms_r, _ = res.chunked(MS_CHUNK, MS_SCAN_STEPS)
                    rec["checkpoint"]["resume_bitwise"] = _ms_same(
                        res.leaves(), final) and ms_r == ms_c[MS_CHUNK:]
                    res.close()
                    del res, final
                del chk, want
                out[name] = rec
        _ms_progress(mesh, "scan commands done")
    finally:
        torch.use_deterministic_algorithms(False)
    _sync(dev)
    return out


def _ms_scan_checkpoint(run, out_dir, batch, seq) -> dict:
    """At the chunk boundary of the chunked gather command: --eval-mean
    on the mesh through the graphs' pool (rank 0 also evaluates the
    gathered state on its one card: μ bitwise, the losses within 1e-6),
    then one mesh checkpoint of what a resume needs (bytes, seconds to
    gather and to write, each rank's peak), reloaded bitwise and deleted;
    -> (its record, the reloaded tree)."""
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import (load_checkpoint, mean_model_tree,
                                        save_checkpoint)
    from repro_torch.core import bucket as B
    from repro_torch.core.swarm import make_mean_model_eval
    from repro_torch.data import make_node_batches
    from repro_torch.tree import tree_flatten, tree_map
    mesh, dev, rank = run.mesh, run.dev, run.mesh.rank
    on_card = dev.type == "cuda"
    rec = {}
    nb = make_node_batches(run.ds, MS_CHUNK - 1, batch)
    eb = {k: torch.from_numpy(v[0].reshape(-1, seq)).to(dev)
          for k, v in nb.items()}
    loss = run.model.functional_loss
    _ms_progress(mesh, "checkpoint eval-mean")
    with run.chunker.borrow_pool():
        params = run.state.params
        got = make_mean_model_eval(loss, mesh=mesh)(params, eb)
        rec["eval_mean"] = {k: float(v) for k, v in got.items()}
        mu = mean_model_tree(params, mesh=mesh)
        stacked = tree_map(lambda x: B.all_gather_slab(x, mesh), params)
        if rank == 0:
            one = make_mean_model_eval(loss)(stacked, eb)
            rec["eval_mean_one_card"] = {k: float(v) for k, v in one.items()}
            rec["mu_bitwise_one_card"] = _ms_same(
                tree_flatten(mu)[0], tree_flatten(mean_model_tree(stacked))[0])
            rec["eval_within_1e-6"] = all(
                abs(rec["eval_mean"][k] - rec["eval_mean_one_card"][k])
                <= 1e-6 for k in got)
            rec["loss_mean_model_bitwise"] = \
                rec["eval_mean"]["loss_mean_model"] == \
                rec["eval_mean_one_card"]["loss_mean_model"]
            del one
        del got, mu, stacked, params
    _sync(dev)
    tree = run.ckpt_tree()
    path = os.path.join(out_dir, "scan_ckpt", "step_000004")
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    _ms_progress(mesh, "checkpoint save")
    dist.barrier(group=mesh.group)
    t0 = time.perf_counter()
    times = {}
    save_checkpoint(path, tree, {"nodes": mesh.size, "step": MS_CHUNK},
                    mesh=mesh, times=times)
    rec["save_s"] = time.perf_counter() - t0
    rec.update(times)
    if on_card:
        rec["peak_above_state_bytes"] = \
            torch.cuda.max_memory_allocated(dev) - base
    if rank == 0:
        rec["bytes_written"] = os.path.getsize(path + ".npz") + \
            os.path.getsize(path + ".json")
    _ms_progress(mesh, "checkpoint reload")
    t0 = time.perf_counter()
    got = load_checkpoint(path, tree, mesh=mesh)
    rec["load_s"] = time.perf_counter() - t0
    rec["reload_bitwise"] = _ms_same(tree_flatten(got, tuples=True)[0],
                                     tree_flatten(tree, tuples=True)[0])
    del tree
    dist.barrier(group=mesh.group)
    if rank == 0:
        for f in (path + ".npz", path + ".json"):
            os.remove(f)
    return rec, got


def _link_type(world: int) -> dict:
    """GPU0's link to each other GPU of the mesh, as ``nvidia-smi topo
    -m`` prints it (NV<k> = k NVLinks); where that query fails, what it
    printed, GPU0's NVLink status (``nvidia-smi nvlink -s -i 0``) and
    whether GPU0 can reach each peer's memory directly."""
    import torch

    def smi(*a):
        try:
            return subprocess.run(["nvidia-smi", *a], capture_output=True,
                                  text=True, timeout=60).stdout.strip()
        except (OSError, subprocess.TimeoutExpired) as e:
            return f"error: {e}"
    txt = smi("topo", "-m")
    rows = [ln.split() for ln in txt.splitlines() if ln.startswith("GPU0")]
    if rows and len(rows[0]) > world:
        return {f"GPU0-GPU{j}": rows[0][1 + j] for j in range(1, world)}
    links = [ln.strip() for ln in smi("nvlink", "-s", "-i", "0").splitlines()
             if ln.strip().startswith("Link")]
    return {"topo_m": txt[:200], "nvlink_gpu0": links,
            "peer_access_gpu0": [torch.cuda.can_device_access_peer(0, j)
                                 for j in range(1, world)]}


def phase_multi_shard_full_width(world: int, device: str = "cuda",
                                 cfg_name=None) -> dict:
    """`multi_shard_full_width`: transformer-wmt at full width and depth
    (12 layers, d_model 1024, bf16 with fp32 momentum, batch 4 x seq
    128), one node a rank, `world` ranks over NCCL; each of MS_COMMANDS
    for MS_STEPS supersteps — blocking q8 ``ppermute``, ``ppermute_pool
    --nonblocking --overlap`` q8 (pool 8), the ``ppermute_legacy``
    oracle exact; on gather blocking q8 (Algorithm 1 on the default
    transport), ``--nonblocking --codec topk:0.25`` with its residual and
    ``--compress-state`` q8; ``--algo allreduce``, ``localsgd`` (H 2),
    ``dpsgd`` (ring), ``adpsgd --quantize`` and ``sgp``. Every
    superstep's exchange, node mean or dense mix equals, bitwise, rank
    0's rerun of it on one device through the one-shard path (the ranks'
    inputs and uniforms gathered); the flat exact exchange equals its
    per-leaf oracle bitwise; every rank launches the kernels MS_WANT
    names. Prints per command the superstep times (every rank's), the
    NCCL time (CUDA events from the post to the landed work, or around
    the all-gather), wire bytes per node or all-gather bytes per rank,
    ``permute_overlap`` (overlapped command, rank 0's trace of its 3rd
    superstep), peak memory and launches per rank, and Γ, then Γ's and
    an all-reduce's time at the model's size, and the GPUs' link. The
    chunked commands (MS_SCAN_H_MODE: gather q8 blocking and
    ``ppermute_pool`` overlapped q8 with geometric h, ``--scan-chunk 4``,
    MS_SCAN_STEPS supersteps) run against the same command per step
    (`_ms_scan_full_width`, `_ms_scan_checks`): replay == eager bitwise
    on every rank, launches, graphs and keys, pool bytes and peaks, the
    eager and chunked superstep times, and at the gather command's chunk
    boundary the mean model and one mesh checkpoint, reloaded and resumed
    from bitwise; -> {path: rank 0's launches}."""
    os.makedirs(MS_DIR, exist_ok=True)
    t0 = time.time()
    _ms_spawn(_ms_full_width_rank, world, cfg_name, MS_DIR, device)
    ranks = []
    for r in range(world):
        with open(os.path.join(MS_DIR, f"full_width_rank{r}.json")) as f:
            ranks.append(json.load(f))
    out, by_path = {}, {}
    for name in MS_COMMANDS:
        if name in MS_SCAN_H_MODE:
            continue
        per = [r[name] for r in ranks]
        r0 = per[0]
        losses = [p["losses"] for p in per]
        check(all(math.isfinite(x) for x in losses[0]) and
              all(x == losses[0] for x in losses),
              f"{name}: losses not finite or not the same on every rank")
        check(len(r0["exchange_bitwise"]) == MS_STEPS and
              all(r0["exchange_bitwise"]),
              f"{name}: the mesh's exchange != the one-shard rerun: "
              f"{r0['exchange_bitwise']}")
        if name.endswith("legacy_exact"):
            check(all(r0["flat_equals_per_leaf"]) and
                  len(r0["flat_equals_per_leaf"]) == MS_STEPS,
                  f"{name}: flat exact != per-leaf oracle")
        if "overlap" in name:
            check(all(r0["recv_bitwise"]), f"{name}: received != sent")
        if "sum_w" in r0:
            check(abs(r0["sum_w"] - world) <= 1e-4 * world,
                  f"{name}: SGP's sum of w {r0['sum_w']} != {world}")
        if device == "cuda":
            for r, p in enumerate(per):
                check(p["launches"] == MS_WANT[name],
                      f"{name}: rank {r} launches {p['launches']} != "
                      f"{MS_WANT[name]}")
        steady = [statistics.median(p["superstep_s"][1:]) for p in per]
        out[name] = {
            "superstep_s_by_rank": [p["superstep_s"] for p in per],
            "superstep_median_s_rank0": steady[0],
            "superstep_median_s_max_rank": max(steady),
            "nccl_ms_by_rank": [p["nccl_ms"] for p in per],
            **{k: r0[k] for k in ("wire_bytes_per_node",
                                  "allgather_bytes_per_rank", "sum_w")
               if k in r0},
            "peak_bytes_by_rank": [p["peak_bytes"] for p in per],
            "launches_by_rank": [p["launches"] for p in per],
            "want": MS_WANT[name],
            "losses": r0["losses"], "gamma": r0["gamma"],
            "exchange_bitwise": r0["exchange_bitwise"],
            **({"flat_equals_per_leaf": r0["flat_equals_per_leaf"]}
               if r0["flat_equals_per_leaf"] else {}),
            **({"permute_overlap": r0["profile"]["permute_overlap"],
                "profile_idle_share": r0["profile"]["idle_share"]}
               if "profile" in r0 else {})}
        by_path[name] = r0["launches"]
    for name in MS_SCAN_H_MODE:
        out[name] = _ms_scan_checks(name, [r[name] for r in ranks], device)
        by_path[name] = ranks[0][name]["launches"]
    if device == "cuda" and cfg_name is None:
        out["dryrun"] = _ms_dryrun(
            world, [r["clean_gather_q8"]["peak_above_start_bytes"]
                    for r in ranks])
    log("multi_shard_full_width", ranks=world, seconds=time.time() - t0,
        link=_link_type(world) if device == "cuda" else None,
        gamma_ms=ranks[0]["gamma_ms"], allreduce_ms=ranks[0]["allreduce_ms"],
        allreduce_bytes=ranks[0]["allreduce_bytes"], **out)
    return by_path


def _ms_dryrun(world: int, measured: list) -> dict:
    """The dry run of the clean gather q8 command on a node mesh of
    `world` GPUs (``--nodes``: rank 0's step, the other ranks torch's fake
    process group) on fake CUDA and CPU tensors: the counted fields equal,
    no device memory, and each rank's measured peak above its start
    (`_ms_clean_peak`) within DRYRUN_BOUND of the predicted peak."""
    flags = ["--shape", "train_4k", "--nodes", str(world), "--batch", "4",
             "--seq", "128", "--quantize"]
    recs = _dryrun_jobs({"multi_shard_gather_q8": flags}, ("cuda", "cpu"))
    cuda, cpu = (recs["multi_shard_gather_q8", d] for d in ("cuda", "cpu"))
    differ = [k for k in DRYRUN_COUNTED if cuda.get(k) != cpu.get(k)]
    check(not differ, f"mesh dry run: cuda and cpu records differ in "
          f"{differ}")
    check(_fake_touch_ok(cuda), f"mesh dry run allocated "
          f"{cuda['device_allocated_bytes']} B at its peak, "
          f"{cuda['device_allocated_after_bytes']} B at its end")
    ratios = [m / cuda["peak_bytes"] for m in measured]
    lo, hi = DRYRUN_BOUND
    check(all(lo <= r <= hi for r in ratios),
          f"mesh dry run: measured over predicted {ratios} outside "
          f"{DRYRUN_BOUND}")
    return {"predicted_bytes": cuda["peak_bytes"],
            "measured_bytes_by_rank": measured,
            "measured_over_predicted_by_rank": ratios,
            "argument_bytes": cuda["argument_bytes"],
            "coll_raw": cuda["coll_raw"],
            "wire_bytes_per_node": cuda["wire_bytes_per_node"],
            "t_trace_s": cuda["t_trace_s"]}


# a train_4k node on a node mesh of the ranks, one node a GPU: the
# reference's `single` node batch, b_local = 256 // (16 nodes x H 2) = 8
# sequences of 4096 a local step, blocking gather q8, with the arch's
# remat (on); only the node count is cut, from 16 to the ranks. olmo-1b:
# its `single` dry run with remat fits one H100 (PERF.md §6)
MS_TRAIN_4K_ARCH = "olmo-1b"
MS_TRAIN_4K_STEPS = 2


def _ms_train_4k_cfg(cfg_name):
    """(config, batch, seq) of `multi_shard_train_4k` (`cfg_name`
    "reduced": a small stand-in with remat on, for a CPU rehearsal)."""
    import dataclasses
    from repro_torch.configs import get_config, reduced
    cfg = get_config(MS_TRAIN_4K_ARCH)
    if cfg_name is None:
        return cfg, 8, 4096
    return dataclasses.replace(reduced(cfg, n_layers=2, d_model=64),
                               remat=True), 2, 32


def _ms_train_4k_rank(rank, world, port, cfg_name, out_dir, device):
    """A rank of `multi_shard_train_4k`: its node's MS_TRAIN_4K_STEPS
    supersteps of blocking gather q8 with no check hooked in; writes its
    losses, superstep times, launches and peak allocated above what was
    live before the run was built."""
    import gc
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    mesh = _ms_mesh(rank, world, port, device)
    dev = mesh.device
    cuda = dev.type == "cuda"
    cfg, batch, seq = _ms_train_4k_cfg(cfg_name)
    _ms_progress(mesh, "train_4k build")
    gc.collect()
    _sync(dev)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    start = torch.cuda.memory_allocated(dev) if cuda else 0
    reset_launch_counts()
    run = _MsRun(cfg, mesh, "swarm", "gather", "q8", "blocking",
                 steps=MS_TRAIN_4K_STEPS, batch=batch, seq=seq)
    ms, secs = run.per_step(0, MS_TRAIN_4K_STEPS)
    _sync(dev)
    rec = {"losses": [m["loss"] for m in ms], "superstep_s": secs,
           "launches": dict(LAUNCHES), "start_bytes": start,
           "peak_above_start_bytes": torch.cuda.max_memory_allocated(dev)
           - start if cuda else None, "remat": cfg.remat,
           "params_per_node": cfg.n_params()}
    del run
    mesh.close()
    with open(os.path.join(out_dir, f"train_4k_rank{rank}.json"), "w") as f:
        json.dump(rec, f)


def phase_multi_shard_train_4k(world: int, device: str = "cuda",
                               cfg_name=None) -> dict:
    """`multi_shard_train_4k`: a train_4k node of MS_TRAIN_4K_ARCH at full
    width and depth on each of `world` ranks (one node a GPU, the
    reference's `single` node batch of 8 x 4096 tokens a local step, H 2,
    blocking gather q8, remat on), MS_TRAIN_4K_STEPS supersteps: finite
    losses, the same on every rank, launches 2 / 1 / 1 a superstep on
    every rank, and each rank's peak allocated above its start within
    DRYRUN_BOUND of ``repro_torch.launch.dryrun --nodes <world> --batch 8``
    (traced on fake CUDA and CPU tensors while the ranks run: the counted
    fields equal). -> {path: rank 0's launches}."""
    cfg, batch, seq = _ms_train_4k_cfg(cfg_name)
    cuda = device == "cuda" and cfg_name is None
    flags = ["--shape", "train_4k", "--nodes", str(world), "--batch",
             str(batch), "--seq", str(seq), "--quantize"]
    procs = _dryrun_start({"multi_shard_train_4k": flags}, ("cuda", "cpu"),
                          arch=MS_TRAIN_4K_ARCH) if cuda else None
    os.makedirs(MS_DIR, exist_ok=True)
    t0 = time.time()
    _ms_spawn(_ms_train_4k_rank, world, cfg_name, MS_DIR, device)
    ranks = []
    for r in range(world):
        with open(os.path.join(MS_DIR, f"train_4k_rank{r}.json")) as f:
            ranks.append(json.load(f))
    seconds = time.time() - t0
    losses = [p["losses"] for p in ranks]
    check(all(math.isfinite(x) for x in losses[0]) and
          all(x == losses[0] for x in losses),
          f"train_4k: losses not finite or not the same on every rank "
          f"{losses}")
    want = {"sgd_update": 2 * MS_TRAIN_4K_STEPS,
            "quantize_mod": MS_TRAIN_4K_STEPS,
            "decode_avg": MS_TRAIN_4K_STEPS}
    if device == "cuda":
        for r, p in enumerate(ranks):
            check(p["launches"] == want, f"train_4k: rank {r} launches "
                  f"{p['launches']} != {want}")
    out = {"arch": cfg.name, "batch_per_node": batch, "seq": seq,
           "H": 2, "remat": cfg.remat, "nodes": world,
           "params_per_node": ranks[0]["params_per_node"],
           "losses": losses[0], "seconds": seconds,
           **{k: [p[k] for p in ranks] for k in (
               "superstep_s", "peak_above_start_bytes", "start_bytes",
               "launches")}}
    if cuda:
        recs = _dryrun_jobs(None, None, procs)
        rc, rp = (recs["multi_shard_train_4k", d] for d in ("cuda", "cpu"))
        differ = [k for k in DRYRUN_COUNTED if rc.get(k) != rp.get(k)]
        check(not differ, f"train_4k dry run: cuda and cpu records differ "
              f"in {differ}")
        check(_fake_touch_ok(rc), f"train_4k dry run allocated "
              f"{rc['device_allocated_bytes']} B at its peak, "
              f"{rc['device_allocated_after_bytes']} B at its end")
        ratios = [p["peak_above_start_bytes"] / rc["peak_bytes"]
                  for p in ranks]
        out["dryrun"] = {
            "predicted_bytes": rc["peak_bytes"],
            "measured_over_predicted_by_rank": ratios,
            **{k: rc[k] for k in ("remat", "argument_bytes", "temp_bytes",
                                  "fits", "flops_per_dev",
                                  "flops_analytic_per_dev", "compute_s",
                                  "memory_s", "bottleneck", "t_trace_s")}}
    log("multi_shard_train_4k", **out)
    if cuda:
        lo, hi = DRYRUN_BOUND
        check(all(lo <= r <= hi for r in ratios),
              f"train_4k: measured over predicted {ratios} outside "
              f"{DRYRUN_BOUND}")
    return {"multi_shard_train_4k": ranks[0]["launches"]}


def _ms_scan_checks(name, per, device) -> dict:
    """A chunked command's records (`per`, a rank each): replay == eager
    bitwise (state and every superstep's metrics) and the launches
    MS_WANT names on every rank, finite losses, the same on every rank;
    at the gather command's boundary the mean model and the checkpoint
    (reload and resume bitwise, μ bitwise rank 0's one-card μ, the
    losses within 1e-6 of its one-card evaluation). -> the printed
    record: each rank's eager superstep median (steps 2..) against the
    second chunk's time a superstep, graphs and keys, pool bytes, peaks."""
    for r, p in enumerate(per):
        check(p["state_bitwise"] and p["metrics_bitwise"],
              f"{name}: rank {r} replay != eager (state "
              f"{p['state_bitwise']}, metrics {p['metrics_bitwise']})")
        if device == "cuda":
            check(p["launches"] == p["want"],
                  f"{name}: rank {r} launches {p['launches']} != "
                  f"{p['want']}")
    losses = [p["losses"] for p in per]
    check(all(math.isfinite(x) for x in losses[0]) and
          all(x == losses[0] for x in losses),
          f"{name}: losses not finite or not the same on every rank")
    eager = [statistics.median(p["superstep_s_eager"][1:]) for p in per]
    chunked = [p["chunk_s"][1] / MS_CHUNK for p in per]
    rec = {"superstep_median_s_eager_by_rank": eager,
           "superstep_s_chunked_by_rank": chunked,
           "chunked_over_eager_rank0": chunked[0] / eager[0],
           "superstep_s_eager_by_rank": [p["superstep_s_eager"]
                                         for p in per],
           "chunk_s_by_rank": [p["chunk_s"] for p in per],
           **{k: [p.get(k) for p in per] for k in (
               "launches", "want", "graphs", "keys",
               "pool_bytes_after_capture", "pool_reserved_bytes",
               "peak_bytes", "peak_reserved_bytes")},
           "hs": per[0]["hs"], "losses": losses[0],
           "replay_equals_eager": [p["state_bitwise"] and
                                   p["metrics_bitwise"] for p in per]}
    if "checkpoint" in per[0]:
        ck = [p["checkpoint"] for p in per]
        check(all(c["reload_bitwise"] and c["resume_bitwise"] for c in ck),
              f"{name}: checkpoint reload / resume not bitwise {ck}")
        check(ck[0]["mu_bitwise_one_card"] and ck[0]["eval_within_1e-6"]
              and ck[0]["loss_mean_model_bitwise"],
              f"{name}: --eval-mean on the mesh != one card {ck[0]}")
        check(all(c["eval_mean"] == ck[0]["eval_mean"] for c in ck),
              f"{name}: --eval-mean differs between ranks")
        rec["checkpoint"] = ck
    return rec


# ---------------------------------------------------------------------------
# The model axis: a node split over K GPUs (tensor_parallel)
# ---------------------------------------------------------------------------

# 2 nodes of TP_K GPUs each on 4 GPUs (launch/mesh.py model_parallel)
TP_K = 2
TP_NODES = 2
TP_ARCH = "gemma3-4b"
TP_STEPS = 2
# a local step's batch: the reference's `multi` node batch (256 // (32
# nodes x H 2) = 4 sequences of 4096). Its `single` batch of 8 does not
# fit: the dry run at --model-parallel 2 --quantize predicts 87,940,234,303
# B a GPU (q8's comm copy included) against the H100's 79.18 GiB
TP_BATCH = 4
# the reduced card-vs-CPU cases: gemma3-4b (sliding window, QK-norm, kv
# heads split with the q heads) with the MLP's row-parallel all-reduce
# dropped as its planted fault; paligemma-3b (one kv head: wk / wv whole
# on both GPUs) with the kv weights' gradient sum dropped
TP_REDUCED = {"gemma3-4b": "mlp_reduce_dropped",
              "paligemma-3b": "kv_grad_sum_dropped"}
# name: (transport, q8, mode) of the reduced 2 x 2 supersteps
TP_SWARM = {"gather_exact": ("gather", False, "blocking"),
            "gather_q8": ("gather", True, "blocking"),
            "ppermute_q8": ("ppermute", True, "blocking"),
            "gather_nonblocking_q8": ("gather", True, "nonblocking"),
            "gather_overlap_q8": ("gather", True, "overlap"),
            "ppermute_overlap_exact": ("ppermute", False, "overlap"),
            "gather_legacy_q8": ("gather_legacy", True, "blocking")}
# the MoE archs on the model axis (models/moe.py `expert_ffn`):
# granite-moe-3b-a800m cuts each expert's d_ff, qwen3-moe-30b-a3b its
# experts. Their reduced cases restore the arch's expert axis and
# capacity factor (`reduced` sets None and 4.0: qwen3 would run granite's
# layout, and no choice would drop), each with its planted fault
TP_MOE_REDUCED = {"granite-moe-3b-a800m": "expert_reduce_dropped",
                  "qwen3-moe-30b-a3b": "copy_on_the_layer_input"}
# name: (arch, transport, q8, mode, supersteps) of every reduced 2 x 2
# superstep run: TP_SWARM's on TP_ARCH, then one blocking gather
# superstep of each MoE arch, exact and q8
TP_SWARM_RUNS = {**{n: (TP_ARCH, i, q, m, 2)
                    for n, (i, q, m) in TP_SWARM.items()},
                 **{f"{a}/gather_{'q8' if q else 'exact'}":
                    (a, "gather", q, "blocking", 1)
                    for a in TP_MOE_REDUCED for q in (False, True)}}
# the MoE archs' full-width runs (blocking gather q8, H 2, TP_STEPS
# supersteps, remat on), each at the first (layers, batch) the dry run
# at --model-parallel 2 predicts fits one H100: granite at its full depth
# (None), `single`'s batch of 8 or else `multi`'s 4; qwen3 at `multi`'s
# 4, cut to 8 layers or else 4 (its 48 hold 682 GiB a GPU at K 1)
TP_MOE_FULL = {"granite-moe-3b-a800m": [(None, 8), (None, 4)],
               "qwen3-moe-30b-a3b": [(8, 4), (4, 4)]}
# the full-width runs: the blocking one and the paper's headline
# combination, non-blocking with the pipelined exchange and q8
TP_FULL_MODES = ("blocking", "overlap")
# launches a rank makes in TP_STEPS supersteps of H = 2 (the overlapped
# run's build encodes its prologue's payload)
TP_FULL_LAUNCHES = {
    "blocking": {"sgd_update": 2 * TP_STEPS, "quantize_mod": TP_STEPS,
                 "decode_avg": TP_STEPS},
    "overlap": {"sgd_update": 2 * TP_STEPS, "quantize_mod": TP_STEPS + 1,
                "decode_avg": TP_STEPS}}
# card vs CPU at fp32, relative to a leaf's scale above 1 (the model
# tests' bound); the exact supersteps the codecs' 2e-5
TP_ATOL, TP_STEP_ATOL = 1e-5, 2e-5
TP_DIR = os.path.join(ROOT, "build", "chip_smoke_tensor_parallel")


def _tp_reduced(arch):
    """`arch` at the reduced size (d_model 64, 2 layers, remat on); a
    MoE arch with its own expert axis and capacity factor restored."""
    import dataclasses
    from repro_torch.configs import get_config, reduced
    cfg = dataclasses.replace(reduced(get_config(arch), n_layers=2,
                                      d_model=64), remat=True)
    if cfg.moe is None:
        return cfg
    own = get_config(arch).moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, expert_shard_axis=own.expert_shard_axis,
        capacity_factor=own.capacity_factor))


def _tp_mlp_without_reduce(cfg, p, x, tp=None):
    """Planted fault: the MLP's output left as each GPU's partial sum."""
    import torch
    from repro_torch.models import layers as L
    x = L.copy_to_model(x, tp)
    h = torch.matmul(x, p["w_up"])
    h = L.activation(cfg, torch.matmul(x, p["w_gate"])) * h \
        if cfg.gated_mlp else L.activation(cfg, h)
    return torch.matmul(h, p["w_down"])


def _tp_kv_without_sum(cfg, p, tp):
    """Planted fault: a whole kv weight's columns taken without the sum of
    its partial gradients over the node's GPUs."""
    hd = cfg.resolved_head_dim
    if tp is None or p["wk"].shape[-1] != cfg.n_kv_heads * hd:
        return p["wk"], p["wv"]
    nh = cfg.n_heads // tp.size
    lo = (tp.index * nh) // (cfg.n_heads // cfg.n_kv_heads)
    return tuple(p[k][..., lo * hd:(lo + 1) * hd] for k in ("wk", "wv"))


def _tp_ffn_without_reduce(cfg, p, buf, tp=None):
    """Planted fault: the expert FFN's d_ff slices' partial outputs left
    unsummed (in place of ``models/moe.py`` ``expert_ffn``)."""
    from repro_torch.models import moe
    return moe._ffn(cfg, p, moe.copy_to_model(buf, tp))


def _tp_plant(fault) -> "_planted":
    """A context planting `fault` in ``models/transformer.py`` or
    ``models/moe.py`` (None: nothing). ``copy_on_the_layer_input`` moves
    the MoE layer's ``copy_to_model`` from the dispatched buffer to the
    layer's input, so the router path's whole gradient is summed K
    times."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    apply0 = moe.apply_moe

    def apply_copied(cfg, p, x, **kw):
        return apply0(cfg, p, L.copy_to_model(x, kw.get("tp")), **kw)
    return _planted(*{
        "mlp_reduce_dropped": [(T, "apply_mlp", _tp_mlp_without_reduce)],
        "kv_grad_sum_dropped": [(T, "_local_kv", _tp_kv_without_sum)],
        "expert_reduce_dropped": [(moe, "expert_ffn",
                                   _tp_ffn_without_reduce)],
        "copy_on_the_layer_input": [(moe, "apply_moe", apply_copied),
                                    (moe, "copy_to_model",
                                     lambda x, tp: x)],
        None: []}[fault])


def _tp_routes(cfg, params, tokens, mesh):
    """The routing of one train forward of the rank's slices `params`
    (node-stacked [1, ...]) on `tokens` [B, S]: each MoE layer's choices
    (on the host), whether they are bitwise the same on the node's GPUs,
    and the choices dropped by capacity."""
    import torch
    from repro_torch.core import bucket as B
    from repro_torch.tree import tree_map
    drops = []
    with torch.no_grad():
        idx = _route_choices(cfg, tree_map(lambda x: x[0], params), tokens,
                             mesh.model_shard, drops)
    every = [B.all_gather_model(x.to(mesh.device).unsqueeze(0), mesh, 0)
             for x in idx]
    same = all(torch.equal(e[0], y) for e in every for y in e[1:])
    return idx, same, drops


def _route_flips(got, want) -> list:
    """Each layer's count of (token, choice) entries whose expert
    differs."""
    return [int((a != b).sum()) for a, b in zip(got, want)]


def _tp_grads(cfg, params, batch, tp):
    """(losses, gradient leaves) through the engine's ``node_grads_fn``."""
    from repro_torch.core.exchange import node_grads_fn
    from repro_torch.models import TransformerLM
    from repro_torch.tree import tree_leaves
    g, losses = node_grads_fn(TransformerLM(cfg, tp=tp).functional_loss)(
        params, batch)
    return losses, tree_leaves(g)


def _tp_err(got, want) -> float:
    """The largest |got - want| over the leaves, each over its leaf's
    scale above 1 (on the CPU)."""
    return max(float((g.detach().cpu().double() - w.double()).abs().max()) /
               max(1.0, float(w.abs().max())) for g, w in zip(got, want))


def _tp_whole_same(leaves, split, mesh) -> bool:
    """Every whole leaf (split None) bitwise the same on the node's GPUs."""
    from repro_torch.core import bucket as B
    for x, d in zip(leaves, split):
        if d is None:
            every = B.all_gather_model(x.detach().unsqueeze(0), mesh, 0)
            if not all(same_bits(every[0], y) for y in every[1:]):
                return False
    return True


def _tp_argv(impl, q8, batch, seq, steps, device, arch=TP_ARCH,
             mode="blocking"):
    argv = ["--arch", arch, "--nodes", str(TP_NODES), "--H", "2",
            "--steps", str(steps), "--batch", str(batch), "--seq", str(seq),
            "--device", device, "--gossip-impl", impl, "--seed", "0"]
    return argv + (["--quantize"] if q8 else []) + _tp_mode_flags(mode)


def _tp_mode_flags(mode) -> list:
    return {"blocking": [], "nonblocking": ["--nonblocking"],
            "overlap": ["--nonblocking", "--overlap"]}[mode]


def _tp_reference_rank(rank, world, port, out_dir, device):
    """A rank of the reduced card-vs-CPU check: each TP_REDUCED and
    TP_MOE_REDUCED model's loss and gradients on the rank's GPU (its
    slices) against the CPU's one-GPU port on the same weights, with and
    without the case's planted fault, and a MoE model's routing (the same
    on the node's GPUs, its flips against the CPU, its drops); then each
    TP_SWARM_RUNS command on the 2 x 2 mesh against the CPU's one-GPU
    2-node run of its flags (exact), and the q8 encodes bitwise their
    plain version (the kernel's on the flat transport; a per-leaf
    oracle's leaf by leaf). An overlapped command re-primes its pipeline
    from the CPU's weights."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.kernels import ref as R
    from repro_torch.launch import train
    from repro_torch.models import param_split
    from repro_torch.models import init_params
    from repro_torch.models.convert import shard_params
    from repro_torch.core import exchange as E
    from repro_torch.core.swarm import SwarmState, pipeline_prologue
    from repro_torch.quant.codecs import LatticeCodec
    from repro_torch.quant.schemes import _blocked
    from repro_torch.tree import (tree_flatten, tree_leaves, tree_map,
                                  tree_unflatten)
    mesh = _ms_mesh(rank, world, port, device, TP_K)
    dev = mesh.device
    rec = {"node": mesh.rank, "index": mesh.model_index}
    for arch, fault in {**TP_REDUCED, **TP_MOE_REDUCED}.items():
        _ms_progress(mesh, f"tp reference {arch}")
        cfg = _tp_reduced(arch)
        split = tree_leaves(param_split(cfg, TP_K))
        whole = tree_map(lambda x: x[None], init_params(
            torch.Generator().manual_seed(0), cfg, "cpu"))
        rng = np.random.default_rng(0)
        batch = {k: torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (1, 4, 64)).astype(np.int32))
            for k in ("tokens", "targets")}
        l_cpu, g_cpu = _tp_grads(cfg, whole, batch, None)
        want = tree_leaves(shard_params(
            tree_unflatten(tree_flatten(whole)[1], g_cpu), cfg, TP_K,
            mesh.model_index, stacked=True))
        mine = tree_map(lambda x: x.to(dev), shard_params(
            whole, cfg, TP_K, mesh.model_index, stacked=True))
        bdev = {k: v.to(dev) for k, v in batch.items()}
        for f in (None, fault):
            with _tp_plant(f):
                loss, g = _tp_grads(cfg, mine, bdev, mesh.model_shard)
            rec[f"{arch}/{f or 'clean'}"] = {
                "loss_err": abs(float(loss[0]) - float(l_cpu[0])) /
                max(1.0, abs(float(l_cpu[0]))),
                "grad_err": _tp_err(g, want),
                "whole_same": _tp_whole_same(g, split, mesh)}
            del g
        if cfg.moe is not None:
            # the routing on the card's slices against the CPU's one-GPU
            # port on the same weights and tokens
            idx, same, drops = _tp_routes(cfg, mine, bdev["tokens"][0],
                                          mesh)
            with torch.no_grad():
                want_idx = _route_choices(cfg, tree_map(
                    lambda x: x[0], whole), batch["tokens"][0])
            rec[f"{arch}/routing"] = {
                "same_on_node": same, "drops": drops,
                "flips_vs_cpu": sum(_route_flips(idx, want_idx))}
    enc = []
    encode0 = LatticeCodec.encode

    def encode(codec, buf, prev_buf, rng, **kw):
        state = rng.get_state().clone()
        wire = encode0(codec, buf, prev_buf, rng, **kw)
        g = torch.Generator(device=buf.device)
        g.set_state(state)
        u = torch.rand(buf.shape, generator=g, dtype=torch.float32,
                       device=buf.device)
        qc = codec.quant
        q, s = R.quantize_mod(buf.reshape(-1, qc.block),
                              prev_buf.reshape(-1, qc.block),
                              u.reshape(-1, qc.block), safety=qc.safety,
                              min_scale=qc.min_scale, bits=qc.bits)
        enc.append(same_bits(q.reshape(wire[0].shape), wire[0]) and
                   same_bits(s.reshape(wire[1].shape), wire[1]))
        return wire
    leaf_encode0 = E.encode_modular

    def leaf_encode(qc, x, ref, rng=None, *, u=None, lead=0):
        def blocks(v):
            return _blocked(v.to(torch.float32), qc.block,
                            lead)[0].reshape(-1, qc.block)
        if u is None:               # the draw encode_modular makes
            u = torch.rand(_blocked(x, qc.block, lead)[0].shape,
                           generator=rng, dtype=torch.float32,
                           device=x.device)
        q, s = leaf_encode0(qc, x, ref, None, u=u, lead=lead)
        pq, ps = R.quantize_mod(blocks(x), blocks(ref),
                                u.reshape(-1, qc.block), safety=qc.safety,
                                min_scale=qc.min_scale, bits=qc.bits)
        enc.append(same_bits(pq.reshape(q.shape), q) and
                   same_bits(ps.reshape(s.shape), s))
        return q, s
    for name, (arch, impl, q8, mode, steps) in TP_SWARM_RUNS.items():
        _ms_progress(mesh, f"tp reference {name}")
        cfg = _tp_reduced(arch)
        split = tree_leaves(param_split(cfg, TP_K))
        argv = _tp_argv(impl, q8, 2, 64, steps, "cpu", arch, mode)
        one = train.build(train.build_parser().parse_args(argv), cfg)
        args = train.build_parser().parse_args(
            _tp_argv(impl, q8, 2, 64, steps, device, arch, mode))
        LatticeCodec.encode, E.encode_modular = encode, leaf_encode
        try:
            tr = train.build(args, cfg, mesh=mesh)
            # the card's generator draws other weights: start from the
            # CPU's, this rank's slices of its node
            tr.state = dataclasses.replace(tr.state, **{
                k: tree_map(lambda x: x.to(dev), shard_params(
                    tree_map(lambda x: x[mesh.rank:mesh.rank + 1], v), cfg,
                    TP_K, mesh.model_index, stacked=True))
                for k, v in (("params", one.state.params),
                             ("prev", one.state.prev)) if v is not None})
            if tr.scfg.overlap:
                st = tr.state
                tr.state = pipeline_prologue(
                    tr.scfg, SwarmState(st.params, st.opt, None, 0),
                    mesh.fold_generator(tr.enc_gen))
            errs, same, losses = [], [], []
            for t in range(steps):
                m = tr.superstep(t)
                one.superstep(t)
                mine = tree_leaves(tr.state.params)
                want = tree_leaves(shard_params(
                    tree_map(lambda x: x[mesh.rank:mesh.rank + 1],
                             one.state.params), cfg, TP_K, mesh.model_index,
                    stacked=True))
                errs.append(_tp_err(mine, want))
                same.append(_tp_whole_same(mine, split, mesh))
                losses.append(float(m["loss"]))
        finally:
            LatticeCodec.encode, E.encode_modular = encode0, leaf_encode0
        rec[name] = {"errs": errs, "whole_same": same, "losses": losses,
                     "encodes_bitwise": list(enc)}
        enc.clear()
        del tr, one
    mesh.close()
    with open(os.path.join(out_dir, f"tp_reference_rank{rank}.json"),
              "w") as f:
        json.dump(rec, f)


def _tp_full_cfg(cfg_name, arch=TP_ARCH, layers=None):
    """`arch`'s full-width config, its depth cut to `layers` where given
    (`cfg_name` "reduced": a small stand-in with remat on, for a CPU
    rehearsal)."""
    import dataclasses
    from repro_torch.configs import get_config
    if cfg_name is not None:
        return _tp_reduced(arch)
    cfg = get_config(arch)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def _tp_full_routing(cfg, tr, mesh) -> dict:
    """The routing of the first local step's forward on the rank's slices
    (before any step): whether it is bitwise the same on the node's GPUs,
    its drops, and its flips against the one-GPU port's forward of the
    whole node, every split leaf all-gathered over the model group."""
    import torch
    from repro_torch.core import bucket as B
    from repro_torch.models import param_split
    from repro_torch.tree import tree_flatten, tree_leaves, tree_unflatten
    tokens = tr.batch(0)["tokens"][0, 0]
    idx, same, drops = _tp_routes(cfg, tr.state.params, tokens, mesh)
    leaves, treedef = tree_flatten(tr.state.params)
    whole = tree_unflatten(treedef, [
        x[0] if d is None else B.all_gather_model(x[0], mesh, d)
        for x, d in zip(leaves, tree_leaves(param_split(cfg, TP_K)))])
    with torch.no_grad():
        want = _route_choices(cfg, whole, tokens)
    del whole
    flips = _route_flips(idx, want)
    return {"same_on_node": same, "drops_by_layer": drops,
            "choices": sum(x.numel() for x in idx),
            "flips_vs_one_gpu": sum(flips), "flips_by_layer": flips}


def _tp_full_rank(rank, world, port, cfg_name, batch, seq, out_dir,
                  device, mode="blocking", arch=TP_ARCH, layers=None):
    """A rank of a full-width run: its slices of its node of `arch` (cut
    to `layers`), TP_STEPS supersteps of gather q8 in `mode` (blocking, or
    non-blocking with the pipelined exchange: ``overlap``) through
    ``launch/train.py`` ``build(args, cfg, mesh=)``; writes its losses,
    superstep times, launches, peak allocated above what was live before
    the run was built, the model group's all-reduces and all-gathers
    (count, bytes, time on the current stream) and whether its whole
    leaves match the node's other GPU. A MoE arch's first local step is
    routed once before the run (`_tp_full_routing`), its memory freed
    before the peak is reset."""
    import gc
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch import train
    from repro_torch.models import layers as L
    from repro_torch.tree import tree_leaves
    mesh = _ms_mesh(rank, world, port, device, TP_K)
    dev = mesh.device
    cuda = dev.type == "cuda"
    cfg = _tp_full_cfg(cfg_name, arch, layers)
    _ms_progress(mesh, f"tp full width {arch} {mode} build")
    gc.collect()
    _sync(dev)
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    start = torch.cuda.memory_allocated(dev) if cuda else 0
    # the allocator's retries (free the cache and allocate again) near the
    # card's capacity, each behind a device sync
    retries0 = torch.cuda.memory_stats(dev).get("num_alloc_retries", 0) \
        if cuda else 0
    reset_launch_counts()
    args = train.build_parser().parse_args(
        _tp_argv("gather", True, batch, seq, TP_STEPS, device, arch, mode))
    tr = train.build(args, cfg, mesh=mesh)
    routing = None
    if cfg.moe is not None:
        _ms_progress(mesh, f"tp full width {arch} routing")
        routing = _tp_full_routing(cfg, tr, mesh)
        gc.collect()
        _sync(dev)
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
    events = {"reduce": [], "gather": []}
    reduce0, gather0 = L._all_reduce, L._all_gather

    def timed(kind, fn):
        def run(*a, **kw):
            if not cuda:
                return fn(*a, **kw)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            y = fn(*a, **kw)
            e1.record()
            events[kind].append((e0, e1))
            return y
        return run
    L._all_reduce, L._all_gather = timed("reduce", reduce0), \
        timed("gather", gather0)
    L.COLLECTIVES = {}
    losses, secs, ms = [], [], {"reduce": [], "gather": []}
    try:
        for t in range(TP_STEPS):
            _ms_progress(mesh, f"tp {arch} {mode} superstep {t}")
            L.dist.barrier()
            _sync(dev)
            t0 = time.perf_counter()
            m = tr.superstep(t)
            losses.append(float(m["loss"]))
            _sync(dev)
            secs.append(time.perf_counter() - t0)
            for kind, ev in events.items():
                ms[kind].append(sum(a.elapsed_time(b) for a, b in ev))
                ev.clear()
        coll = dict(L.COLLECTIVES)
    finally:
        L._all_reduce, L._all_gather = reduce0, gather0
        L.COLLECTIVES = None
    peak = torch.cuda.max_memory_allocated(dev) - start if cuda else None
    retries = torch.cuda.memory_stats(dev).get("num_alloc_retries", 0) - \
        retries0 if cuda else None
    launches = dict(LAUNCHES)
    from repro_torch.models import param_split
    same = _tp_whole_same(tree_leaves(tr.state.params),
                          tree_leaves(param_split(cfg, TP_K)), mesh)
    rec = {"node": mesh.rank, "index": mesh.model_index, "losses": losses,
           "superstep_s": secs, "allreduce_ms": ms["reduce"],
           "allreduce_calls": coll.get("calls", 0) // TP_STEPS,
           "allreduce_bytes": coll.get("bytes", 0) // TP_STEPS,
           "allgather_ms": ms["gather"],
           "allgather_calls": coll.get("gather_calls", 0) // TP_STEPS,
           "allgather_bytes": coll.get("gather_bytes", 0) // TP_STEPS,
           "launches": launches, "start_bytes": start,
           "peak_above_start_bytes": peak, "alloc_retries": retries,
           "whole_same": same, "routing": routing,
           "params_per_gpu": sum(x.numel() for x in
                                 tree_leaves(tr.state.params))}
    del tr
    mesh.close()
    with open(os.path.join(out_dir, f"{_tp_full_prefix(mode, arch)}_rank"
                           f"{rank}.json"), "w") as f:
        json.dump(rec, f)


def _tp_full_prefix(mode, arch=TP_ARCH) -> str:
    if arch != TP_ARCH:
        return f"tp_full_{arch.split('-')[0]}"
    return "tp_full" if mode == "blocking" else f"tp_full_{mode}"


def _tp_name(mode, arch=TP_ARCH) -> str:
    """A full-width run's phase line and path name."""
    if arch != TP_ARCH:
        return f"tensor_parallel_{arch.split('-')[0]}"
    return "tensor_parallel" if mode == "blocking" \
        else f"tensor_parallel_{mode}"


def _tp_read(prefix, world) -> list:
    out = []
    for r in range(world):
        with open(os.path.join(TP_DIR, f"{prefix}_rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def _tp_dryrun_flags(batch, seq, mode="blocking", layers=None):
    return ["--shape", "train_4k", "--nodes", str(TP_NODES),
            "--model-parallel", str(TP_K), "--batch", str(batch), "--seq",
            str(seq), "--quantize"] + _tp_mode_flags(mode) + \
        (["--layers", str(layers)] if layers else [])


def phase_tensor_parallel(world: int, device: str = "cuda",
                          cfg_name=None) -> dict:
    """`tensor_parallel` on 4 GPUs, 2 nodes x TP_K: the reduced card-vs-CPU
    check (`_tp_reference_rank`: losses and gradients within TP_ATOL of the
    CPU's one-GPU port, whole leaves' gradients bitwise equal on a node's
    GPUs, each planted fault failing, for TP_ARCH and the dense cases and
    the MoE archs, whose routing is bitwise the same on a node's GPUs
    with 0 flips against the CPU and drops choices; the 2 x 2 supersteps
    of every TP_SWARM_RUNS command (blocking, non-blocking, overlapped,
    the per-leaf oracle, the MoE archs): exact within TP_STEP_ATOL of the
    CPU's one-GPU run, q8 whole leaves equal and its encodes bitwise the
    plain encode), then TP_ARCH `train_4k` at full width and depth
    (`_tp_full_rank`) in each of TP_FULL_MODES, each traced by the dry run
    at --model-parallel 2 with its own flags on fake CUDA and CPU tensors
    (the counted fields equal) at TP_BATCH, or at 2 where the dry run
    predicts TP_BATCH misses the card, then each TP_MOE_FULL arch at full
    width, blocking, at its first (layers, batch) the dry run predicts
    fits: finite losses, the same on every rank; each rank's launches
    TP_FULL_LAUNCHES; each rank's peak above its start within
    DRYRUN_BOUND of the prediction; whole leaves bitwise equal on each
    node's GPUs; a MoE arch's first local step routed bitwise the same on
    a node's GPUs (its flips against the one-GPU port's forward counted).
    Prints a line a run. -> {path: rank 0's launches}."""
    os.makedirs(TP_DIR, exist_ok=True)
    cuda = device == "cuda" and cfg_name is None
    t0 = time.time()
    seq = 4096 if cfg_name is None else 64
    procs = moe_procs = None
    if cuda:
        procs = _dryrun_start({m: _tp_dryrun_flags(TP_BATCH, seq, m)
                               for m in TP_FULL_MODES}, ("cuda", "cpu"),
                              arch=TP_ARCH)
        moe_procs = {}
        for arch, tries in TP_MOE_FULL.items():
            moe_procs.update(_dryrun_start(
                {(arch, lb): _tp_dryrun_flags(lb[1], seq, layers=lb[0])
                 for lb in tries}, ("cuda", "cpu"), arch=arch))
    _ms_spawn(_tp_reference_rank, world, TP_DIR, device)
    ref = _tp_read("tp_reference", world)
    placed = [(p["node"], p["index"]) for p in ref]
    check(placed == [divmod(r, TP_K) for r in range(world)],
          f"tensor_parallel: ranks placed {placed}")
    for r, p in enumerate(ref):
        for arch, fault in {**TP_REDUCED, **TP_MOE_REDUCED}.items():
            c, f = p[f"{arch}/clean"], p[f"{arch}/{fault}"]
            check(c["loss_err"] <= TP_ATOL and c["grad_err"] <= TP_ATOL and
                  c["whole_same"], f"tensor_parallel: rank {r} {arch} {c}")
            check(not (f["loss_err"] <= TP_ATOL and f["grad_err"] <= TP_ATOL
                       and f["whole_same"]),
                  f"tensor_parallel: planted fault {fault} passed {f}")
        for arch in TP_MOE_REDUCED:
            c = p[f"{arch}/routing"]
            check(c["same_on_node"] and c["flips_vs_cpu"] == 0 and
                  sum(c["drops"]) > 0,
                  f"tensor_parallel: rank {r} {arch} routing {c}")
        for name, (_, _, q8, _, _) in TP_SWARM_RUNS.items():
            c = p[name]
            check(all(c["whole_same"]) and all(math.isfinite(x)
                                               for x in c["losses"]),
                  f"tensor_parallel: rank {r} {name} {c}")
            if q8:
                check(c["encodes_bitwise"] and all(c["encodes_bitwise"]),
                      f"tensor_parallel: rank {r} {name} encodes "
                      f"{c['encodes_bitwise']}")
            else:
                check(max(c["errs"]) <= TP_STEP_ATOL,
                      f"tensor_parallel: rank {r} {name} card vs CPU "
                      f"{c['errs']}")
    reference = {"seconds": time.time() - t0, **{
        k: [p[k] for p in ref] for k in ref[0] if k not in ("node",
                                                            "index")}}
    dry = {}
    if cuda:
        recs = _dryrun_jobs(None, None, procs)
        for mode in TP_FULL_MODES:
            _tp_check_dry(recs[mode, "cuda"], recs[mode, "cpu"])
            dry[mode] = (TP_BATCH, recs[mode, "cuda"])
            if not dry[mode][1]["fits"]:
                # the dry run says TP_BATCH misses the card: the next batch
                again = _dryrun_jobs({mode: _tp_dryrun_flags(2, seq, mode)},
                                     ("cuda", "cpu"), arch=TP_ARCH)
                _tp_check_dry(again[mode, "cuda"], again[mode, "cpu"])
                dry[mode] = (2, again[mode, "cuda"])
            check(dry[mode][1]["fits"], f"tensor_parallel: {mode} "
                  f"predicted at {dry[mode][1]['peak_bytes']} B a GPU at "
                  f"batch {dry[mode][0]}, beyond one H100")
    by_path = {}
    for mode in TP_FULL_MODES:
        batch = dry[mode][0] if cuda else \
            (2 if cfg_name is not None else TP_BATCH)
        by_path[_tp_name(mode)] = _tp_full(
            world, device, cfg_name, batch, seq, mode,
            dry.get(mode, (None, None))[1],
            reference if mode == "blocking" else None)
    if cuda:
        moe_recs = _dryrun_jobs(None, None, moe_procs)
    for arch, tries in TP_MOE_FULL.items():
        layers, batch, rec = None, 2, None
        if cuda:
            for lb in tries:
                _tp_check_dry(moe_recs[(arch, lb), "cuda"],
                              moe_recs[(arch, lb), "cpu"])
            (layers, batch), rec = next(
                ((lb, moe_recs[(arch, lb), "cuda"]) for lb in tries
                 if moe_recs[(arch, lb), "cuda"]["fits"]),
                (tries[-1], moe_recs[(arch, tries[-1]), "cuda"]))
            check(rec["fits"], f"tensor_parallel: {arch} predicted at "
                  f"{rec['peak_bytes']} B a GPU at {tries[-1]}, beyond one "
                  "H100")
        by_path[_tp_name("blocking", arch)] = _tp_full(
            world, device, cfg_name, batch, seq, "blocking", rec, None,
            arch, layers,
            {f"layers {lb[0] or 'all'}, batch {lb[1]}":
             moe_recs[(arch, lb), "cuda"]["peak_bytes"]
             for lb in tries} if cuda else None)
    return by_path


def _tp_full(world, device, cfg_name, batch, seq, mode, dry,
             reference, arch=TP_ARCH, layers=None, tried=None) -> dict:
    """One full-width run of `arch` (cut to `layers`) in `mode` on the
    mesh, its checks and its line (`tried`: the dry run's predicted peak
    of each (layers, batch) it weighed); -> rank 0's launches."""
    t1 = time.time()
    _ms_spawn(_tp_full_rank, world, cfg_name, batch, seq, TP_DIR, device,
              mode, arch, layers)
    name = _tp_name(mode, arch)
    full = _tp_read(_tp_full_prefix(mode, arch), world)
    losses = [p["losses"] for p in full]
    check(all(math.isfinite(x) for x in losses[0]) and
          all(x == losses[0] for x in losses),
          f"{name}: losses not finite or not the same on every rank "
          f"{losses}")
    check(all(p["whole_same"] for p in full),
          f"{name}: whole leaves differ across a node's GPUs")
    cfg = _tp_full_cfg(cfg_name, arch, layers)
    if cfg.moe is not None:
        check(all(p["routing"]["same_on_node"] for p in full),
              f"{name}: routing differs across a node's GPUs")
    want = TP_FULL_LAUNCHES[mode]
    if device == "cuda":
        for r, p in enumerate(full):
            check(p["launches"] == want, f"{name}: rank {r} launches "
                  f"{p['launches']} != {want}")
    out = {"arch": arch if cfg_name is None else f"{arch} (reduced)",
           "n_layers": cfg.n_layers, "nodes": TP_NODES,
           "model_parallel": TP_K, "mode": mode,
           "flags": _tp_mode_flags(mode) + ["--quantize"],
           "batch_per_node": batch, "seq": seq, "H": 2,
           "remat": cfg.remat, "full_width_seconds": time.time() - t1,
           "losses": losses[0], "launches_want": want,
           **{k: [p[k] for p in full] for k in (
               "superstep_s", "allreduce_ms", "allreduce_calls",
               "allreduce_bytes", "allgather_ms", "allgather_calls",
               "allgather_bytes", "peak_above_start_bytes", "start_bytes",
               "alloc_retries", "params_per_gpu", "launches",
               "whole_same", "routing")}}
    if tried is not None:
        out["dryrun_tried_peak_bytes"] = tried
    if reference is not None:
        out["reference"] = reference
    if dry is not None:
        ratios = [p["peak_above_start_bytes"] / dry["peak_bytes"]
                  for p in full]
        out["dryrun"] = {
            "predicted_bytes": dry["peak_bytes"],
            "measured_over_predicted_by_rank": ratios,
            **{k: dry.get(k) for k in (
                "fits", "argument_bytes", "temp_bytes", "flops_per_dev",
                "coll_raw", "model_allreduce_bytes_per_dev",
                "model_allreduce_calls", "model_allgather_bytes_per_dev",
                "model_allgather_calls", "wire_bytes_per_node", "compute_s",
                "memory_s", "collective_s", "bottleneck", "t_trace_s")}}
    log(name, ranks=world, **out)
    if dry is not None:
        lo, hi = DRYRUN_BOUND
        check(all(lo <= r <= hi for r in ratios),
              f"{name}: measured over predicted {ratios} outside "
              f"{DRYRUN_BOUND}")
    return full[0]["launches"]


def _tp_check_dry(cuda_rec, cpu_rec) -> None:
    differ = [k for k in DRYRUN_COUNTED if cuda_rec.get(k) != cpu_rec.get(k)]
    check(not differ, f"tensor_parallel dry run: cuda and cpu records "
          f"differ in {differ}")
    check(_fake_touch_ok(cuda_rec), f"tensor_parallel dry run allocated "
          f"{cuda_rec['device_allocated_bytes']} B at its peak, "
          f"{cuda_rec['device_allocated_after_bytes']} B at its end")


# ---------------------------------------------------------------------------
# tensor_parallel_serve: serving on a node split over K GPUs (4 cards)
# ---------------------------------------------------------------------------

TPS_K, TPS_NODES = 2, 2
TPS_DIR = os.path.join(ROOT, "build", "chip_smoke_tp_serve")
# the reduced card-vs-CPU archs (fp32, d_model 64): gemma3-4b at 6 layers
# with a window of 8 (one global layer; the rings wrap), the MoE archs
# with their own expert axes restored
TPS_ARCHS = ("olmo-1b", "gemma3-4b", "granite-moe-3b-a800m",
             "qwen3-moe-30b-a3b")
# planted faults of the reduced check: name -> the arch it is planted in
TPS_FAULTS = {"next_kv_heads": "olmo-1b", "argmax_no_gather": "gemma3-4b",
              "decode_reduce_dropped": "olmo-1b",
              "late_admission": "olmo-1b"}
TPS_ENGINE_MODES = (("dense", {}), ("paged", dict(paged=True, page_size=4)),
                    ("chunked", dict(prefill_chunk=4)))
# the full-width runs: decode_32k's cache of 32,768 rows; the reference's
# batch for a node group (128 sequences over `single`'s 16 nodes), filled
# by a prefill of a prompt 1,024 rows short of the cache (a multiple of
# the attention's 1,024-row chunks), then TPS_DECODE_STEPS greedy steps
TPS_CACHE, TPS_BATCH, TPS_DECODE_STEPS = 32768, 8, 16
TPS_FULL_ARCH, TPS_MOE_ARCH = "olmo-1b", "qwen3-moe-30b-a3b"
# the engine at full width: 8 slots, 16 requests of 512 + 64 tokens
TPS_ENGINE_RUNS = (("dense", {}), ("chunked", dict(prefill_chunk=128)),
                   ("paged_chunked", dict(paged=True, page_size=16,
                                          prefill_chunk=128)),
                   ("swap", {}))
TPS_SWAP_AFTER = 8
TPS_REQUESTS, TPS_PROMPT, TPS_NEW = 16, 512, 64
# qwen3's cache where decode_32k's misses the card: the longest power of
# two the dry run predicts fits
TPS_MOE_CACHES = (32768, 16384, 8192)
TPS_MOE_DECODE_STEPS = 8


def _tps_cfg(arch):
    """`arch` reduced (fp32, d_model 64, 2 layers; gemma3-4b 6 with a
    window of 8), a MoE arch with its own expert axis restored."""
    import dataclasses
    from repro_torch.configs import get_config, reduced
    full = get_config(arch)
    cfg = reduced(full, n_layers=6 if arch == "gemma3-4b" else 2,
                  d_model=64)
    if arch == "gemma3-4b":
        cfg = dataclasses.replace(cfg, sliding_window=8)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, expert_shard_axis=full.moe.expert_shard_axis))
    return cfg


def _tps_inputs(cfg):
    """Prompts [2, 8], six teacher-forced decode tokens and three ragged
    chunks of 4, from numpy; the engine's ragged prompts."""
    import numpy as np
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    steps = [rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int64)
             for _ in range(6)]
    chunks = [(rng.integers(0, cfg.vocab_size, (2, 4)).astype(np.int64), nv)
              for nv in ([4, 4], [4, 1], [2, 0])]
    ragged = [rng.integers(0, cfg.vocab_size, L).astype(np.int32)
              for L in SERVE_LENS]
    return prompts, steps, chunks, ragged


class _tps_routes:
    """Collect every MoE layer's routing choices in the body of a
    `with`."""

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.route0, self.idx = moe, moe.route, []

        def route(*a):
            out = self.route0(*a)
            self.idx.append(out[1].detach().cpu())
            return out
        moe.route = route
        return self.idx

    def __exit__(self, *exc):
        self.moe.route = self.route0


def _tps_plant(fault):
    """The patches of a planted forward fault (`_planted`): the argmax
    over a GPU's own vocab slice (no gather), or attention's all-reduce
    dropped in decode. The weights' fault (``next_kv_heads``) is planted
    in `_tps_slices`, the engine's in `_tps_late`."""
    from repro_torch.models import transformer as tf
    if fault == "argmax_no_gather":
        return _planted((tf, "gather_from_model", lambda x, tp: x))
    attn0, red0, skip = tf._attn_layer, tf.reduce_from_model, [False]

    def attn(cfg, p, x, positions, *, mode="train", **kw):
        skip[0] = mode == "decode"
        try:
            return attn0(cfg, p, x, positions, mode=mode, **kw)
        finally:
            skip[0] = False
    return _planted((tf, "_attn_layer", attn),
                    (tf, "reduce_from_model",
                     lambda x, tp: x if skip[0] else red0(x, tp)))


def _tps_slices(cfg, whole, K, index, dev, fault=""):
    """GPU `index`'s slices of the CPU's `whole` model on `dev`; with the
    fault ``next_kv_heads`` its wk / wv those of the next model index, so
    its cache holds the next GPU's kv heads."""
    from repro_torch.models.convert import shard_params
    from repro_torch.tree import tree_map
    mine = shard_params(whole, cfg, K, index)
    if fault == "next_kv_heads":
        nxt = shard_params(whole, cfg, K, (index + 1) % K)
        for layer, p in mine["blocks"].items():
            for k in ("wk", "wv"):
                p["attn"][k] = nxt["blocks"][layer]["attn"][k]
    return tree_map(lambda x: x.to(dev), mine)


def _tps_late(engine):
    """Planted fault: this GPU's engine admits its first request one step
    after its peers."""
    admit0, skipped = engine._admit, []

    def admit(now):
        if engine.queue and not skipped:
            skipped.append(now)
            return
        admit0(now)
    engine._admit = admit


def _tps_cpu_reference() -> dict:
    """The CPU's one-GPU port of every reduced arch: its weights, serving
    readings, routing, one-shot and engine tokens."""
    import argparse
    import torch
    from repro_torch.launch.serve import make_generators, run_oneshot
    from repro_torch.models import init_params
    ref = {}
    for arch in TPS_ARCHS:
        cfg = _tps_cfg(arch)
        params = init_params(torch.Generator().manual_seed(1), cfg, "cpu")
        prompts, steps, chunks, ragged = _tps_inputs(cfg)
        with torch.no_grad(), _tps_routes() as routes:
            readings = _serve_readings(cfg, params, "cpu", prompts, chunks,
                                       steps)
        args = argparse.Namespace(device="cpu", gen=8, temperature=0.0,
                                  batch=2, prompt_len=8)
        with torch.no_grad():
            one = run_oneshot(cfg, args, params, make_generators(0, "cpu"),
                              prompts=prompts)["tokens"].tolist()
            engines = {mode: _serve_engine_tokens(cfg, params, "cpu", ragged,
                                                  **kw)[0]
                       for mode, kw in TPS_ENGINE_MODES}
        ref[arch] = dict(params=params, readings=readings,
                         routes=list(routes), oneshot=one, engines=engines)
    return ref


def _tps_reduced_rank(rank, world, port, device):
    """A rank of the reduced check: every arch's serving readings, routing,
    one-shot and engine tokens on its slices, each planted fault; writes
    them for the parent to hold against the CPU's."""
    import argparse
    import torch
    from datetime import timedelta
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.launch.serve import make_generators, run_oneshot
    mesh = _ms_mesh(rank, world, port, device, TPS_K,
                    timeout=timedelta(seconds=120))
    dev, tp = mesh.device, mesh.model_shard
    ref = torch.load(os.path.join(TPS_DIR, "cpu.pt"), weights_only=False)
    reset_launch_counts()
    out = {"node": mesh.rank, "index": mesh.model_index}
    for arch in TPS_ARCHS:
        _ms_progress(mesh, f"tp serve reduced {arch}")
        cfg, whole = _tps_cfg(arch), ref[arch]["params"]
        prompts, steps, chunks, ragged = _tps_inputs(cfg)
        mine = _tps_slices(cfg, whole, TPS_K, mesh.model_index, dev)
        with torch.no_grad(), _tps_routes() as routes:
            readings = _serve_readings(cfg, mine, dev, prompts, chunks,
                                       steps, tp)
        args = argparse.Namespace(device=dev, gen=8, temperature=0.0,
                                  batch=2, prompt_len=8)
        with torch.no_grad():
            one = run_oneshot(cfg, args, mine, make_generators(0, dev),
                              prompts=prompts, mesh=mesh)["tokens"].tolist()
            engines = {mode: _serve_engine_tokens(cfg, mine, dev, ragged,
                                                  tp, **kw)
                       for mode, kw in TPS_ENGINE_MODES}
        out[arch] = dict(readings=readings, routes=list(routes), oneshot=one,
                         engines={m: (t, {k: s[k] for k in (
                             "decode_cache_misses", "prefill_cache_misses",
                             "completed", "kv_bytes")})
                             for m, (t, s) in engines.items()})
    for fault, arch in TPS_FAULTS.items():
        _ms_progress(mesh, f"tp serve planted {fault}")
        cfg = _tps_cfg(arch)
        prompts, steps, chunks, ragged = _tps_inputs(cfg)
        mine = _tps_slices(cfg, ref[arch]["params"], TPS_K,
                           mesh.model_index, dev, fault)
        if fault == "late_admission":
            from repro_torch.serve import EngineConfig, Request, ServeEngine
            eng = ServeEngine(cfg, EngineConfig(max_slots=2, prompt_len=8,
                                                max_new_tokens=8),
                              params=mine, device=dev, tp=tp)
            if mesh.model_index == 1:
                _tps_late(eng)
            for i, p in enumerate(ragged):
                eng.submit(Request(i, p))
            try:
                with torch.no_grad():
                    eng.drain(100)
                out[fault] = None
            except RuntimeError as e:
                out[fault] = str(e)[:300]
            continue
        plant = _tps_plant(fault) if fault != "next_kv_heads" \
            else _planted()
        with torch.no_grad(), plant:
            out[fault] = _serve_readings(cfg, mine, dev, prompts, chunks,
                                         steps, tp)
    out["launches"] = dict(LAUNCHES)
    torch.save(out, os.path.join(TPS_DIR, f"reduced_rank{rank}.pt"))
    mesh.close()


def _tps_reduced_checks(world, ref) -> dict:
    """The reduced check's verdicts (each rank against the CPU's one-GPU
    port) -> its line."""
    import torch
    res = [torch.load(os.path.join(TPS_DIR, f"reduced_rank{r}.pt"),
                      weights_only=False) for r in range(world)]
    placed = [(p["node"], p["index"]) for p in res]
    check(placed == [divmod(r, TPS_K) for r in range(world)],
          f"tensor_parallel_serve: ranks placed {placed}")
    line = {}
    for arch in TPS_ARCHS:
        want = ref[arch]
        errs, flips, same_routes = [], [], []
        for r, p in enumerate(res):
            got = p[arch]
            errs.append({k: float((got["readings"][k] - v).abs().max())
                         for k, v in want["readings"].items()
                         if not k.startswith("chunk_state")})
            flips.append(sum(int((a != b).sum()) for a, b in
                             zip(got["routes"], want["routes"])))
            same_routes.append(all(torch.equal(a, b) for a, b in zip(
                got["routes"], res[r - r % TPS_K][arch]["routes"])))
            check(all(v <= SERVE_BOUND for v in errs[-1].values()),
                  f"tensor_parallel_serve: rank {r} {arch} card vs CPU "
                  f"beyond {SERVE_BOUND}: {errs[-1]}")
            check(flips[-1] == 0 and same_routes[-1],
                  f"tensor_parallel_serve: rank {r} {arch} routing flips "
                  f"{flips[-1]}, same on its node {same_routes[-1]}")
            check(got["oneshot"] == want["oneshot"],
                  f"tensor_parallel_serve: rank {r} {arch} one-shot tokens")
            for mode, (toks, s) in got["engines"].items():
                check(toks == want["engines"][mode] and
                      s["decode_cache_misses"] == 0 and
                      s["prefill_cache_misses"] == 0,
                      f"tensor_parallel_serve: rank {r} {arch} {mode} "
                      f"engine tokens or signatures {s}")
        line[arch] = dict(max_abs=[max(e.values()) for e in errs],
                          routing_flips=flips,
                          kv_bytes={m: s["kv_bytes"] for m, (_, s) in
                                    res[0][arch]["engines"].items()})
    planted = {}
    for fault, arch in TPS_FAULTS.items():
        if fault == "late_admission":
            msgs = [p[fault] for p in res]
            check(all(m is not None and "out of step" in m for m in msgs),
                  f"tensor_parallel_serve: late admission did not fail by "
                  f"check: {msgs}")
            planted[fault] = msgs[0]
            continue
        worst = []
        for p in res:
            got, want = p[fault], ref[arch]["readings"]
            worst.append(max(
                float((got[k] - want[k]).abs().max())
                if got[k].shape == want[k].shape else math.inf
                for k in got))
        check(any(w > SERVE_BOUND for w in worst),
              f"tensor_parallel_serve: planted fault {fault} passed "
              f"{worst}")
        planted[fault] = worst
    launches = [p["launches"] for p in res]
    check(all(sum(c.values()) == 0 for c in launches),
          f"tensor_parallel_serve: serving launched kernels {launches}")
    line["planted"] = planted
    return line


def _tps_draw(cfg, K, seed, dev):
    """A GPU's slices of a model of random weights from `seed` (bf16,
    drawn in place a leaf at a time: a whole expert leaf in fp32 would not
    fit); the same seed on every GPU of a node gives the same whole
    leaves, so the routers agree."""
    import torch
    from repro_torch.models import shard_template
    from repro_torch.models.layers import ParamInfo
    from repro_torch.tree import tree_map
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dtype = getattr(torch, cfg.dtype)

    def make(info: ParamInfo):
        if info.init in ("zeros", "ones"):
            return torch.full(info.shape, float(info.init == "ones"),
                              dtype=dtype, device=dev)
        fan_in = info.shape[-2] if len(info.shape) >= 2 else info.shape[-1]
        scale = info.scale if info.scale is not None else fan_in ** -0.5
        w = torch.empty(info.shape, dtype=dtype, device=dev)
        return w.normal_(0.0, scale, generator=gen)
    return tree_map(make, shard_template(cfg, K))


def _tps_timed_collectives(dev):
    """Wrap the model group's all-reduces and all-gathers (``models/
    layers.py``) in CUDA events; -> (events by kind, undo)."""
    import torch
    from repro_torch.models import layers as L
    events = {"reduce": [], "gather": []}
    reduce0, gather0 = L._all_reduce, L._all_gather

    def timed(kind, fn):
        def run(*a, **kw):
            if dev.type != "cuda":
                return fn(*a, **kw)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            y = fn(*a, **kw)
            e1.record()
            events[kind].append((e0, e1))
            return y
        return run
    L._all_reduce, L._all_gather = timed("reduce", reduce0), \
        timed("gather", gather0)

    def undo():
        L._all_reduce, L._all_gather = reduce0, gather0
    return events, undo


def _tps_prompts(cfg, n, length, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (n, length)).astype(np.int32)


def _tps_install(bank, cache1, lane):
    """Copy a batch-1 prefill cache into lane `lane` of the batch cache
    `bank` (the engine's install: one prefix copy a leaf)."""
    from repro_torch.serve.engine import lane_axis
    from repro_torch.tree import tree_key_paths, tree_leaves
    for path, dst, src in zip(tree_key_paths(bank), tree_leaves(bank),
                              tree_leaves(cache1)):
        if path == ("len",):
            continue
        ax = lane_axis(path)
        dst = dst.select(ax, lane)
        dst[tuple(slice(0, s) for s in src.select(ax, 0).shape)].copy_(
            src.select(ax, 0))


def _tps_decode_run(mesh, cfg, params, cache_rows, one_at_a_time, out):
    """Fill a cache of `cache_rows` rows for TPS_BATCH sequences by a real
    prefill (the whole batch at once, or one sequence at a time), then
    greedy decode steps: ms a token, the model group's collectives a
    step, the peak above the rank's start (before the weights) over the
    decode steps, the routing of a MoE arch's first step. Fills `out`."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.serve import make_serve_fns, sample_token
    from repro_torch.models import init_cache, layers as L
    from repro_torch.models.layers import broadcast_from_model
    dev, tp = mesh.device, mesh.model_shard
    prefill, decode_step = make_serve_fns(cfg, tp)
    plen = cache_rows - 1024
    prompts = torch.from_numpy(_tps_prompts(cfg, TPS_BATCH, plen,
                                            mesh.rank)).to(dev)
    n_steps = TPS_DECODE_STEPS if cfg.moe is None else TPS_MOE_DECODE_STEPS
    with torch.no_grad():
        _ms_progress(mesh, f"tp serve {cfg.name} prefill")
        _sync(dev)
        t0 = time.perf_counter()
        if one_at_a_time:
            cache = init_cache(cfg, TPS_BATCH, cache_rows, device=dev, tp=tp)
            firsts = []
            for b in range(TPS_BATCH):
                _ms_progress(mesh, f"tp serve {cfg.name} prefill {b}")
                logits, c1 = prefill(params, prompts[b:b + 1])
                _tps_install(cache, c1, b)
                firsts.append(logits)
                del c1
            cache["len"] = torch.full((), plen, dtype=torch.int32,
                                      device=dev)
            logits = torch.cat(firsts)
        else:
            from repro_torch.serve.engine import grow_cache
            logits, c = prefill(params, prompts)
            cache = grow_cache(init_cache(cfg, TPS_BATCH, cache_rows,
                                          device=dev, tp=tp), c)
            del c
        _sync(dev)
        out["prefill_s"] = time.perf_counter() - t0
        tok = broadcast_from_model(sample_token(logits, None, 0.0), tp)
        del logits, prompts
        import gc
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        events, undo = _tps_timed_collectives(dev)
        L.COLLECTIVES = {}
        secs, ms = [], {"reduce": [], "gather": []}
        toks = []
        try:
            for t in range(n_steps):
                _ms_progress(mesh, f"tp serve {cfg.name} decode {t}")
                dist.barrier(group=tp.group)
                _sync(dev)
                t0 = time.perf_counter()
                if t == 0 and cfg.moe is not None:
                    with _tps_routes() as routes:
                        logits, cache = decode_step(params, cache,
                                                    tok[:, None])
                    out["routing"] = [r.tolist() for r in routes]
                else:
                    logits, cache = decode_step(params, cache, tok[:, None])
                tok = broadcast_from_model(sample_token(logits, None, 0.0),
                                           tp)
                _sync(dev)
                secs.append(time.perf_counter() - t0)
                toks.append(tok.tolist())
                for kind, ev in events.items():
                    ms[kind].append(sum(a.elapsed_time(b) for a, b in ev))
                    ev.clear()
            coll = dict(L.COLLECTIVES)
        finally:
            undo()
            L.COLLECTIVES = None
        out.update(
            cache_rows=cache_rows, prompt=plen, batch=TPS_BATCH,
            decode_ms=[1e3 * s for s in secs],
            decode_ms_steady=1e3 * statistics.median(secs[1:]),
            allreduce_calls=coll.get("calls", 0) // n_steps,
            allreduce_bytes=coll.get("bytes", 0) // n_steps,
            allreduce_ms=ms["reduce"],
            allgather_calls=coll.get("gather_calls", 0) // n_steps,
            allgather_bytes=coll.get("gather_bytes", 0) // n_steps,
            allgather_ms=ms["gather"],
            peak_above_start_bytes=torch.cuda.max_memory_allocated(dev) -
            out["start_bytes"],
            tokens=toks, finite=bool(torch.isfinite(logits).all()))
        del cache, logits


def _tps_engine_run(cfg, params, prompts, dev, tp, kw, swap=None):
    """The engine at full width: 8 slots, `prompts` (all queued at once),
    TPS_NEW new tokens each; `swap`: the params published after
    TPS_SWAP_AFTER decode steps of the first lanes. -> (tokens by rid,
    summary, wall s)."""
    import torch
    from repro_torch.serve import EngineConfig, Request, ServeEngine
    eng = ServeEngine(cfg, EngineConfig(
        max_slots=8, prompt_len=TPS_PROMPT, max_new_tokens=TPS_NEW,
        queue_depth=TPS_REQUESTS, **kw), params=params, device=dev, tp=tp)
    for i, p in enumerate(prompts):
        eng.submit(Request(i, p))
    _sync(dev)
    t0 = time.time()
    with torch.no_grad():
        if swap is not None:
            eng.step()                   # admits (and prefills) 8 lanes
            while min(len(ln.tokens) for ln in eng.lanes if ln.active) \
                    < 1 + TPS_SWAP_AFTER:
                eng.step()
            eng.swap.publish(swap, tag="B")
        eng.drain()
    _sync(dev)
    wall = time.time() - t0
    toks = {c.rid: (c.tokens.tolist(), c.gen) for c in eng.completions}
    return toks, eng.metrics.summary(), wall


def _tps_full_rank(rank, world, port, device):
    """A rank of olmo-1b at full width and depth, bf16, 2 x 2: the
    decode_32k run (`_tps_decode_run`, the whole batch prefilled at once),
    then the engine four ways, then the same dense engine on this GPU
    alone with the whole model (agreement printed, not required)."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.models import init_params
    from repro_torch.tree import tree_leaves
    mesh = _ms_mesh(rank, world, port, device, TPS_K)
    dev, tp = mesh.device, mesh.model_shard
    cfg = get_config(TPS_FULL_ARCH)
    _fresh_memory()
    reset_launch_counts()
    out = {"node": mesh.rank, "index": mesh.model_index,
           "start_bytes": torch.cuda.memory_allocated(dev)}
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         dev, tp=tp)
    out["params_per_gpu"] = sum(x.numel() for x in tree_leaves(params))
    _tps_decode_run(mesh, cfg, params, TPS_CACHE, False, out)
    gc.collect()
    torch.cuda.empty_cache()
    prompts = list(_tps_prompts(cfg, TPS_REQUESTS, TPS_PROMPT,
                                100 + mesh.rank))
    swap = init_params(torch.Generator(device=dev).manual_seed(1), cfg, dev,
                       tp=tp)
    engines = {}
    for mode, kw in TPS_ENGINE_RUNS:
        _ms_progress(mesh, f"tp serve engine {mode}")
        toks, summary, wall = _tps_engine_run(
            cfg, params, prompts, dev, tp, kw,
            swap if mode == "swap" else None)
        engines[mode] = dict(tokens=toks, summary=summary, wall_s=wall)
    out["engines"] = engines
    out["launches"] = dict(LAUNCHES)
    del params, swap
    gc.collect()
    torch.cuda.empty_cache()
    _ms_progress(mesh, "tp serve engine on one GPU")
    whole = init_params(torch.Generator(device=dev).manual_seed(0), cfg, dev)
    toks, summary, wall = _tps_engine_run(cfg, whole, prompts, dev, None,
                                          {})
    out["one_gpu"] = dict(tokens=toks, summary=summary, wall_s=wall)
    del whole
    torch.save(out, os.path.join(TPS_DIR, f"full_rank{rank}.pt"))
    mesh.close()


def _tps_moe_rank(rank, world, port, device, cache_rows):
    """A rank of qwen3-moe-30b-a3b at full width and all 48 layers, bf16,
    2 x 2, one-shot: a cache of `cache_rows` rows for TPS_BATCH sequences
    filled one sequence at a time (every GPU holds the whole [E, C, D]
    dispatch buffer), then greedy decode steps."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    from repro_torch.tree import tree_leaves
    mesh = _ms_mesh(rank, world, port, device, TPS_K)
    dev = mesh.device
    cfg = get_config(TPS_MOE_ARCH)
    _fresh_memory()
    reset_launch_counts()
    out = {"node": mesh.rank, "index": mesh.model_index,
           "start_bytes": torch.cuda.memory_allocated(dev)}
    _ms_progress(mesh, "tp serve qwen3 weights")
    params = _tps_draw(cfg, TPS_K, 0, dev)
    out["params_per_gpu"] = sum(x.numel() for x in tree_leaves(params))
    _tps_decode_run(mesh, cfg, params, cache_rows, True, out)
    out["launches"] = dict(LAUNCHES)
    torch.save(out, os.path.join(TPS_DIR, f"moe_rank{rank}.pt"))
    mesh.close()


def _tps_dry_flags(batch, cache_rows):
    return ["--shape", "decode_32k", "--nodes", str(TPS_NODES),
            "--model-parallel", str(TPS_K), "--batch", str(batch), "--seq",
            str(cache_rows)]


def _tps_read(prefix, world) -> list:
    import torch
    return [torch.load(os.path.join(TPS_DIR, f"{prefix}_rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def _tps_decode_line(name, full, dry) -> dict:
    """A full-width decode run's checks and line: finite, the same tokens
    on a node's GPUs, each rank's peak within DRYRUN_BOUND of `dry`."""
    for n in range(TPS_NODES):
        a, b = full[n * TPS_K:(n + 1) * TPS_K]
        check(a["tokens"] == b["tokens"] and a["finite"] and b["finite"],
              f"{name}: tokens differ on node group {n} or not finite")
        if "routing" in a:
            check(a["routing"] == b["routing"],
                  f"{name}: routing differs on node group {n}")
    ratios = [p["peak_above_start_bytes"] / dry["peak_bytes"] for p in full]
    line = {k: [p.get(k) for p in full] for k in (
        "prefill_s", "decode_ms_steady", "decode_ms", "allreduce_calls",
        "allreduce_bytes", "allreduce_ms", "allgather_calls",
        "allgather_bytes", "allgather_ms", "peak_above_start_bytes",
        "start_bytes", "params_per_gpu")}
    line.update(cache_rows=full[0]["cache_rows"], prompt=full[0]["prompt"],
                batch=full[0]["batch"], tokens_rank0=full[0]["tokens"][:4],
                dryrun={"predicted_bytes": dry["peak_bytes"],
                        "measured_over_predicted_by_rank": ratios,
                        **{k: dry.get(k) for k in (
                            "fits", "argument_bytes", "temp_bytes",
                            "model_allreduce_calls",
                            "model_allreduce_bytes_per_dev",
                            "model_allgather_calls",
                            "model_allgather_bytes_per_dev", "memory_s",
                            "compute_s", "collective_s", "bottleneck")}})
    if "routing" in full[0]:
        r0 = full[0]["routing"]
        line["routing"] = {"layers": len(r0), "choices_a_layer":
                           sum(len(x) for x in r0[0]),
                           "layer0_lane0": r0[0][0],
                           "same_on_each_node": True}
    log(name, ranks=len(full), **line)
    lo, hi = DRYRUN_BOUND
    check(all(lo <= r <= hi for r in ratios),
          f"{name}: measured over predicted {ratios} outside "
          f"{DRYRUN_BOUND}")
    return line


def phase_tensor_parallel_serve(device: str = "cuda") -> dict:
    """`tensor_parallel_serve` on 4 GPUs, 2 node groups x TPS_K: (a) the
    reduced card-vs-CPU check (`_tps_reduced_rank`); (b) olmo-1b at full
    width, decode_32k's 8 sequences a node group over a 32,768-row cache,
    held to its dry run, and the engine four ways; (c) qwen3-moe-30b-a3b at
    full width and depth, one-shot, at the longest cache of
    TPS_MOE_CACHES the dry run predicts fits. -> {path: launches}."""
    import torch
    n = torch.cuda.device_count()
    world = TPS_NODES * TPS_K
    if n < world:
        log("tensor_parallel_serve", ran=False, gpus=n, needs=world)
        return {}
    os.makedirs(TPS_DIR, exist_ok=True)
    t0 = time.time()
    # the dry runs first, in the background: fake tensors, one process each
    procs = _dryrun_start({"olmo": _tps_dry_flags(TPS_BATCH, TPS_CACHE)},
                          ("cuda", "cpu"), arch=TPS_FULL_ARCH)
    moe_procs = _dryrun_start({rows: _tps_dry_flags(TPS_BATCH, rows)
                               for rows in TPS_MOE_CACHES},
                              ("cuda", "cpu"), arch=TPS_MOE_ARCH)
    ref = _tps_cpu_reference()
    torch.save(ref, os.path.join(TPS_DIR, "cpu.pt"))
    _ms_spawn(_tps_reduced_rank, world, device)
    reduced_line = _tps_reduced_checks(world, ref)
    log("tensor_parallel_serve_reduced", bound=SERVE_BOUND,
        seconds=time.time() - t0, **reduced_line)
    recs = _dryrun_jobs(None, None, procs)
    _tp_check_dry(recs["olmo", "cuda"], recs["olmo", "cpu"])
    dry = recs["olmo", "cuda"]
    log("tensor_parallel_serve_prediction", arch=TPS_FULL_ARCH,
        command="python -m repro_torch.launch.dryrun --arch olmo-1b "
        "--shape decode_32k " + " ".join(_tps_dry_flags(TPS_BATCH,
                                                        TPS_CACHE)[2:]),
        peak_bytes=dry["peak_bytes"], fits=dry["fits"],
        argument_bytes=dry["argument_bytes"])
    check(dry["fits"], f"tensor_parallel_serve: olmo-1b decode_32k "
          f"predicted at {dry['peak_bytes']} B a GPU")
    t1 = time.time()
    _ms_spawn(_tps_full_rank, world, device)
    full = _tps_read("full", world)
    line = _tps_decode_line("tensor_parallel_serve_olmo", full, dry)
    engines = {}
    for mode, _ in TPS_ENGINE_RUNS:
        per = [p["engines"][mode] for p in full]
        for p in per:
            s = p["summary"]
            check(s["completed"] == TPS_REQUESTS and s["rejected"] == 0 and
                  s["dropped_in_flight"] == 0 and
                  s["decode_cache_misses"] == 0 and
                  s["prefill_cache_misses"] == 0,
                  f"tensor_parallel_serve: olmo engine {mode} {s}")
        for n in range(TPS_NODES):
            a, b = per[n * TPS_K:(n + 1) * TPS_K]
            check(a["tokens"] == b["tokens"], f"tensor_parallel_serve: "
                  f"engine {mode} tokens differ on node group {n}")
        engines[mode] = {k: [p["summary"][k] for p in per] for k in (
            "tokens_per_s", "ttft_p50_ms", "ttft_p99_ms", "latency_p50_ms",
            "latency_p99_ms", "kv_bytes", "kv_dense_bytes", "completed",
            "swaps_adopted")}
        engines[mode]["wall_s"] = [p["wall_s"] for p in per]
    for p in full:
        e = p["engines"]
        check(e["paged_chunked"]["tokens"] == e["chunked"]["tokens"],
              "tensor_parallel_serve: paged != dense (chunked 128)")
        first = {rid: t for rid, t in e["swap"]["tokens"].items()
                 if t[1] == 1}
        check(len(first) >= 8 and all(
            t[0] == e["dense"]["tokens"][rid][0] for rid, t in
            first.items()), "tensor_parallel_serve: the swap's first "
            "lanes differ from the no-swap run")
        check(sorted({t[1] for t in e["swap"]["tokens"].values()}) == [1, 2],
              "tensor_parallel_serve: the swap served one generation")
    agree = []
    for p in full:
        a, b = p["engines"]["dense"]["tokens"], p["one_gpu"]["tokens"]
        same = sum(x == y for rid in a for x, y in zip(a[rid][0], b[rid][0]))
        agree.append(same / sum(len(a[rid][0]) for rid in a))
    log("tensor_parallel_serve_engine", arch=TPS_FULL_ARCH, slots=8,
        requests=TPS_REQUESTS, prompt=TPS_PROMPT, new_tokens=TPS_NEW,
        swap_after=TPS_SWAP_AFTER, seconds=time.time() - t1, **engines,
        one_gpu_tokens_per_s=[p["one_gpu"]["summary"]["tokens_per_s"]
                              for p in full],
        one_gpu_greedy_agreement=agree)
    launches = [p["launches"] for p in full]
    moe = _dryrun_jobs(None, None, moe_procs)
    for rows in TPS_MOE_CACHES:
        _tp_check_dry(moe[rows, "cuda"], moe[rows, "cpu"])
    rows = next((r for r in TPS_MOE_CACHES if moe[r, "cuda"]["fits"]),
                None)
    log("tensor_parallel_serve_moe_prediction", arch=TPS_MOE_ARCH,
        predicted_bytes={r: moe[r, "cuda"]["peak_bytes"]
                         for r in TPS_MOE_CACHES}, cache_rows=rows)
    check(rows is not None, "tensor_parallel_serve: qwen3 fits no cache "
          f"of {TPS_MOE_CACHES}")
    t2 = time.time()
    _ms_spawn(_tps_moe_rank, world, device, rows)
    moe_full = _tps_read("moe", world)
    _tps_decode_line("tensor_parallel_serve_qwen3", moe_full,
                     moe[rows, "cuda"])
    launches += [p["launches"] for p in moe_full]
    check(all(sum(c.values()) == 0 for c in launches),
          f"tensor_parallel_serve: serving launched kernels {launches}")
    log("tensor_parallel_serve_done", seconds=time.time() - t0,
        qwen3_seconds=time.time() - t2, olmo=line["decode_ms_steady"])
    return {"tensor_parallel_serve": launches[0]}


def phase_multi_shard() -> dict:
    """The node-mesh phases where the host has 2 or more GPUs; on one,
    the declared not-run line. -> {path: launches}."""
    import torch
    n = torch.cuda.device_count()
    if n < 2:
        log("multi_shard", ran=False, gpus=n, needs=2)
        return {}
    world = _ms_world(n)
    # rank 0 shares GPU 0 with this process: hand back its cached blocks
    _fresh_memory()
    phase_multi_shard_reference(world)
    by_path = phase_multi_shard_full_width(world)
    by_path.update(phase_multi_shard_train_4k(world))
    if n < TP_NODES * TP_K:
        log("tensor_parallel", ran=False, gpus=n, needs=TP_NODES * TP_K)
    else:
        _fresh_memory()
        by_path.update(phase_tensor_parallel(TP_NODES * TP_K))
    return by_path


def kernels_line(records: dict, launches: dict, by_path: dict) -> list:
    """The kernels' JSON record: each kernel's route, source, the TPU
    kernel it replaces, its launches on the main path (`launches`) and by
    path, and phase `kernel`'s measurements (`records`)."""
    return [{"name": n, "route": "cuda", "source": SOURCES[n],
             "replaces": TPU_KERNELS[n], "launches": launches[n],
             "launches_by_path": {p: c[n] for p, c in by_path.items()},
             **{k: records[n][k] for k in
                ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms")}} for n in TPU_KERNELS]


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="chip_smoke.py")
    ap.add_argument("--only", choices=["multi_shard", "dryrun",
                                       "tensor_parallel_serve"],
                    default=None,
                    help="run only these phases (multi_shard: the node "
                         "mesh's two phases, for a host with 2 or more "
                         "GPUs; dryrun: the phases whose peaks the dry run "
                         "predicts, then the dry run; "
                         "tensor_parallel_serve: serving on 2 node groups "
                         "of 2 GPUs, for a host with 4); default: every "
                         "phase")
    args = ap.parse_args(argv)
    # expandable segments, set before the allocator starts, as the port's
    # entry points set them (launch/train.py `use_expandable_segments`):
    # the smoke calls the drivers' functions, not their `main`, in one
    # process. With fixed segments the 8-node overlapped scheduled command
    # fragments past the card's 79.18 GiB
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # one fixed cuBLAS workspace, set before the first cuBLAS call, so the
    # deterministic algorithms of phase_overlap_exact reproduce
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    sys.path.insert(0, os.path.join(ROOT, "src"))
    os.makedirs(OUT_DIR, exist_ok=True)
    open(PHASE_LOG, "w").close()
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    log("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi[0],
        torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.time()
    build.build_all()
    log("build", seconds=time.time() - t0,
        libraries=[str(build.library_path(n)) for n in build.KERNELS])
    if args.only is not None:
        if args.only in ("multi_shard", "tensor_parallel_serve"):
            records = phase_kernels()
            _fresh_memory()
            by_path = phase_multi_shard() if args.only == "multi_shard" \
                else phase_tensor_parallel_serve()
            path = "tensor_parallel" if args.only == "multi_shard" \
                else args.only
            if path in by_path:
                print(smi[0], flush=True)
                print(json.dumps({"kernels": kernels_line(
                    records, by_path[path], by_path)}), flush=True)
        else:
            _, main_records = phase_main_path()
            phase_scan_full_width(main_records)
            _measure_decode_step()
            phase_dryrun()
        print(smi[0], flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    records = phase_kernels()
    phase_reference()
    blocking, main_records = phase_main_path()
    remat = phase_remat()
    phase_exact()
    phase_overlap_exact()
    counts = phase_full_width()
    phase_checkpoint()
    phase_baselines_reference()
    baselines = phase_baselines_full_width()
    phase_sched_reference()
    phase_sched_uniform_exact()
    sched = phase_sched_full_width()
    phase_codecs_reference()
    codecs = phase_codecs_full_width()
    phase_transports_reference()
    walls = [h["wall_s"] for h in main_records]
    transports = phase_transports_full_width(
        statistics.median(b - a for a, b in zip(walls, walls[1:])))
    phase_scan_bitwise()
    scan = phase_scan_full_width(main_records)
    phase_serve_reference()
    serving = phase_serve_full_width()
    phase_dryrun()
    serving.update(phase_serve_checkpoint())
    serving.update(phase_serve_follow())
    phase_zoo_reference()
    serving.update(phase_zoo_train_full_width())
    serving.update(phase_zoo_serve_full_width())
    serving.update(phase_multi_shard())
    # serving on a split node runs alone, on 4 GPUs
    log("tensor_parallel_serve", ran=False, gpus=torch.cuda.device_count(),
        needs=TPS_NODES * TPS_K, run="--only tensor_parallel_serve")
    kernels = kernels_line(records, counts, {
        "overlap_q8_geometric": counts, "blocking_q8": blocking, **remat,
        **baselines, **sched, **codecs, **transports, **scan, **serving})
    # the card again, so the tail of a long log still names it
    print(smi[0], flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
