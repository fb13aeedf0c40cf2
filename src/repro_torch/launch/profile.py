"""Where one superstep's time goes, on the card.

  PYTHONPATH=src python -m repro_torch.launch.profile --arch transformer-wmt \
      --nodes 8 --H 2 --quantize --overlap \
      --trace superstep_trace.json
  PYTHONPATH=src python -m repro_torch.launch.profile --nodes 8 \
      --algo dpsgd --graph ring
  PYTHONPATH=src python -m repro_torch.launch.profile --nodes 8 \
      --quantize --rate-profile uniform_async --steps 4 \
      --avail day_night:period=4,duty=0.75,join=0.25:0.5:1.5 --profile-join

Builds the training driver's run (same flags as ``repro_torch.launch.train``,
``--algo``, ``--graph``, ``--gossip-impl`` / ``--pool-size`` and the
scheduler's ``--rate-profile``, ``--straggler``, ``--avail`` and
``--topology`` included, so a baseline's superstep, another transport or a
scheduled bin breaks down the same way; a ``*_legacy`` oracle's per-leaf
exchange is the span ``gossip.legacy``),
runs ``--warmup`` supersteps (bins), then one under ``torch.profiler`` —
with ``--profile-join`` the first join bin at or after ``--warmup``, whose
bootstrap is the span ``swarm.join`` —
and prints one JSON object: the superstep's wall time (host clock, ending
in a device sync), the device's busy time (union of kernel, memcpy and
memset intervals in the trace) and idle share, the device-busy time inside
each engine span's device range (``swarm.grad``, ``swarm.sgd``,
``sgd.pack``, ``gossip.encode``, ``gossip.mean`` (the baselines' global
mean), ``gossip.matrix`` (D-PSGD's mixing product), ... — the
``record_function`` ranges of ``algorithms/*.py``,
``core/swarm.py``, ``core/exchange.py``, ``core/bucket.py`` and
``optim/sgd.py``; the profiler gives a span the device work launched
directly in it, not in a nested span) with its host time and the CUDA
streams its device work ran on, and the kernels that took the most device
time. ``permute_overlap`` says how much of ``gossip.permute``'s device time
(the overlapped pipeline's in-flight gather, on its side stream) ran at the
same time as ``swarm.grad`` / ``swarm.sgd`` device work on another stream,
and as any device work on another stream. A device event belongs to every
span whose host range holds its launch (matched by correlation id, on the
launching thread); the backward of the vmapped model launches from
autograd's thread and so belongs to no span.

With ``--scan-chunk K`` (the chunk driver, ``core/scan.py``) it runs
``--warmup`` chunks of K supersteps (the first captures the CUDA graphs),
then profiles one chunk: a replayed graph has no ``record_function`` spans,
so the chunk is reported as its wall time between two CUDA events against
the union of its kernel, memcpy and memset intervals (``chunk_ms``,
``device_busy_ms``, ``idle_share``; ``superstep_ms`` is chunk_ms / K).
``--codec`` and ``--compress-state`` pick the wire as in the driver.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from collections import defaultdict

import torch

from repro_torch.launch.train import (
    build, build_parser, use_expandable_segments,
)

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _union(intervals) -> list:
    """Sorted disjoint union of [start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _union_ms(intervals) -> float:
    """Length of the union of [start, end) intervals (µs in, ms out)."""
    return sum(b - a for a, b in _union(intervals)) / 1e3


def _overlap_ms(xs, ys) -> float:
    """Length of union(xs) ∩ union(ys) (µs in, ms out)."""
    xs, ys = _union(xs), _union(ys)
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total / 1e3


def _device_events(events) -> list:
    """(start, end, stream, names of the spans that launched it) for every
    kernel / memcpy / memset."""
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    annos = [e for e in events if e.get("cat") == "user_annotation"]
    out = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        args = e.get("args", {})
        launch = launches.get(args.get("correlation"))
        names = frozenset(
            a["name"] for a in annos if launch is not None
            and a.get("tid") == launch.get("tid")
            and a["ts"] <= launch["ts"] <= a["ts"] + a["dur"])
        out.append((e["ts"], e["ts"] + e["dur"],
                    args.get("stream", e.get("tid")), names))
    return out


def permute_overlap(devs) -> dict:
    """gossip.permute's device time, and how much of it overlapped
    swarm.grad / swarm.sgd device work (and any device work) on another
    stream."""
    perm = [d for d in devs if "gossip.permute" in d[3]]
    streams = {d[2] for d in perm}
    other = [d for d in devs if d[2] not in streams]
    local = [(a, b) for a, b, _, n in other
             if n & {"swarm.grad", "swarm.sgd"}]
    pi = [(a, b) for a, b, _, _ in perm]
    return {"device_ms": _union_ms(pi), "streams": sorted(streams),
            "with_local_steps_ms": _overlap_ms(pi, local),
            "with_any_other_stream_ms": _overlap_ms(
                pi, [(a, b) for a, b, _, _ in other])}


def summarize(trace: dict, wall_ms: float, top: int = 12) -> dict:
    """Busy/idle, per-span device time and streams, and the in-flight
    permute's overlap, from a chrome trace."""
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    dev = [(e["ts"], e["ts"] + e["dur"]) for e in events
           if e.get("cat") in DEVICE_CATS]
    busy = _union_ms(dev)
    devs = _device_events(events)
    spans = defaultdict(lambda: {"count": 0, "host_ms": 0.0,
                                 "device_busy_ms": 0.0, "streams": []})
    for e in events:
        cat, name = e.get("cat"), e.get("name", "")
        if cat == "user_annotation":
            spans[name]["count"] += 1
            spans[name]["host_ms"] += e["dur"] / 1e3
        elif cat == "gpu_user_annotation":
            a, b = e["ts"], e["ts"] + e["dur"]
            spans[name]["device_busy_ms"] += _union_ms(
                [(max(a, x), min(b, y)) for x, y in dev if x < b and y > a])
    for name, sp in spans.items():
        sp["streams"] = sorted({d[2] for d in devs if name in d[3]})
    kernels = defaultdict(lambda: [0, 0.0])
    for e in events:
        if e.get("cat") == "kernel":
            kernels[e["name"]][0] += 1
            kernels[e["name"]][1] += e["dur"] / 1e3
    top_k = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top]
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy,
        "idle_share": (1.0 - busy / wall_ms) if wall_ms else None,
        "n_kernels": sum(c for c, _ in kernels.values()),
        "spans": dict(sorted(spans.items())),
        "permute_overlap": permute_overlap(devs),
        "top_kernels": [{"name": n[:120], "count": c, "ms": ms}
                        for n, (c, ms) in top_k],
    }


def advance(tr, t: int):
    """Run bin t of the trainer's run as the training driver does: retire
    the nodes that left before it, then the join bootstrap or the
    superstep; -> the superstep's loss (None for a join bin)."""
    tr.retire(t)
    if tr.is_join(t):
        tr.join_bin(t)
        return None
    return float(tr.superstep(t)["loss"])


def profile_chunk(args) -> dict:
    """``--scan-chunk K``: --warmup chunks, then one chunk under the
    profiler, timed by CUDA events on the card."""
    k = args.scan_chunk
    args.steps = (args.warmup + 1) * k
    tr = build(args)
    on_card = tr.device.type == "cuda"
    for c in range(args.warmup):
        t = c * k
        tr.chunk(t, k, [tr.node_batches(s) for s in range(t, t + k)])
    t = args.warmup * k
    nbs = [tr.node_batches(s) for s in range(t, t + k)]
    activities = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        if on_card:
            ev[0].record()
        ms = tr.chunk(t, k, nbs)
        if on_card:
            ev[1].record()
            torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    chunk_ms = ev[0].elapsed_time(ev[1]) if on_card else None
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "chunk_trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            summary = summarize(json.load(f), chunk_ms or host_ms)
    summary.pop("spans")
    summary.pop("permute_overlap")
    if not on_card or summary["n_kernels"] == 0:
        # no device in this run, or no kernel in the trace of the replay:
        # the device metrics were not measured
        summary.update(device_busy_ms=None, idle_share=None)
    summary.update(chunk=k, first_step=t, chunk_ms=chunk_ms,
                   superstep_ms=None if chunk_ms is None else chunk_ms / k,
                   host_ms=host_ms, graphs=len(tr.chunker.graphs),
                   loss=[float(x) for x in ms["loss"]],
                   device=str(tr.device),
                   device_name=(torch.cuda.get_device_name(0) if on_card
                                else "cpu"))
    return summary


def main(argv=None) -> dict:
    use_expandable_segments()
    ap = build_parser()
    ap.add_argument("--warmup", type=int, default=1,
                    help="supersteps run before the profiled one")
    ap.add_argument("--trace", default=None,
                    help="where to write the chrome trace (default: a file "
                         "next to --out, or not kept)")
    ap.add_argument("--profile-join", action="store_true",
                    help="profile the first join bin at or after --warmup "
                         "(needs --avail; the schedule spans --steps)")
    args = ap.parse_args(argv)
    if args.scan_chunk:
        if args.profile_join or args.avail:
            ap.error("--scan-chunk profiles gossip chunks: drop "
                     "--profile-join and --avail")
        summary = profile_chunk(args)
        print(json.dumps(summary), flush=True)
        return summary
    if not args.profile_join:
        args.steps = args.warmup + 1
    tr = build(args)
    target = args.warmup
    if args.profile_join:
        joins = [t for t in range(args.warmup, tr.n_steps) if tr.is_join(t)]
        if not joins:
            ap.error("--profile-join: no join bin at or after --warmup in "
                     "this schedule (raise --steps or change --avail)")
        target = joins[0]
    on_card = tr.device.type == "cuda"
    for t in range(target):
        advance(tr, t)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        loss = advance(tr, target)
        if on_card:
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    path = args.trace or os.path.join(
        os.path.dirname(args.out or "") or ".", "superstep_trace.json")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        summary = summarize(json.load(f), wall_ms)
    if args.trace is None:
        os.remove(path)
    if not on_card:
        # no device in this run: its device metrics were not measured
        summary.update(device_busy_ms=None, idle_share=None)
        for sp in summary["spans"].values():
            sp["device_busy_ms"] = None
        summary["permute_overlap"] = None
    summary.update(step=target, bin="join" if tr.is_join(target) else "mix",
                   loss=loss, device=str(tr.device),
                   device_name=(torch.cuda.get_device_name(0) if on_card
                                else "cpu"))
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main(sys.argv[1:])
