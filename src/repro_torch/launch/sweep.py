"""Run the dry run over the reference's grid (counterpart of
``repro/launch/sweep.py``): every arch × input shape × mesh, each pair in
its own subprocess with a timeout, so a failure or a hang in one cannot
poison the rest. Each writes one record into ``--out``; a pair that
fails or times out gets an error record naming its cause.

  PYTHONPATH=src python -m repro_torch.launch.sweep --device cuda \\
      --out results/dryrun_torch --jobs 6
  PYTHONPATH=src python -m repro_torch.roofline.table \\
      --dir results/dryrun_torch

For each dense and MoE arch (``models/split.py``) the grid's
MODEL_AXIS_SHAPES pairs (``train_4k`` and the serving shapes
``prefill_32k`` and ``decode_32k``) are traced on the model axis too
(``dryrun --model-parallel K``): at the reference's own K, ``min(16,
n_heads)`` (a node is a 16-chip "model" row where the heads allow it;
skipped where the port refuses it, as granite-moe-3b-a800m's 24 heads at
16), and at the smallest K of MODEL_AXIS_KS whose trace fits one H100,
tried in ascending order. The other archs wait for their ROADMAP.md items
(``models/split.py`` ``NOT_ON_THE_MODEL_AXIS``) and stay at one GPU a
node. An existing record is kept, so a sweep into
a directory that holds the one-GPU records adds only what is missing:

  PYTHONPATH=src python -m repro_torch.launch.sweep --device cuda \\
      --shapes train_4k --out results/dryrun_torch --jobs 7
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ARCHS = [
    "gemma3-4b", "olmo-1b", "granite-moe-3b-a800m", "musicgen-large",
    "gemma3-27b", "paligemma-3b", "jamba-1.5-large-398b", "chatglm3-6b",
    "mamba2-780m", "qwen3-moe-30b-a3b",
]
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
MODEL_AXIS_SHAPES = ("train_4k", "decode_32k", "prefill_32k")
MODEL_AXIS_KS = (2, 4, 8, 16)
SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def model_axis_ks(arch: str):
    """(the reference's K, the Ks the port accepts, to try for the
    smallest that fits) of an arch on the model axis, or None for an arch
    that waits."""
    from repro_torch.configs import get_config
    from repro_torch.models.split import check_model_parallel
    cfg = get_config(arch)

    def ok(k):
        try:
            check_model_parallel(cfg, k)
        except ValueError:
            return False
        return True
    if not ok(2):
        return None
    return min(16, cfg.n_heads), [k for k in MODEL_AXIS_KS if ok(k)]


def record_path(out: str, arch: str, shape: str, mesh: str,
                K: int = 1) -> str:
    """The record's file, as ``dryrun`` ``record_tag`` names it."""
    tag = f"{arch}__{shape}__{mesh}" + (f"__tp{K}" if K > 1 else "")
    return os.path.join(out, tag + ".json")


def run_model_axis(arch: str, shape: str, mesh: str, out: str,
                   device: str, timeout: int = 1800) -> bool:
    """`arch`'s `shape` pair at the reference's K (where the port accepts
    it), then at each K in ascending order until one fits one H100 (or
    fails: a trace that times out at K times out beyond it); -> whether
    every trace wrote a counted record."""
    ks = model_axis_ks(arch)
    if ks is None:
        return True
    k_ref, tries = ks
    ok = k_ref not in tries or run_pair(
        arch, shape, mesh, out, device, ["--model-parallel", str(k_ref)],
        timeout, K=k_ref)
    for k in tries:
        ok = run_pair(arch, shape, mesh, out, device,
                      ["--model-parallel", str(k)], timeout, K=k) and ok
        with open(record_path(out, arch, shape, mesh, k)) as f:
            rec = json.load(f)
        if rec.get("fits") or "error" in rec:
            break                  # fits, or a larger K fails alike
    return ok


def run_pair(arch: str, shape: str, mesh: str, out: str, device: str,
             extra=(), timeout: int = 1800, K: int = 1) -> bool:
    """One pair's dry run in a subprocess (on K GPUs a node); -> whether
    it wrote a record (an existing record is kept)."""
    path = record_path(out, arch, shape, mesh, K)
    tag = os.path.basename(path)[:-len(".json")]
    if os.path.exists(path):
        print(f"[skip existing] {tag}", flush=True)
        return True
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", mesh, "--device", device, "--out",
           out] + list(extra)
    env = {**os.environ, "PYTHONPATH": SRC + os.pathsep +
           os.environ.get("PYTHONPATH", "")}
    t0 = time.time()
    try:
        p = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout, env=env)
    except subprocess.TimeoutExpired:
        err = f"timeout {timeout}s"
    else:
        if p.returncode == 0:
            print(f"[ok {time.time() - t0:.0f}s] {tag}", flush=True)
            return True
        err = (p.stderr or "")[-2000:]
    print(f"[FAIL {time.time() - t0:.0f}s] {tag}\n{err}", flush=True)
    with open(path, "w") as f:
        json.dump({"arch": arch, "shape": shape, "mesh": mesh,
                   "model_parallel": K, "error": err}, f)
    return False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.sweep")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--archs", default=",".join(ARCHS))
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device (cuda or cpu)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="pairs traced at once, one process each")
    ap.add_argument("--timeout", type=int, default=1800)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    pairs = [(a, s, m) for a in args.archs.split(",")
             for s in args.shapes.split(",") for m in meshes]
    jobs = [lambda p=p: run_pair(*p, args.out, args.device,
                                 timeout=args.timeout) for p in pairs]
    jobs += [lambda a=a, s=s, m=m: run_model_axis(a, s, m, args.out,
                                                  args.device, args.timeout)
             for s in MODEL_AXIS_SHAPES if s in args.shapes.split(",")
             for a in args.archs.split(",") for m in meshes]
    with ThreadPoolExecutor(max_workers=args.jobs) as pool:
        done = list(pool.map(lambda job: job(), jobs))
    print(f"done: {sum(done)} ok, {len(done) - sum(done)} failed",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
