"""Run the dry run over the reference's grid (counterpart of
``repro/launch/sweep.py``): every arch × input shape × mesh, each pair in
its own subprocess with a timeout, so a failure or a hang in one cannot
poison the rest. Each writes one record into ``--out``; a pair that
fails or times out gets an error record naming its cause.

  PYTHONPATH=src python -m repro_torch.launch.sweep --device cuda \\
      --out results/dryrun_torch --jobs 6
  PYTHONPATH=src python -m repro_torch.roofline.table \\
      --dir results/dryrun_torch
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
SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run_pair(arch: str, shape: str, mesh: str, out: str, device: str,
             extra=(), timeout: int = 1800) -> bool:
    """One pair's dry run in a subprocess; -> whether it wrote a record
    (an existing record is kept)."""
    tag = f"{arch}__{shape}__{mesh}"
    path = os.path.join(out, tag + ".json")
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
                   "error": err}, f)
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
    with ThreadPoolExecutor(max_workers=args.jobs) as pool:
        done = list(pool.map(lambda p: run_pair(
            *p, args.out, args.device, timeout=args.timeout), pairs))
    print(f"done: {sum(done)} ok, {len(done) - sum(done)} failed",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
