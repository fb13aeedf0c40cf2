"""End-to-end driver on the port: train transformer-wmt (~185M params at
full width) with SwarmSGD for a few hundred supersteps through the port's
training launcher, 8 nodes on one GPU.

`--ci` runs the same code path at a scale that finishes in minutes.
``repro_torch/launch/dryrun.py`` sizes the full config before a run
(``--nodes-per-gpu 8 --batch 4 --seq 512``).

  PYTHONPATH=src python examples/train_e2e_torch.py [--ci] [--device cpu]
"""
import argparse
import os
import subprocess
import sys

ap = argparse.ArgumentParser()
ap.add_argument("--ci", action="store_true")
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = ap.parse_args()

if args.ci:
    run_args = ["--reduced", "--layers", "4", "--d-model", "256",
                "--nodes", "8", "--steps", "60", "--batch", "2",
                "--seq", "128"]
else:
    # 12 layers x d_model 1024 + 32k vocab (transformer-wmt)
    run_args = ["--nodes", "8", "--steps", "200", "--batch", "4",
                "--seq", "512"]

cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
       "transformer-wmt", "--algo", "swarm", "--H", "2", "--device",
       args.device, "--ckpt", "build/e2e_torch_ckpt", "--out",
       "build/e2e_torch_metrics.json", *run_args]
print(" ".join(cmd))
subprocess.run(cmd, env={**os.environ, "PYTHONPATH": "src"}, check=True)
