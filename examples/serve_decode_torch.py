"""Batched serving on the port: prefill + KV-cache decode on a reduced
Mamba2 (SSM, O(1) decode state) and a reduced Gemma3 (sliding-window +
global attention), through the port's serving launcher.

  PYTHONPATH=src python examples/serve_decode_torch.py [--device cpu]
"""
import argparse
import os
import subprocess
import sys

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = ap.parse_args()

for arch in ["mamba2-780m", "gemma3-4b"]:
    print(f"=== {arch} (reduced) ===", flush=True)
    subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                    "--arch", arch, "--reduced", "--batch", "2",
                    "--prompt-len", "32", "--gen", "12", "--device",
                    args.device],
                   env={**os.environ, "PYTHONPATH": "src"}, check=True)
