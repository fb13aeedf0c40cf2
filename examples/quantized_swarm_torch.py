"""Extension 3 on the PyTorch/CUDA port: 8-bit modular-quantized gossip
(paper Fig. 8), the q8 lattice through the port's quantize_mod and
decode_avg kernels on the card — convergence parity with fp32 exchange at
~4x wire compression.

  PYTHONPATH=src python examples/quantized_swarm_torch.py [--device cpu]
"""
import argparse
import os
import sys
sys.path.insert(0, "src")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

from compare_algorithms_torch import run_steps, wire_bytes
from repro_torch.launch.train import resolve_device

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=50)
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = ap.parse_args()
dev = resolve_device(args.device, "quantized_swarm_torch.py")

fp = run_steps("swarm", args.steps, dev)
q8 = run_steps("swarm", args.steps, dev, quantize=True)
b_fp = wire_bytes("swarm", fp["n_params"])
b_q8 = wire_bytes("swarm", q8["n_params"], quantize=True)
print(f"fp32 gossip: final loss {np.mean(fp['loss'][-5:]):.4f}, "
      f"{b_fp / 1e6:.2f} MB/node/superstep")
print(f"int8 gossip: final loss {np.mean(q8['loss'][-5:]):.4f}, "
      f"{b_q8 / 1e6:.2f} MB/node/superstep "
      f"({b_fp / b_q8:.2f}x compression)")
print(f"Γ (fp32) {np.mean(fp['gamma'][-5:]):.5f} vs "
      f"Γ (int8) {np.mean(q8['gamma'][-5:]):.5f} — the distance-bounded "
      "quantizer keeps the swarm concentrated.")
