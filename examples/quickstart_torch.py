"""Quickstart on the PyTorch/CUDA port: SwarmSGD in ~50 lines.

Eight decentralized nodes train a small transformer with 2 local SGD steps
between pairwise gossip interactions (Algorithm 1), all eight stacked on
one GPU (``--device cpu`` runs the kernels' plain versions on the CPU).
Gossip runs on the flat-buffer transport: the whole model moves as ONE
packed payload per interaction; pass SwarmConfig(gossip_impl=
"gather_legacy") to A/B the per-leaf oracle.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import sys
sys.path.insert(0, "src")

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import (SwarmConfig, make_graph, make_swarm_step,
                              sample_h_counts, sample_matching, swarm_init)
from repro_torch.data import DataConfig, SyntheticLMDataset, make_node_batches
from repro_torch.launch.train import resolve_device
from repro_torch.models import TransformerLM, init_params
from repro_torch.optim import make_optimizer

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
ap.add_argument("--steps", type=int, default=40)
args = ap.parse_args()
dev = resolve_device(args.device, "quickstart_torch.py")
N_NODES, H, SEQ, BATCH = 8, 2, 64, 2

# 1. model (reduced transformer-wmt: the paper's NMT workload family)
cfg = reduced(get_config("transformer-wmt"), n_layers=2, d_model=128)

# 2. interaction graph + swarm protocol config
graph = make_graph("complete", N_NODES)
scfg = SwarmConfig(n_nodes=N_NODES, H=H)
opt = make_optimizer("sgd", lr=0.08, momentum=0.9)

# 3. the superstep: H local steps per node, then pairwise averaging
step = make_swarm_step(scfg, TransformerLM(cfg).functional_loss, opt.update,
                       lambda s: 0.08)
state = swarm_init(torch.Generator(device=dev).manual_seed(0), scfg,
                   lambda g: init_params(g, cfg, dev), opt.init)

# 4. decentralized training loop
ds = SyntheticLMDataset(DataConfig(cfg.vocab_size, SEQ), n_nodes=N_NODES)
rng = np.random.default_rng(0)
enc = torch.Generator(device=dev).manual_seed(1)
for t in range(args.steps):
    nb = make_node_batches(ds, t, BATCH * H)
    batch = {k: torch.from_numpy(v.reshape(N_NODES, H, BATCH, SEQ)).to(dev)
             for k, v in nb.items()}
    perm = sample_matching(graph, rng)          # random matching of G
    h = sample_h_counts(scfg, rng)              # local steps per node
    state, m = step(state, batch, perm, h, enc)
    if t % 10 == 0 or t == args.steps - 1:
        print(f"superstep {t:3d}  loss {float(m['loss']):.4f}  "
              f"Γ {float(m['gamma']):.5f}  "
              f"matched {float(m['matched_frac']):.2f}")
print("done — models stayed concentrated (Γ small) while training "
      "decentralized.")
