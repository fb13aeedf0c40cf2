"""Paper §5 / Fig 1 at laptop scale, on the PyTorch/CUDA port: SwarmSGD vs
the baselines it beats (AD-PSGD, D-PSGD, SGP, Local SGD) and large-batch
AllReduce SGD, on the same token budget: 8 nodes of a reduced
transformer-wmt on one GPU (``--device cpu``: the CPU), each algorithm
built by the port's registry (``make_algorithm``).

  PYTHONPATH=src python examples/compare_algorithms_torch.py \
      [--steps 60] [--device cpu]
"""
import argparse
import sys
import time
sys.path.insert(0, "src")

import numpy as np
import torch

from repro_torch.algorithms import make_algorithm, validate_run_config
from repro_torch.algorithms.sgp import sgp_init_state
from repro_torch.configs import get_config, reduced
from repro_torch.core import (SwarmConfig, make_graph, sample_h_counts,
                              sample_matching, swarm_init,
                              transport_from_config)
from repro_torch.data import DataConfig, SyntheticLMDataset, make_node_batches
from repro_torch.launch.train import resolve_device
from repro_torch.models import TransformerLM, init_params
from repro_torch.optim import make_optimizer
from repro_torch.quant.schemes import ModularQuantConfig, payload_bytes
from repro_torch.tree import tree_flatten

N_NODES, H, SEQ, BATCH, LR = 8, 2, 64, 2, 0.08
# exchanges of one model a node makes per superstep of H local steps, as
# the paper's Fig. 4 counts them: Swarm once; AD-PSGD and SGP every step;
# D-PSGD every step with each of an r = 4 regular graph's neighbours;
# Local SGD one ring all-reduce (2 models), all-reduce SGD one a step
EXCHANGES = {"swarm": 1, "adpsgd": H, "dpsgd": 4 * H, "sgp": H,
             "localsgd": 2, "allreduce": 2 * H}


def wire_bytes(algo: str, n_params: int, quantize: bool = False) -> int:
    """Wire bytes a node sends per superstep: fp32, or the q8 lattice."""
    one = payload_bytes(ModularQuantConfig(), n_params) if quantize \
        else 4 * n_params
    return EXCHANGES[algo] * one


def run_steps(algo: str, steps: int, device, quantize: bool = False) -> dict:
    """`steps` supersteps of `algo`; -> losses, Γ, ms a superstep (host
    clock to a device sync, after two warm-up supersteps) and params a
    node."""
    caps = validate_run_config(algo, quantize=quantize, n_nodes=N_NODES)
    cfg = reduced(get_config("transformer-wmt"), n_layers=2, d_model=128,
                  vocab=512)
    # safety 16 keeps the decode's distance criterion valid at these
    # concentrated spreads (the reference's bench quantizer)
    scfg = SwarmConfig(n_nodes=N_NODES, H=H if caps.local_H else 1,
                       quantize=quantize,
                       quant=ModularQuantConfig(safety=16.0))
    graph = make_graph("complete", N_NODES)
    opt = make_optimizer("sgd", lr=LR, momentum=0.9)
    kw = dict(loss_fn=TransformerLM(cfg).functional_loss,
              opt_update=opt.update, lr_fn=lambda s: LR, n_nodes=N_NODES,
              transport=transport_from_config(scfg, graph))
    if algo == "swarm":
        kw["scfg"] = scfg
    if algo == "localsgd":
        kw["H"] = H
    if algo == "dpsgd":
        kw["graph"] = graph
    if caps.quantized and algo != "swarm":
        kw["quantize"] = quantize
    step = make_algorithm(algo, **kw)
    state = swarm_init(torch.Generator(device=device).manual_seed(0), scfg,
                       lambda g: init_params(g, cfg, device), opt.init)
    if algo == "sgp":
        state = sgp_init_state(state, N_NODES, quantize)
    ds = SyntheticLMDataset(DataConfig(cfg.vocab_size, SEQ), n_nodes=N_NODES)
    rng = np.random.default_rng(0)
    enc = torch.Generator(device=device).manual_seed(1)
    hb = scfg.h_loop_bound
    losses, gammas, times = [], [], []
    for t in range(steps):
        nb = make_node_batches(ds, t, BATCH * hb)
        batch = {k: torch.from_numpy(v.reshape(N_NODES, hb, BATCH, SEQ))
                 .to(device) for k, v in nb.items()}
        perm, h = sample_matching(graph, rng), sample_h_counts(scfg, rng)
        t0 = time.perf_counter()
        state, m = step(state, batch, perm, h, enc)
        losses.append(float(m["loss"]))          # waits for the device
        times.append(time.perf_counter() - t0)
        gammas.append(float(m.get("gamma", 0.0)))
    params = state.params["model"] if algo == "sgp" else state.params
    n_params = sum(x[0].numel() for x in tree_flatten(params)[0])
    return {"loss": losses, "gamma": gammas,
            "ms_per_step": float(np.mean(times[2:]) * 1e3),
            "n_params": n_params}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    dev = resolve_device(args.device, "compare_algorithms_torch.py")
    print(f"{'algo':<12} {'final loss':>10} {'ms/superstep':>13} "
          f"{'MB wire/node/superstep':>23}")
    for algo in ["swarm", "adpsgd", "dpsgd", "sgp", "localsgd", "allreduce"]:
        r = run_steps(algo, args.steps, dev)
        print(f"{algo:<12} {np.mean(r['loss'][-5:]):>10.4f} "
              f"{r['ms_per_step']:>13.1f} "
              f"{wire_bytes(algo, r['n_params']) / 1e6:>23.1f}")
    print("\nSwarm matches the baselines' loss at a fraction of the wire "
          "bytes (communicates once per H local steps, pairwise only).")
