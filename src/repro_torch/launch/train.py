"""Training driver for the port: SwarmSGD (blocking, gather transport) on
the synthetic LM stream, on the card by default.

  PYTHONPATH=src python -m repro_torch.launch.train --arch transformer-wmt \
      --nodes 8 --H 2 --steps 4 --quantize

prints one JSON record per logged superstep with the JAX driver's keys
(``step``, ``loss``, ``gamma``, ``wall_s``). ``--device cpu`` runs the plain
kernel versions on the CPU; without it a machine with no GPU exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.graph import complete, sample_matching
from repro_torch.core.swarm import (
    SwarmConfig, SwarmState, make_swarm_step, sample_h_counts, swarm_init,
)
from repro_torch.data import DataConfig, SyntheticLMDataset, make_node_batches
from repro_torch.models import TransformerLM, init_params
from repro_torch.optim import make_optimizer


def sample_gossip_perm(scfg: SwarmConfig, graph, rng_np) -> np.ndarray:
    """Per-superstep matching of the gather transport."""
    return sample_matching(graph, rng_np)


def presample_inputs(scfg: SwarmConfig, graph, rng_np, n_steps: int):
    """The whole run's (perm, h) streams as [n_steps, n_nodes] int32,
    drawn from `rng_np` in the JAX driver's order (perm, then h, step by
    step), so a seed gives the JAX driver's matchings."""
    perms = np.empty((n_steps, scfg.n_nodes), np.int32)
    hs = np.empty((n_steps, scfg.n_nodes), np.int32)
    for t in range(n_steps):
        perms[t] = sample_gossip_perm(scfg, graph, rng_np)
        hs[t] = sample_h_counts(scfg, rng_np)
    return perms, hs


def resolve_device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("repro_torch.launch.train: no CUDA device is "
                         "available; pass --device cpu to run the plain "
                         "kernel versions on the CPU")
    return dev


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", default="transformer-wmt")
    ap.add_argument("--algo", default="swarm", choices=["swarm"])
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--H", type=int, default=2)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4,
                    help="per node per local step")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--quantize", action="store_true",
                    help="q8 lattice gossip (quantize_mod + decode_avg)")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale variant of the arch")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="json metrics path")
    return ap


@dataclass
class Trainer:
    """Everything a run needs, built from the parsed flags."""
    args: argparse.Namespace
    device: torch.device
    step: Callable            # the superstep (core/swarm.py)
    state: SwarmState
    ds: SyntheticLMDataset
    perms: np.ndarray         # [steps, nodes] matchings
    hs: np.ndarray            # [steps, nodes] local-step counts
    enc_gen: torch.Generator  # uniforms of the q8 encode
    h_max: int

    def batch(self, t: int) -> dict:
        """Superstep t's batch on the device: [nodes, h_max, batch, seq]."""
        a = self.args
        nb = make_node_batches(self.ds, t, a.batch * self.h_max)
        return {k: torch.from_numpy(v.reshape(a.nodes, self.h_max, a.batch,
                                              a.seq)).to(self.device)
                for k, v in nb.items()}

    def superstep(self, t: int) -> dict:
        self.state, m = self.step(self.state, self.batch(t), self.perms[t],
                                  self.hs[t], self.enc_gen)
        return m


def build(args) -> Trainer:
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg, n_layers=args.layers, d_model=args.d_model)
    ds = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=args.seq, seed=args.seed),
                            n_nodes=args.nodes)
    graph = complete(args.nodes)
    opt = make_optimizer("sgd", lr=args.lr, momentum=0.9,
                         state_dtype=cfg.opt_state_dtype)
    scfg = SwarmConfig(n_nodes=args.nodes, H=args.H, quantize=args.quantize)
    model = TransformerLM(cfg)
    step = make_swarm_step(scfg, model.functional_loss, opt.update,
                           lambda s: args.lr)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    state = swarm_init(gen, scfg, lambda g: init_params(g, cfg, device),
                       opt.init)
    enc_gen = torch.Generator(device=device)
    enc_gen.manual_seed(args.seed + 1)
    perms, hs = presample_inputs(scfg, graph,
                                 np.random.default_rng(args.seed), args.steps)
    return Trainer(args, device, step, state, ds, perms, hs, enc_gen, args.H)


def run(args) -> list:
    """Train as `args` says; -> the logged records."""
    tr = build(args)
    history = []
    t0 = time.time()
    for t in range(args.steps):
        m = tr.superstep(t)
        if t % args.log_every == 0 or t == args.steps - 1:
            rec = {"step": t, "loss": float(m["loss"]),
                   "gamma": float(m["gamma"]),
                   "wall_s": time.time() - t0}
            history.append(rec)
            print(json.dumps(rec), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"args": vars(args), "history": history}, f, indent=1)
    return history


def main(argv=None) -> list:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
