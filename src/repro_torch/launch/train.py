"""Training driver for the port: SwarmSGD or any of the paper's baselines
(gather transport) on the synthetic LM stream, on the card by default.

  PYTHONPATH=src python -m repro_torch.launch.train --arch transformer-wmt \
      --nodes 8 --H 2 --h-mode geometric --h-max 8 --quantize \
      --nonblocking --overlap --non-iid 0.5 --eval-mean --steps 4 \
      --ckpt ckpts --ckpt-every 2
  PYTHONPATH=src python -m repro_torch.launch.train --nodes 8 \
      --algo dpsgd --graph ring

``--algo`` is swarm (the default), allreduce, localsgd, dpsgd, adpsgd or
sgp; every combination is checked against the capability matrix
(``repro_torch.algorithms``) before anything is built.

prints one JSON record per logged superstep with the JAX driver's keys
(``step``, ``loss``, ``gamma``, ``wall_s``, and with ``--eval-mean`` the
mean-model losses) and writes checkpoints in the JAX package's format.
``--device cpu`` runs the plain kernel versions on the CPU; without it a
machine with no GPU exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.algorithms import (
    ALGORITHMS, AlgoCaps, make_algorithm, validate_run_config,
)
from repro_torch.algorithms.sgp import sgp_debias, sgp_init_state
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config, reduced
from repro_torch.core.exchange import transport_from_config
from repro_torch.core.graph import GRAPH_KINDS, make_graph, sample_matching
from repro_torch.core.swarm import (
    SwarmConfig, SwarmState, codec_checkpoint_tree, make_mean_model_eval,
    pipeline_epilogue, sample_h_counts, swarm_init,
)
from repro_torch.data import DataConfig, SyntheticLMDataset, make_node_batches
from repro_torch.models import TransformerLM, init_params
from repro_torch.optim import make_optimizer


def sample_gossip_perm(scfg: SwarmConfig, graph, rng_np) -> np.ndarray:
    """Per-superstep matching of the gather transport."""
    return sample_matching(graph, rng_np)


def presample_inputs(scfg: SwarmConfig, graph, rng_np, n_steps: int,
                     uses_matching: bool = True):
    """The whole run's (perm, h) streams as [n_steps, n_nodes] int32,
    drawn from `rng_np` in the JAX driver's order (perm, then h, step by
    step), so a seed gives the JAX driver's matchings and counts. An
    algorithm that ignores the matching still draws one each step, as the
    reference does, so its h stream is the reference's too."""
    perms = np.empty((n_steps, scfg.n_nodes), np.int32)
    hs = np.empty((n_steps, scfg.n_nodes), np.int32)
    for t in range(n_steps):
        perms[t] = (sample_gossip_perm(scfg, graph, rng_np) if uses_matching
                    else sample_matching(graph, rng_np))
        hs[t] = sample_h_counts(scfg, rng_np)
    return perms, hs


def resolve_device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("repro_torch.launch.train: no CUDA device is "
                         "available; pass --device cpu to run the plain "
                         "kernel versions on the CPU")
    if dev.type == "cuda":
        # D-PSGD's mixing product is fp32, as the reference's: never TF32
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", default="transformer-wmt")
    ap.add_argument("--algo", default="swarm", choices=sorted(ALGORITHMS))
    ap.add_argument("--graph", default="complete", choices=GRAPH_KINDS,
                    help="interaction graph of the matchings (and of "
                         "D-PSGD's mixing)")
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--H", type=int, default=2)
    ap.add_argument("--h-mode", default="fixed",
                    choices=["fixed", "geometric"])
    ap.add_argument("--h-max", type=int, default=8,
                    help="local-step loop bound of the geometric mode")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4,
                    help="per node per local step")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--quantize", action="store_true",
                    help="q8 lattice gossip (quantize_mod + decode_avg)")
    ap.add_argument("--nonblocking", action="store_true",
                    help="Algorithm 2: average the superstep-start models")
    ap.add_argument("--overlap", action="store_true",
                    help="pipelined non-blocking superstep: the in-flight "
                         "payload's permute runs under the local steps "
                         "(implies --nonblocking)")
    ap.add_argument("--non-iid", type=float, default=None,
                    help="Dirichlet alpha for per-node data skew")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale variant of the arch")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--eval-mean", action="store_true",
                    help="also evaluate the true average model μ (paper §5)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint every N steps into --ckpt (a directory "
                         "of step_NNNNNN checkpoints); 0 = one final "
                         "checkpoint at --ckpt")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="json metrics path")
    return ap


@dataclass
class Trainer:
    """Everything a run needs, built from the parsed flags."""
    args: argparse.Namespace
    device: torch.device
    cfg: object               # model config
    caps: AlgoCaps            # the algorithm's capability row
    scfg: SwarmConfig
    step: Callable            # the superstep (algorithms registry)
    state: SwarmState
    ds: SyntheticLMDataset
    perms: np.ndarray         # [steps, nodes] matchings
    hs: np.ndarray            # [steps, nodes] local-step counts
    enc_gen: torch.Generator  # uniforms of the q8 encode
    evaluate: Optional[Callable] = None   # --eval-mean

    @property
    def h_max(self) -> int:
        return self.scfg.h_loop_bound

    def node_batches(self, t: int) -> dict:
        """Superstep t's batch as numpy [nodes, h_max * batch, seq]."""
        return make_node_batches(self.ds, t, self.args.batch * self.h_max)

    def batch(self, t: int, nb: Optional[dict] = None) -> dict:
        """Superstep t's batch on the device: [nodes, h_max, batch, seq]."""
        a = self.args
        nb = self.node_batches(t) if nb is None else nb
        return {k: torch.from_numpy(v.reshape(a.nodes, self.h_max, a.batch,
                                              a.seq)).to(self.device)
                for k, v in nb.items()}

    def superstep(self, t: int, nb: Optional[dict] = None) -> dict:
        self.state, m = self.step(self.state, self.batch(t, nb),
                                  self.perms[t], self.hs[t], self.enc_gen)
        return m

    def eval_mean(self, nb: dict) -> dict:
        """The mean-model losses on node 0's batch of the step, as the JAX
        driver evaluates them."""
        seq = self.args.seq
        eb = {k: torch.from_numpy(nb[k][0].reshape(-1, seq)).to(self.device)
              for k in ("tokens", "targets")}
        params = self.state.params
        if self.args.algo == "sgp":
            # the push-sum payload evaluates at the de-biased X / w
            params = sgp_debias(params)
        return {k: float(v) for k, v in self.evaluate(params, eb).items()}

    def write_ckpt(self, path: str, step_no: int) -> None:
        """One checkpoint-writing path for final and periodic saves, with
        the JAX driver's metadata. A quantized run saves its codec state
        beside the params; an overlapped one drains it first through
        `pipeline_epilogue` on a copy, the training state flowing on."""
        a = self.args
        meta = {"arch": self.cfg.name, "algo": a.algo, "steps": a.steps,
                "nodes": a.nodes, "step": step_no}
        ck_state = self.state
        if a.quantize:
            if self.scfg.overlap:
                ck_state = pipeline_epilogue(self.scfg, ck_state)
            tree = codec_checkpoint_tree(ck_state)
            meta["codec"] = {"spec": "q8", "state": sorted(tree),
                             "compress_state": False}
            save_checkpoint(path, tree, meta)
        else:
            save_checkpoint(path, ck_state.params, meta)


def build(args, cfg=None) -> Trainer:
    """The trainer the flags describe; `cfg`, when given, is the model
    config in place of the one --arch / --reduced name. One construction
    path for every algorithm: the capability matrix validates the flags,
    one transport is built, and the step comes from `make_algorithm`."""
    caps = validate_run_config(args.algo, quantize=args.quantize,
                               nonblocking=args.nonblocking,
                               overlap=args.overlap)
    device = resolve_device(args.device)
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = reduced(cfg, n_layers=args.layers, d_model=args.d_model)
    ds = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=args.seq, seed=args.seed,
                                       non_iid_alpha=args.non_iid),
                            n_nodes=args.nodes)
    graph = make_graph(args.graph, args.nodes)
    opt = make_optimizer("sgd", lr=args.lr, momentum=0.9,
                         state_dtype=cfg.opt_state_dtype)
    # algorithms that interact every step take exactly one batch slot; the
    # h-consuming ones (swarm, localsgd) keep the variable h modes
    H, h_mode = (args.H, args.h_mode) if caps.local_H else (1, "fixed")
    scfg = SwarmConfig(n_nodes=args.nodes, H=H, h_mode=h_mode,
                       h_max=args.h_max,
                       nonblocking=args.nonblocking or args.overlap,
                       overlap=args.overlap, quantize=args.quantize)
    model = TransformerLM(cfg)
    kw = dict(loss_fn=model.functional_loss, opt_update=opt.update,
              lr_fn=lambda s: args.lr, n_nodes=args.nodes,
              transport=transport_from_config(scfg))
    if args.algo == "swarm":
        kw["scfg"] = scfg
    else:
        if args.algo == "localsgd":
            kw.update(H=args.H, h_max=scfg.h_loop_bound)
        if args.algo == "dpsgd":
            kw["graph"] = graph
        if caps.quantized:
            kw["quantize"] = args.quantize
        if "nonblocking" in caps.modes:
            kw["nonblocking"] = args.nonblocking
    step = make_algorithm(args.algo, **kw)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    state = swarm_init(gen, scfg, lambda g: init_params(g, cfg, device),
                       opt.init)
    if args.algo == "sgp":
        state = sgp_init_state(state, args.nodes, args.quantize)
    enc_gen = torch.Generator(device=device)
    enc_gen.manual_seed(args.seed + 1)
    perms, hs = presample_inputs(scfg, graph,
                                 np.random.default_rng(args.seed), args.steps,
                                 caps.uses_matching)
    evaluate = make_mean_model_eval(model.functional_loss) \
        if args.eval_mean else None
    return Trainer(args, device, cfg, caps, scfg, step, state, ds, perms, hs,
                   enc_gen, evaluate)


def run(args, tr: Optional[Trainer] = None) -> list:
    """Train as `args` says (with the trainer `tr` when given, else the
    one `build` makes); -> the logged records."""
    tr = tr or build(args)
    history = []

    def periodic_ckpt(step_no):
        os.makedirs(args.ckpt, exist_ok=True)
        tr.write_ckpt(os.path.join(args.ckpt, f"step_{step_no:06d}"),
                      step_no)

    t0 = time.time()
    for t in range(args.steps):
        nb = tr.node_batches(t)
        m = tr.superstep(t, nb)
        if t % args.log_every == 0 or t == args.steps - 1:
            rec = {"step": t, "loss": float(m["loss"]),
                   "gamma": float(m.get("gamma", 0.0)),
                   "wall_s": time.time() - t0}
            if args.eval_mean:
                rec.update(tr.eval_mean(nb))
            history.append(rec)
            print(json.dumps(rec), flush=True)
        if args.ckpt and args.ckpt_every and (t + 1) % args.ckpt_every == 0:
            periodic_ckpt(t + 1)
    if args.ckpt:
        if args.ckpt_every:
            path = os.path.join(args.ckpt, f"step_{args.steps:06d}")
            if args.steps % args.ckpt_every:      # else the loop wrote it
                periodic_ckpt(args.steps)
        else:
            path = args.ckpt
            tr.write_ckpt(path, args.steps)
        print("checkpoint ->", path, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"args": vars(args), "history": history,
                       "hs": tr.hs.tolist()}, f, indent=1)
    return history


def main(argv=None) -> list:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
