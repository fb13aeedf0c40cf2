"""Serving driver of the port (``repro/launch/serve.py``): one-shot batched
generation (the oracle path) plus the continuous-batching modes over live
swarm models, on the card by default.

One-shot (oracle): prefill a prompt batch, then decode tokens with a KV /
SSM cache (greedy or temperature sampling):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \\
      --batch 8 --prompt-len 512 --gen 64

Continuous batching (serve/engine.py) with hot model swap:

  # follow a (possibly still running) training run's checkpoint dir,
  # written by either package's driver
  ... -m repro_torch.launch.serve --arch transformer-wmt \\
      --source follow --follow runs/swarm --nodes 8 --requests 8

  # serve an in-process live swarm (the port's trainer publishes its
  # mean model every superstep)
  ... -m repro_torch.launch.serve --arch mamba2-780m --reduced \\
      --source live --nodes 4 --live-steps 6 --requests 6

``--weights PATH`` seeds the model from a codec-encoded serving
checkpoint (``serve.export_serving_checkpoint``). The engine flags
(``--slots``, ``--queue-depth``, ``--paged/--no-paged``, ``--page-size``,
``--kv-pages``, ``--prefill-chunk``) override ``EngineConfig``'s defaults
(dense, page 8, blocking prefill); the port reads no environment
variable. ``--device`` defaults to ``cuda``; on a machine with no GPU the
driver exits 1 unless ``--device cpu`` is passed.

Prompts, weights and samples come from three generators seeded from
``--seed`` (init and sampling on the device, prompts on the CPU), so a
seed fixes a run; greedy decoding is deterministic whatever the seed.

On a node mesh with a model axis (``launch/mesh.py`` ``init_node_mesh(...,
model_parallel=K)``: n node groups of K GPUs) the library serves as the
reference's serving mesh does: each node group holds one copy of the
model, split by ``models/split.py`` (``params`` are the rank's slices),
the prompt batch or the requests split over the n groups, and a group's
collectives are the layers' own. The command line stays one GPU:

  mesh = init_node_mesh("cuda", model_parallel=2)      # every rank
  params = init_params(gen, cfg, mesh.device, tp=mesh.model_shard)
  run_oneshot(cfg, args, params, gens, mesh=mesh)      # or run_continuous
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduced
from repro_torch.launch.train import (
    resolve_device, use_expandable_segments,
)
from repro_torch.models import (
    forward, init_cache, init_params, logits_head, param_template,
    shard_template,
)
from repro_torch.models.layers import broadcast_from_model
from repro_torch.tree import tree_map

PROG = "repro_torch.launch.serve"


def make_serve_fns(cfg, tp=None):
    """(prefill, decode_step), each -> (the whole vocabulary's logits, the
    cache); on the model axis (`tp`) a GPU's: its slices, its cache."""
    def prefill(params, tokens, prefix_embeds=None):
        hidden, cache, _ = forward(cfg, params, tokens, mode="prefill",
                                   prefix_embeds=prefix_embeds, tp=tp)
        return logits_head(cfg, params, hidden[:, -1:], tp), cache

    def decode_step(params, cache, tokens):
        hidden, cache, _ = forward(cfg, params, tokens, mode="decode",
                                   cache=cache, tp=tp)
        return logits_head(cfg, params, hidden, tp), cache

    return prefill, decode_step


def sample_token(logits, gen, temperature: float):
    """[B, S, V] logits -> [B] next tokens of the last position: argmax,
    or one draw from `gen` at `temperature`."""
    if temperature <= 0:
        return torch.argmax(logits[:, -1], dim=-1)
    probs = torch.softmax(logits[:, -1] / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0]


def make_generators(seed: int, device) -> dict:
    """Independent streams for init / prompts / sampling / the frontend
    prefix."""
    gens = {}
    for i, (name, dev) in enumerate((("init", device), ("prompts", "cpu"),
                                     ("sample", device),
                                     ("prefix", device))):
        gens[name] = torch.Generator(device=dev)
        gens[name].manual_seed(seed + i)
    return gens


def make_prompts(cfg, n: int, length: int, gen) -> np.ndarray:
    """[n, length] int32 prompts from the CPU generator `gen`."""
    return torch.randint(0, cfg.vocab_size, (n, length), generator=gen,
                         dtype=torch.int32).numpy()


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _node_rows(x, mesh):
    """The rows of `x` (dim 0) a node group serves: its share of n equal
    parts, all of them off a mesh."""
    if mesh is None:
        return x
    n = x.shape[0] // mesh.size
    if n * mesh.size != x.shape[0]:
        raise ValueError(f"a batch of {x.shape[0]} does not split over "
                         f"{mesh.size} node groups")
    return x[mesh.rank * n:(mesh.rank + 1) * n]


def _gather_nodes(x, mesh):
    """Every node group's rows `x`, in node order (`x` off a mesh)."""
    if mesh is None or mesh.size == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts)


def run_oneshot(cfg, args, params, gens, prompts=None, prefix=None,
                mesh=None) -> dict:
    """The one-shot batched path — the serving oracle the engine's tests
    compare against, and the path of a frontend arch. `prompts` ([batch,
    prompt_len] numpy) default to draws from ``gens["prompts"]``; a
    frontend's `prefix` ([batch, n_prefix, d_embed] numpy) to
    ``synth_prefix_embeds`` from ``gens["prefix"]``. On a node `mesh`
    (``params`` the rank's slices with a model axis) each node group
    serves its share of the batch and the tokens are gathered. ->
    {"tokens": [batch, gen] numpy, "finite": every logit finite,
    "prefill_ms", "decode_ms_per_token"}."""
    from repro_torch.models.multimodal import synth_prefix_embeds
    from repro_torch.serve.engine import grow_cache
    tp = None if mesh is None else mesh.model_shard
    prefill, decode_step = make_serve_fns(cfg, tp)
    device = args.device
    if prompts is None:
        prompts = make_prompts(cfg, args.batch, args.prompt_len,
                               gens["prompts"])
    tokens = torch.from_numpy(np.asarray(prompts)).to(device)
    n_prefix = 0
    if cfg.frontend is not None:
        n_prefix = cfg.frontend.n_prefix
        prefix = synth_prefix_embeds(gens["prefix"], cfg, tokens.shape[0],
                                     device) \
            if prefix is None else torch.from_numpy(np.asarray(prefix)).to(
                device)
        prefix = _node_rows(prefix, mesh)
    tokens = _node_rows(tokens, mesh)
    batch, plen = tokens.shape
    _sync(device)
    t0 = time.time()
    logits, cache = prefill(params, tokens, prefix)
    # grow the cache to prefix+prompt+gen capacity (raises on any
    # structural mismatch — serve/engine.py)
    cache = grow_cache(init_cache(cfg, batch, n_prefix + plen + args.gen,
                                  device=device, tp=tp), cache)
    _sync(device)
    t_prefill = time.time() - t0

    def sample(lg):
        return broadcast_from_model(sample_token(
            lg, gens["sample"], args.temperature), tp)[:, None]
    tok = sample(logits)
    out = [tok]
    finite = torch.isfinite(logits).all()
    t0 = time.time()
    for _ in range(args.gen - 1):
        logits, cache = decode_step(params, cache, tok)
        tok = sample(logits)
        out.append(tok)
        finite = finite & torch.isfinite(logits).all()
    _sync(device)
    t_decode = time.time() - t0
    gen = _gather_nodes(torch.cat(out, dim=1), mesh).cpu().numpy()
    batch = gen.shape[0]
    res = {"tokens": gen, "finite": bool(finite),
           "prefill_ms": t_prefill * 1e3,
           "decode_ms_per_token": t_decode / max(args.gen - 1, 1) * 1e3}
    print(f"arch={cfg.name} batch={batch} prompt={plen} gen={args.gen}")
    print(f"prefill {res['prefill_ms']:.1f} ms; decode "
          f"{res['decode_ms_per_token']:.2f} ms/token")
    print("generated tokens[0,:16]:", gen[0, :16].tolist())
    return res


def make_requests(cfg, args, gen):
    from repro_torch.serve import Request
    prompts = make_prompts(cfg, args.requests, args.prompt_len, gen)
    gap = args.arrival_gap_ms / 1e3
    return [(i * gap, Request(i, prompts[i])) for i in range(args.requests)]


def engine_config(args):
    """EngineConfig from the flags; engine flags left unset keep
    EngineConfig's defaults."""
    from repro_torch.serve import EngineConfig
    kw = dict(max_slots=args.slots, prompt_len=args.prompt_len,
              max_new_tokens=args.gen, queue_depth=args.queue_depth,
              temperature=args.temperature, seed=args.seed)
    for name, val in (("paged", args.paged),
                      ("page_size", args.page_size),
                      ("n_pages", args.kv_pages),
                      ("prefill_chunk", args.prefill_chunk)):
        if val is not None:
            kw[name] = val
    return EngineConfig(**kw)


def run_continuous(cfg, args, gens, *, source, params=None, mesh=None):
    """Serve `args.requests` open-loop arrivals from `source` (and/or
    `params` as generation 1); -> (completions, summary). On a node
    `mesh` (`source` and `params` the rank's slices with a model axis)
    node group i serves requests i, i + n, ... and its K GPUs one
    engine (``ServeEngine(..., tp=)``)."""
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.engine import serve_openloop
    engine = ServeEngine(cfg, engine_config(args), params=params,
                         source=source, device=args.device,
                         tp=None if mesh is None else mesh.model_shard)
    # block until the source delivers a first model (a follower pointed at
    # a run dir that hasn't checkpointed yet)
    deadline = engine.clock() + args.wait_s
    while engine.swap.latest() is None:
        engine.poll_source()
        if engine.swap.latest() is not None:
            break
        if engine.clock() > deadline:
            raise TimeoutError(
                f"no model from source after {args.wait_s}s "
                f"(--source {args.source})")
        time.sleep(0.05)
    requests = make_requests(cfg, args, gens["prompts"])
    if mesh is not None:
        requests = requests[mesh.rank::mesh.size]
    completions = serve_openloop(engine, requests)
    summary = engine.metrics.summary()
    print(json.dumps({"serve": summary}), flush=True)
    for c in completions[: min(4, len(completions))]:
        print(f"rid={c.rid} gen={c.gen} tokens[:8]="
              f"{c.tokens[:8].tolist()}")
    return completions, summary


def run_live(cfg, args, gens):
    """Serve an in-process live swarm: the port's own trainer (swarm, H 1,
    exact gossip, seq 32) is the producer, publishing the swarm mean
    through LiveSource at every superstep; the engine consumes snapshots
    between request waves. -> (completions, summary)."""
    from repro_torch.core.exchange import transport_from_config
    from repro_torch.launch import train
    from repro_torch.serve import LiveSource, ServeEngine
    targs = train.build_parser().parse_args([
        "--algo", "swarm", "--nodes", str(args.nodes), "--H", "1",
        "--lr", "0.05", "--steps", str(args.live_steps), "--batch",
        str(args.batch), "--seq", "32", "--seed", str(args.seed),
        "--device", args.device])
    tr = train.build(targs, cfg)
    src = LiveSource(transport_from_config(tr.scfg))
    src.publish(tr.state.params)
    done = []

    def train_some(n):
        for t in range(len(done), min(len(done) + n, args.live_steps)):
            tr.superstep(t)
            src.publish(tr.state.params)
            done.append(t)

    # interleave: a few supersteps, then serve a request wave, repeat
    engine = ServeEngine(cfg, engine_config(args), source=src,
                         device=args.device)
    reqs = make_requests(cfg, args, gens["prompts"])
    waves = max(1, args.live_steps // 2)
    per = max(1, len(reqs) // waves)
    for w in range(0, len(reqs), per):
        train_some(2)
        for _, r in reqs[w:w + per]:
            engine.submit(r)
        engine.drain()
    summary = engine.metrics.summary()
    print(json.dumps({"serve": summary}), flush=True)
    gens_served = sorted({c.gen for c in engine.completions})
    print(f"served {len(engine.completions)} requests across model "
          f"generations {gens_served}")
    return engine.completions, summary


def params_like(cfg, tp=None):
    """The model's parameter tree as meta tensors: shapes and dtypes; on
    the model axis (`tp`) a GPU's slices."""
    dtype = getattr(torch, cfg.dtype)
    return tree_map(lambda i: torch.empty(i.shape, dtype=dtype,
                                          device="meta"),
                    param_template(cfg) if tp is None
                    else shard_template(cfg, tp.size))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog=PROG)
    ap.add_argument("--arch", default="mamba2-780m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    # model source
    ap.add_argument("--source", choices=["oneshot", "follow", "live"],
                    default="oneshot",
                    help="oneshot: random-init batch generation (oracle); "
                         "follow: continuous batching over a run dir's "
                         "checkpoints; live: serve an in-process swarm")
    ap.add_argument("--follow", default=None, metavar="RUNDIR",
                    help="checkpoint dir to follow (implies "
                         "--source follow)")
    ap.add_argument("--weights", default=None,
                    help="serving checkpoint (export_serving_checkpoint) "
                         "to seed the model from")
    ap.add_argument("--nodes", type=int, default=4,
                    help="swarm width of the followed/live run")
    # engine knobs
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--queue-depth", type=int, default=8)
    ap.add_argument("--paged", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="paged KV cache (serve/paged.py); default off")
    ap.add_argument("--page-size", type=int, default=None,
                    help="KV rows per page; default 8")
    ap.add_argument("--kv-pages", type=int, default=None,
                    help="global page-pool size; 0 (default) = every lane "
                         "at full capacity (no saving, no deferral)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="tokens per prefill chunk; 0 (default) = "
                         "blocking admission")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--arrival-gap-ms", type=float, default=10.0)
    ap.add_argument("--wait-s", type=float, default=30.0)
    ap.add_argument("--live-steps", type=int, default=6)
    return ap


def main(argv=None):
    """Run the command line `argv`; -> the run's result (one-shot: the
    tokens and timings; follow / live: (completions, summary))."""
    use_expandable_segments()
    args = build_parser().parse_args(argv)
    if args.follow:
        args.source = "follow"
    device = resolve_device(args.device, PROG)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg, n_layers=args.layers, d_model=args.d_model)
    gens = make_generators(args.seed, device)
    if args.source == "live":
        return run_live(cfg, args, gens)
    params = None
    if args.weights:
        from repro_torch.serve import load_serving_checkpoint
        params = load_serving_checkpoint(args.weights, params_like(cfg),
                                         device=device)
    if args.source == "oneshot":
        if params is None:
            params = init_params(gens["init"], cfg, device)
        return run_oneshot(cfg, args, params, gens)
    from repro_torch.serve import CheckpointFollower
    follower = CheckpointFollower(args.follow, params_like(cfg), args.nodes,
                                  device=device)
    return run_continuous(cfg, args, gens, source=follower, params=params)


if __name__ == "__main__":
    main(sys.argv[1:])
