"""Model sources for the serving subsystem (``repro/serve/source.py``).

The server never blocks training and training never blocks the server. A
*model source* is the one-way bridge — ``poll()`` returns a fresh
single-model param tree when (and only when) a newer one exists:

* :class:`CheckpointFollower` polls a run directory for checkpoints that
  either package's training driver lands (``launch/train.py --ckpt
  --ckpt-every``) and materializes the swarm's MEAN model from each.
  Three formats are understood:

    - plain checkpoints (node-stacked params),
    - codec-state checkpoints (``{"params", "prev"[, "residual"]}`` from a
      quantized run; ``prev`` is the wire tuple under ``--compress-state``),
      of which only the params are read into the mean,
    - *serving* checkpoints (:func:`export_serving_checkpoint`): the mean
      model's flat buffer ENCODED with a wire codec — the codec layer as a
      compressed weight-distribution format. Decoding routes through
      ``WireCodec.decode`` — the ``decode_avg`` kernel with its average
      off on the card, the training-side receive path — so the loaded
      weights are bitwise the value training would decode from the same
      wire.

* :class:`LiveSource` snapshots an in-training swarm WITHOUT a filesystem
  round trip: the training loop calls ``publish(state.params)`` at a
  superstep boundary, the snapshot is ``GossipTransport.global_mean`` on
  the packed flat buffer, and the server polls it like any other source.

Both deliver :class:`ModelUpdate` records carrying a monotone version and
the wall-clock time the model *landed* (the time-to-fresh-model metric).

On a node split over K GPUs each GPU's source delivers its own slices
(``models/transformer.py`` ``param_split``): a follower built with `tp`
and `split` reads each leaf of a checkpoint on the host and keeps only
the GPU's slice of every node's row, so that no GPU holds the whole
model; a live source is handed the rank's own slices. Both take
``poll(tag=...)``: the update with that tag, the one the node's model
index 0 took (``serve/engine.py``). A codec-encoded serving checkpoint
on a split node is refused (``models/split.py``
``NOT_ON_THE_MODEL_AXIS``).
"""
from __future__ import annotations

import glob
import json
import os
import time
import zipfile
from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.checkpoint import (
    load_checkpoint, load_metadata, mean_model_tree, save_checkpoint,
)
from repro_torch.core import bucket as B
from repro_torch.quant.codecs import make_codec
from repro_torch.tree import tree_leaves, tree_map


@dataclass
class ModelUpdate:
    """One fresh model delivered by a source."""
    params: Any            # single-model param tree, serving dtype
    version: int           # monotone per source
    t_landed: float        # wall clock the model became available
    tag: str = ""          # provenance (checkpoint path / "live:<n>")


def _like(shape, dtype, device):
    """A template leaf for ``load_checkpoint``: shape, dtype and device,
    no memory (a broadcast scalar)."""
    return torch.empty((), dtype=dtype, device=device).expand(shape)


# ---------------------------------------------------------------------------
# Codec-encoded serving checkpoints: the wire format as a weight format
# ---------------------------------------------------------------------------


def export_serving_checkpoint(path: str, params, codec_spec: str, *,
                              seed: int = 0, metadata: dict | None = None):
    """Encode a SINGLE-model param tree with a wire codec and persist the
    wire groups — the codec layer as a weight-distribution format.

    The flat [n_padded] buffer is encoded against a ZERO reference: the
    lattice scale then bounds ``safety * max|x| / 2^(bits-1)`` per block,
    so the distance criterion holds by construction and the
    zero-reference decode always lands on the right lattice point. The
    stochastic rounding draws from a generator seeded with `seed` (the
    reference's jax.random draws differ; either package loads the other's
    files). Returns the exact serialized wire bytes."""
    codec = make_codec(codec_spec)
    flat = B.build_flat_layout(params, block=codec.block)
    buf = B.pack_flat(flat, params)
    gen = torch.Generator(device=buf.device)
    gen.manual_seed(seed)
    # EF codecs too: no residual exists for a one-shot export, so the
    # plain encode (top-k of x - 0) is the right sender half
    wire = codec.encode(buf, torch.zeros_like(buf), gen)
    names = [g.name for g in codec.wire_layout().groups]
    tree = {f"wire_{n}": w for n, w in zip(names, wire)}
    meta = dict(metadata or {})
    meta.update({"serving_codec": codec.name, "serving_spec": codec_spec,
                 "wire_groups": names, "n_padded": flat.n_padded})
    save_checkpoint(path, tree, meta)
    return sum(w.numel() * w.element_size() for w in wire)


def _wire_dtype(name: str):
    return torch.bfloat16 if name == "bfloat16" else getattr(torch, name)


def load_serving_checkpoint(path: str, params_like, *, device=None):
    """Inverse of :func:`export_serving_checkpoint`: decode the persisted
    wire back into a param tree shaped/dtyped like `params_like`, on
    `device` (default: `params_like`'s). The decode is ``WireCodec.decode``
    against the same zero reference — the training-side kernel path with
    its fused average switched off."""
    meta = load_metadata(path)
    codec = make_codec(meta["serving_spec"])
    flat = B.build_flat_layout(params_like, block=codec.block)
    if flat.n_padded != meta["n_padded"]:
        raise ValueError(
            f"serving checkpoint {path}: encoded for n_padded="
            f"{meta['n_padded']}, model wants {flat.n_padded}")
    if device is None:
        device = tree_leaves(params_like)[0].device
    rows = flat.n_padded // codec.block
    like = {f"wire_{g.name}": _like((rows, g.cols), _wire_dtype(g.dtype),
                                    device)
            for g in codec.wire_layout().groups}
    tree = load_checkpoint(path, like)
    wire = tuple(tree[f"wire_{n}"] for n in meta["wire_groups"])
    zero = torch.zeros((flat.n_padded,), dtype=torch.float32, device=device)
    return B.unpack_flat(flat, codec.decode(wire, zero).reshape(-1))


# ---------------------------------------------------------------------------
# CheckpointFollower — poll a run directory, materialize the mean model
# ---------------------------------------------------------------------------


class CheckpointFollower:
    """Follow the checkpoints of a (possibly still running) training run.

    `run_dir` is scanned for ``<name>.json`` + ``<name>.npz`` pairs (the
    checkpoint format both packages write); the json is written LAST, so
    its presence marks a complete pair. Files are ordered by name (the
    drivers' ``--ckpt-every`` stamps zero-padded step numbers), and
    ``poll()`` returns at most one update — the newest unseen checkpoint —
    materialized as a single mean-model tree. A half-written or vanished
    checkpoint is skipped and retried on the next poll: the server must
    never crash because training was mid-save.

    `params_like` is a single-model param tree (tensors, meta tensors
    allowed) fixing the serving structure and dtypes; `device` is where
    the model lands; `n_nodes` the swarm width of the followed run
    (checked against the checkpoint's own metadata when present). On a
    node split over the model axis (`tp`) `params_like` is the GPU's
    slices and `split` each leaf's split dimension (``param_split``).
    """

    def __init__(self, run_dir: str, params_like, n_nodes: int, *,
                 device="cuda", tp=None, split=None):
        self.run_dir = run_dir
        self.device = torch.device(device)
        self.params_like = tree_map(
            lambda x: _like(tuple(x.shape), x.dtype, self.device),
            params_like)
        self.n_nodes = n_nodes
        self.tp, self.split = tp, split
        self._seen: set[str] = set()
        self._version = 0

    def _candidates(self):
        paths = []
        for j in glob.glob(os.path.join(self.run_dir, "*.json")):
            base = j[:-len(".json")]
            if os.path.exists(base + ".npz"):
                paths.append(base)
        return sorted(paths)

    def _stacked_like(self):
        return tree_map(lambda s: _like((self.n_nodes,) + tuple(s.shape),
                                        s.dtype, self.device),
                        self.params_like)

    def _materialize(self, base: str):
        meta = load_metadata(base)
        if meta.get("nodes") is not None and \
                int(meta["nodes"]) != self.n_nodes:
            raise ValueError(
                f"checkpoint {base}: trained with {meta['nodes']} nodes, "
                f"follower configured for {self.n_nodes}")
        if "serving_spec" in meta:
            if self.tp is not None:
                from repro_torch.models.split import NOT_ON_THE_MODEL_AXIS
                raise ValueError(f"serving checkpoint {base}: "
                                 f"{NOT_ON_THE_MODEL_AXIS['serve']}")
            return load_serving_checkpoint(base, self.params_like)
        stacked = self._stacked_like()
        if self.tp is not None:
            # the params lead the flatten order of a codec-state
            # checkpoint ({"params", "prev", "residual"}): only they are
            # read, each cut to this GPU's slices
            return mean_model_tree(load_checkpoint(
                base, stacked, split=self.split, shard=self.tp))
        if "codec" in meta:
            # codec-state checkpoint: params ride beside the comm copy /
            # EF residual — only the params matter for serving
            like = {"params": stacked}
            codec = make_codec(meta["codec"]["spec"])
            layout = B.build_layout(stacked, block=codec.block)
            if "prev" in meta["codec"]["state"]:
                if meta["codec"].get("compress_state"):
                    # --compress-state runs checkpoint `prev` as the codec
                    # WIRE tuple, node-contiguous blocked rows
                    rows = self.n_nodes * (layout.n_padded // codec.block)
                    like["prev"] = tuple(
                        _like((rows, g.cols), _wire_dtype(g.dtype),
                              self.device)
                        for g in codec.wire_layout().groups)
                else:
                    like["prev"] = self._stacked_like()
            if "residual" in meta["codec"]["state"]:
                like["residual"] = _like((self.n_nodes, layout.n_padded),
                                         torch.float32, self.device)
            stacked = load_checkpoint(base, like)["params"]
        else:
            stacked = load_checkpoint(base, stacked)
        return mean_model_tree(stacked)

    def poll(self, tag: Optional[str] = None) -> Optional[ModelUpdate]:
        """The newest unseen checkpoint, or with `tag` that one (None
        until it is complete), as the mean model."""
        fresh = [p for p in self._candidates() if p not in self._seen]
        if tag is not None:
            fresh = fresh[:fresh.index(tag) + 1] if tag in fresh else []
        if not fresh:
            return None
        base = fresh[-1]
        try:
            t_landed = os.path.getmtime(base + ".json")
            params = self._materialize(base)
        except (OSError, EOFError, zipfile.BadZipFile,
                json.JSONDecodeError, KeyError):
            # mid-write race (vanished file, truncated npz/json): retry
            # next poll. Shape/width mismatches are ValueErrors and RAISE —
            # a misconfigured follower must not look like an empty run dir
            return None
        self._seen.update(fresh)           # older unseen ckpts are stale now
        self._version += 1
        return ModelUpdate(params, self._version, t_landed, tag=base)


# ---------------------------------------------------------------------------
# LiveSource — in-process snapshots of a running swarm
# ---------------------------------------------------------------------------


class LiveSource:
    """Serve the live swarm without a filesystem round trip.

    The TRAINING loop is the producer: at a superstep boundary it calls
    ``publish(state.params)``; the snapshot is the transport's
    ``global_mean`` on the packed flat buffer (every node's lane holds μ
    after one reduction — bitwise the checkpoint follower's
    ``mean_model_tree``), and node 0's lane is kept as the single serving
    model. ``poll()`` hands the newest unconsumed snapshot to the engine;
    publishing twice between polls keeps only the newest. On a split
    node the training loop publishes the rank's own slices, and the mean
    is theirs."""

    def __init__(self, transport):
        self.transport = transport
        self._pending: Optional[ModelUpdate] = None
        self._version = 0

    def publish(self, params_stacked, t_landed: Optional[float] = None):
        mean = self.transport.global_mean(params_stacked)
        single = tree_map(lambda x: x[0].clone(), mean)
        self._version += 1
        self._pending = ModelUpdate(single, self._version,
                                    t_landed if t_landed is not None
                                    else time.time(),
                                    tag=f"live:{self._version}")
        return self._version

    def poll(self, tag: Optional[str] = None) -> Optional[ModelUpdate]:
        """The newest unconsumed snapshot, or with `tag` only that one."""
        if tag is not None and (self._pending is None or
                                self._pending.tag != tag):
            return None
        upd, self._pending = self._pending, None
        return upd
