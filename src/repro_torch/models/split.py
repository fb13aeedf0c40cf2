"""The model axis of a SwarmSGD node: how a node's parameters split over
its K GPUs (counterpart of the sharding rules of ``repro/launch/specs.py``
for the dense and MoE archs, in training and in serving: the reference's
``role="serve"`` takes the same parameter rules).

In the reference's production layout a node is a tensor-parallel island
of 16 chips whose mesh axis ``"model"`` carries the split;
:func:`logical_rules` maps each parameter's logical axes onto it. In the
port a node is K GPUs of a node mesh (``launch/mesh.py``
``init_node_mesh(..., model_parallel=K)``; the mesh's node axes are
``launch/specs.py``'s); the same rules say which dimension of each
leaf of ``param_template(cfg)`` is cut into K equal slices
(``models/transformer.py`` ``param_split``) and which leaves every GPU of
the node holds whole ("replicated", None).

The dense rules, as the reference's: ``ffn``, ``heads_x_dim`` and
``vocab`` (where the vocabulary divides by K) on the model axis;
``embed``, ``layers`` and the unnamed axes (norm scales, ``q_norm`` /
``k_norm``, the frontend's ``proj``) replicated.

The MoE rules, as the reference's (``specs.py:45-53``, ``:86-88``):
``expert`` on the model axis where ``cfg.moe.expert_shard_axis`` is
"model" (qwen3-moe-30b-a3b: each GPU holds E/K whole experts), None
otherwise (a "data" expert axis is a node axis outside ``big_model``);
``expert_ffn`` on the model axis where ``expert`` is not
(granite-moe-3b-a800m, whose 40 experts do not divide 16: each GPU holds
every expert's d_ff slice); ``expert_unsharded`` (the router) replicated.
K must divide the axis it cuts (:func:`check_model_parallel`).

The port's deviation (``kv_x_dim``): heads are split whole. K must divide
``n_heads``; where it also divides ``n_kv_heads`` the kv heads split with
the q heads, as the reference's. Where ``n_kv_heads < K`` (gemma3-4b and
chatglm3-6b at K 8, chatglm3-6b at K 4, paligemma-3b at any K) the
reference cuts ``kv_x_dim`` inside a head; the port keeps ``wk`` / ``wv``
replicated, and each GPU computes only the kv heads its own q heads read
(``models/transformer.py`` ``_local_kv``), its partial gradient of the
replicated weight summed over the node's GPUs. :func:`kv_deviation` names
the cases.

Serving caches the same heads (:func:`kv_heads_of`): each GPU's attention
and sliding-window caches hold the kv heads its q heads read, the
reference's ``cache_pspec(layout="headdim")`` with the kv heads on the
model axis wherever K divides ``n_kv_heads``; where ``n_kv_heads < K``
the reference cuts ``head_dim`` instead, and the port keeps a whole kv
head, cached alike by the K / n_kv_heads GPUs that read it.

What the model axis does not carry yet raises ``ValueError`` naming its
ROADMAP.md Queue A item (:data:`NOT_ON_THE_MODEL_AXIS`).

FUNCTIONS only: importing this module touches no device state.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

MODEL_AXIS = "model"

#: What the model axis does not carry yet, each refusal naming the
#: ROADMAP.md item that carries it.
NOT_ON_THE_MODEL_AXIS = {
    "ssm": ("the SSM rules (ssm_proj, ssm_conv, ssm_inner, ssm_head) on "
            "the model axis wait for ROADMAP.md Queue A 12"),
    "big_model": ("the big_model layout (a node is a whole pod) waits for "
                  "ROADMAP.md Queue A 13"),
    "serve": ("on the model axis serving keeps each GPU's kv heads in its "
              "cache (the reference's cache_pspec layout 'headdim'); the "
              "sequence-split decode (layout 'seqshard', a batch-1 "
              "cache's sequence over the node axis), --weights serving "
              "checkpoints on a split node and --source live on a mesh "
              "wait for ROADMAP.md Queue A 18"),
    "run": ("on the model axis the swarm's blocking, non-blocking and "
            "overlapped supersteps run, on the gather or ppermute transport "
            "or its per-leaf oracle, exact or with the q8 lattice; the "
            "baselines, --scan-chunk, ppermute_pool, the other codecs, "
            "--compress-state and the scheduler wait for ROADMAP.md Queue "
            "A 15"),
}


def check_model_parallel(cfg, model_parallel: int) -> None:
    """Raise ValueError where the port does not split `cfg`'s node over
    `model_parallel` GPUs: an arch the model axis does not carry (naming
    its ROADMAP.md item), heads that do not divide, or an FFN width, an
    expert count or an expert's d_ff that does not."""
    K = int(model_parallel)
    if K < 1:
        raise ValueError(f"model_parallel={K}: a node holds 1 or more GPUs")
    if K == 1:
        return
    if cfg.big_model:
        raise ValueError(f"{cfg.name}: {NOT_ON_THE_MODEL_AXIS['big_model']}")
    if cfg.ssm is not None or any(m == "mamba" for m, _ in
                                  cfg.pattern + cfg.tail_pattern):
        raise ValueError(f"{cfg.name}: {NOT_ON_THE_MODEL_AXIS['ssm']}")
    if cfg.n_heads % K:
        raise ValueError(
            f"{cfg.name}: model_parallel={K} does not divide n_heads="
            f"{cfg.n_heads}; the port splits heads whole (the reference "
            "would cut heads_x_dim inside a head)")
    if cfg.n_kv_heads % K and K % cfg.n_kv_heads:
        raise ValueError(
            f"{cfg.name}: model_parallel={K} and n_kv_heads="
            f"{cfg.n_kv_heads}: one must divide the other, so that each "
            "GPU's q heads read whole kv heads")
    if cfg.d_ff % K:
        raise ValueError(f"{cfg.name}: model_parallel={K} does not divide "
                         f"d_ff={cfg.d_ff}")
    if cfg.moe is not None:
        if expert_split(cfg):
            if cfg.moe.n_experts % K:
                raise ValueError(
                    f"{cfg.name}: model_parallel={K} does not divide "
                    f"n_experts={cfg.moe.n_experts} (the expert split)")
        elif cfg.moe.d_ff % K:
            raise ValueError(
                f"{cfg.name}: model_parallel={K} does not divide the "
                f"experts' d_ff={cfg.moe.d_ff} (the expert_ffn split)")


def expert_split(cfg) -> bool:
    """True where the model axis cuts the expert axis (each GPU E/K whole
    experts), False where it cuts each expert's d_ff (``expert_ffn``)."""
    return cfg.moe.expert_shard_axis == MODEL_AXIS


def kv_deviation(cfg, model_parallel: int) -> bool:
    """True where the port keeps ``wk`` / ``wv`` replicated and the
    reference cuts ``kv_x_dim`` over the model axis: n_kv_heads < K."""
    return model_parallel > 1 and cfg.n_kv_heads % model_parallel != 0


def kv_heads_of(cfg, model_parallel: int, index: int):
    """[lo, hi): the kv heads GPU `index` of a node over `model_parallel`
    GPUs reads, its q heads' groups (every kv head at K 1)."""
    nh = cfg.n_heads // model_parallel
    group = cfg.n_heads // cfg.n_kv_heads
    return (index * nh) // group, ((index + 1) * nh - 1) // group + 1


def logical_rules(cfg, mesh: Dict[str, int]) -> Dict[Optional[str],
                                                       Optional[str]]:
    """Logical axis name -> mesh axis (or None) for the dense and MoE
    axes (``specs.py:43``), with the port's kv rule
    (:func:`kv_deviation`); `mesh` maps axis names to sizes, as
    ``{"data": n, "model": K}``."""
    K = mesh[MODEL_AXIS]
    check_model_parallel(cfg, K)
    expert = MODEL_AXIS if cfg.moe is not None and expert_split(cfg) \
        else None
    return {
        None: None,
        "layers": None,
        "embed": None,
        "vocab": MODEL_AXIS if cfg.vocab_size % K == 0 else None,
        "ffn": MODEL_AXIS,
        "heads_x_dim": MODEL_AXIS,
        "kv_x_dim": None if kv_deviation(cfg, K) else MODEL_AXIS,
        "expert": expert,
        "expert_ffn": MODEL_AXIS if expert is None else None,
        "expert_unsharded": None,
    }


def take_slice(x, dim, model_parallel: int, index: int):
    """GPU `index`'s slice of the leaf `x` (a tensor or an array) along
    `dim`, a fresh contiguous copy; `x` itself where `dim` is None."""
    if dim is None:
        return x
    n = x.shape[dim] // model_parallel
    part = x[(slice(None),) * dim + (slice(index * n, (index + 1) * n),)]
    if isinstance(part, torch.Tensor):
        return part.clone(memory_format=torch.contiguous_format)
    return np.ascontiguousarray(part)
