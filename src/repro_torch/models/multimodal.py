"""Modality frontend stubs (``repro/models/multimodal.py``).

No ViT / SigLIP or EnCodec codec is implemented: a caller supplies
precomputed patch / frame embeddings of the right shape. This module
holds the learned projector that maps them into the decoder's width and
a seeded stand-in for them.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import ParamInfo


def frontend_template(cfg):
    f = cfg.frontend
    return {"proj": ParamInfo((f.d_embed, cfg.d_model), (None, "embed"))}


def project_prefix(params, prefix_embeds, dtype):
    """[B, P, d_embed] embeddings -> [B, P, d_model] in `dtype`."""
    return torch.matmul(prefix_embeds.to(dtype), params["proj"])


def synth_prefix_embeds(gen: torch.Generator, cfg, batch: int, device):
    """Stand-in for SigLIP patches / EnCodec frames, drawn from `gen` (a
    generator on `device`)."""
    f = cfg.frontend
    return torch.randn((batch, f.n_prefix, f.d_embed), generator=gen,
                       dtype=torch.float32, device=device) * 0.02
