"""InternVL2-2B language backbone (InternLM2-1.8B-style) with a stubbed
vision frontend, counterpart of ``repro/models/vlm.py``: the batch carries
precomputed InternViT patch embeddings (B, n_patches, d_model) that are put
before the token embeddings of the dense transformer.  The loss is taken
over the text positions only (``registry``).

The caches hold the prefix too: ``init_caches`` and ``prefill`` reserve
``n_patches`` positions more than the text asks for, and ``decode_step``
takes ``pos`` as the absolute position, prefix included.
"""

from __future__ import annotations

import torch

from repro_torch.models import transformer as tfm

param_specs = tfm.param_specs


def init_params(cfg, generator: torch.Generator, device="cuda"):
    return tfm.init_params(cfg, generator, device)


@torch.no_grad()
def forward(cfg, params, tokens, prefix_embeds=None):
    """-> (logits (B, n_patches + S, V), {})."""
    return tfm.forward(cfg, params, tokens, prefix_embeds=prefix_embeds), {}


def init_caches(cfg, batch: int, max_len: int, device="cuda"):
    return tfm.init_caches(cfg, batch, max_len + cfg.n_patches, device)


def prefill(cfg, params, tokens, max_len=None, prefix_embeds=None):
    max_len = (max_len or tokens.shape[1]) + cfg.n_patches
    return tfm.prefill(cfg, params, tokens, max_len=max_len,
                       prefix_embeds=prefix_embeds)


def decode_step(cfg, params, caches, token, pos):
    """``pos`` is the absolute position, the vision prefix included."""
    return tfm.decode_step(cfg, params, caches, token, pos)
