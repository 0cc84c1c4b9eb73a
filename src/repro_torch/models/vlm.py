"""InternVL2-2B language backbone (InternLM2-1.8B-style) with a stubbed
vision frontend, counterpart of ``repro/models/vlm.py``: the batch carries
precomputed InternViT patch embeddings (B, n_patches, d_model) that are put
before the token embeddings of the dense transformer.  The loss is taken
over the text positions only (``registry``).

The caches hold the prefix too: ``init_caches`` and ``prefill`` reserve
``n_patches`` positions more than the text asks for, and ``decode_step``
takes ``pos`` as the absolute position, prefix included.

Every entry point takes ``mw``, the model world of one replica
(``common.ModelWorld``), and passes it to the transformer's: the patch
prefix enters every rank whole, the text's embedding and logits are the
rank's vocab rows and columns.
"""

from __future__ import annotations

import torch

from repro_torch.models import transformer as tfm

param_specs = tfm.param_specs


def init_params(cfg, generator: torch.Generator, device="cuda"):
    return tfm.init_params(cfg, generator, device)


@torch.no_grad()
def forward(cfg, params, tokens, prefix_embeds=None, mw=None):
    """-> (logits (B, n_patches + S, V), {})."""
    return tfm.forward(cfg, params, tokens, prefix_embeds=prefix_embeds,
                       mw=mw), {}


def forward_train(cfg, params, tokens, prefix_embeds=None, remat=True,
                  return_hidden=False, mw=None):
    """The training forward over the prefix and the text (the loss takes
    the text positions)."""
    return tfm.forward_train(cfg, params, tokens, remat=remat,
                             return_hidden=return_hidden,
                             prefix_embeds=prefix_embeds, mw=mw)


def init_caches(cfg, batch: int, max_len: int, device="cuda", mw=None):
    return tfm.init_caches(cfg, batch, max_len + cfg.n_patches, device, mw)


def prefill(cfg, params, tokens, max_len=None, prefix_embeds=None, mw=None):
    max_len = (max_len or tokens.shape[1]) + cfg.n_patches
    return tfm.prefill(cfg, params, tokens, max_len=max_len,
                       prefix_embeds=prefix_embeds, mw=mw)


def decode_step(cfg, params, caches, token, pos, mw=None):
    """``pos`` is the absolute position, the vision prefix included."""
    return tfm.decode_step(cfg, params, caches, token, pos, mw)
