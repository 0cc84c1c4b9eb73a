"""Dense serving steps: prefill and single-token greedy decode on one
device, counterpart of ``repro/serve/decode.py`` without a mesh.

Every request of a batch shares one position and reserves ``max_len``
cache positions up front.  This is the uncontended reference the paged
scheduler is held against.
"""

from __future__ import annotations

import torch

from repro_torch.models import common as cm


def build_serve_step(model):
    """``serve_step(params, caches, token (B,1), pos) -> (next_token (B,1),
    logits, caches)``; the caches are updated in place."""
    vocab = model.cfg.vocab

    def serve_step(params, caches, token, pos):
        logits, caches = model.decode_step(params, caches, token, pos)
        # mask vocab-padding columns (table padded to /256)
        cols = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(cols < vocab, logits, cm.NEG_INF)
        nxt = logits[:, -1, :].argmax(-1).to(token.dtype)[:, None]
        return nxt, logits, caches

    return serve_step


def build_prefill(model, max_len: int):
    """``prefill_step(params, batch) -> (last_logits, caches)`` with caches
    padded to ``max_len``."""
    def prefill_step(params, batch):
        return model.prefill(params, batch, max_len)

    return prefill_step
