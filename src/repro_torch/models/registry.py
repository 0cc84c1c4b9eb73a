"""Uniform model API: build_model(cfg, device) -> ModelAPI.

Counterpart of ``repro/models/registry.py`` for the dense family and, for
serving, the hybrid family (recurrentgemma).  The ``layered``
decomposition belongs to the FSDP slice; the chunked cross-entropy of
vocabularies of 65536 and more (``_chunked_ce``) and the hybrid loss to
slice 3b (ROADMAP.md), recurrentgemma's training.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

from repro_torch.models import common as cm
from repro_torch.models import rglru
from repro_torch.models import transformer as tfm


class ModelAPI(NamedTuple):
    cfg: Any
    device: Any
    init: Callable                  # torch.Generator -> params
    forward: Callable               # (params, batch) -> (logits, aux)
    loss: Callable                  # (params, batch, remat=True) -> (loss, metrics)
    init_caches: Callable           # (batch, max_len) -> caches
    prefill: Callable               # (params, batch, max_len) -> (logits, caches)
    decode_step: Callable           # (params, caches, token, pos) -> (logits, caches)


_LATER = {
    "moe": "slice 9 (models/moe.py)",
    "ssm": "slice 9 (models/xlstm.py)",
    "vlm": "slice 9 (models/vlm.py)",
    "audio": "slice 5 (models/encdec.py)",
}


CHUNKED_CE_VOCAB = 65536


def _dense_loss(cfg):
    """``ModelAPI.loss`` of the dense family, the JAX loss's unchunked
    branch: cross-entropy of the training forward's logits.  A vocab that
    needs the chunked branch raises when the loss is called, so that such
    a model still serves."""
    def loss_fn(params, batch, remat=True):
        if cfg.vocab_padded >= CHUNKED_CE_VOCAB:
            raise NotImplementedError(
                f"{cfg.name}: the chunked cross-entropy for a vocab of "
                f"{cfg.vocab_padded} (>= {CHUNKED_CE_VOCAB}) is not ported "
                f"yet (ROADMAP.md, slice 3b)")
        logits = tfm.forward_train(cfg, params, batch["tokens"], remat=remat)
        ce = cm.softmax_cross_entropy(logits, batch["labels"],
                                      batch.get("mask"))
        return ce, {"ce": ce, "loss": ce}

    return loss_fn


def _hybrid_loss(cfg):
    """recurrentgemma serves but does not train yet."""
    def loss_fn(params, batch, remat=True):
        raise NotImplementedError(
            f"{cfg.name}: the hybrid loss (the chunked cross-entropy of its "
            f"{cfg.vocab_padded} vocab and a gradient through the RG-LRU scan) "
            f"is not ported yet (ROADMAP.md, slice 3b: recurrentgemma "
            f"training)")

    return loss_fn


def build_model(cfg, device="cuda") -> ModelAPI:
    """The dense or hybrid family's API; entry points run on ``device``
    (CUDA unless the caller asks for the CPU)."""
    if cfg.family == "dense":
        mod, loss = tfm, _dense_loss(cfg)
    elif cfg.family == "hybrid":
        mod, loss = rglru, _hybrid_loss(cfg)
    elif cfg.family in _LATER:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet; "
            f"ROADMAP.md: {_LATER[cfg.family]}")
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    return ModelAPI(
        cfg=cfg,
        device=device,
        init=lambda generator: mod.init_params(cfg, generator, device),
        forward=lambda params, batch: (
            mod.forward(cfg, params, batch["tokens"]), {}),
        loss=loss,
        init_caches=lambda batch, max_len: mod.init_caches(
            cfg, batch, max_len, device),
        prefill=lambda params, batch, max_len: mod.prefill(
            cfg, params, batch["tokens"], max_len=max_len),
        decode_step=lambda params, caches, token, pos: mod.decode_step(
            cfg, params, caches, token, pos),
    )
