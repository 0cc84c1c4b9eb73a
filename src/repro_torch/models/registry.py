"""Uniform model API: build_model(cfg, device) -> ModelAPI.

Counterpart of ``repro/models/registry.py`` for the dense family, the one
this slice of the port serves.  The training entry points (``loss``,
``layered``) come with the training slice.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

from repro_torch.models import transformer as tfm


class ModelAPI(NamedTuple):
    cfg: Any
    device: Any
    init: Callable                  # torch.Generator -> params
    forward: Callable               # (params, batch) -> (logits, aux)
    init_caches: Callable           # (batch, max_len) -> caches
    prefill: Callable               # (params, batch, max_len) -> (logits, caches)
    decode_step: Callable           # (params, caches, token, pos) -> (logits, caches)


_LATER = {
    "moe": "slice 8 (models/moe.py)",
    "ssm": "slice 8 (models/xlstm.py)",
    "hybrid": "slice 8 (models/rglru.py with kernel K4)",
    "vlm": "slice 8 (models/vlm.py)",
    "audio": "slice 4 (models/encdec.py)",
}


def build_model(cfg, device="cuda") -> ModelAPI:
    """The dense family's API; entry points run on ``device`` (CUDA unless
    the caller asks for the CPU)."""
    if cfg.family != "dense":
        if cfg.family in _LATER:
            raise NotImplementedError(
                f"family {cfg.family!r} ({cfg.name}) is not ported yet; "
                f"ROADMAP.md: {_LATER[cfg.family]}")
        raise ValueError(f"unknown family {cfg.family!r}")
    return ModelAPI(
        cfg=cfg,
        device=device,
        init=lambda generator: tfm.init_params(cfg, generator, device),
        forward=lambda params, batch: (
            tfm.forward(cfg, params, batch["tokens"]), {}),
        init_caches=lambda batch, max_len: tfm.init_caches(
            cfg, batch, max_len, device),
        prefill=lambda params, batch, max_len: tfm.prefill(
            cfg, params, batch["tokens"], max_len=max_len),
        decode_step=lambda params, caches, token, pos: tfm.decode_step(
            cfg, params, caches, token, pos),
    )
