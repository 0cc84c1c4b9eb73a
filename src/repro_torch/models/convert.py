"""Weights and training state across the two packages.

``jax.random`` cannot be reproduced in torch, so tests that hold the port
against the JAX package draw the weights once with the JAX init and carry
them over as numpy arrays.  The port's parameter tree has the JAX tree's
structure and layouts, so the conversion is leaf by leaf.  Families:
``dense`` and ``vlm`` (the dense transformer's tree), ``hybrid``
(recurrentgemma), ``audio`` (transformer_wmt, whisper-medium), ``ssm``
(xlstm-350m) and ``moe`` (llama4-maverick, kimi-k2).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import encdec, moe, rglru, vlm, xlstm
from repro_torch.models import transformer as tfm

PARAM_SPECS = {"dense": tfm.param_specs, "hybrid": rglru.param_specs,
               "audio": encdec.param_specs, "vlm": vlm.param_specs,
               "ssm": xlstm.param_specs, "moe": moe.param_specs}


def params_from_jax(cfg, tree, device="cuda", *, lead=(), dtype=None):
    """JAX param tree (leaves as numpy arrays, or anything ``np.asarray``
    takes) -> the port's params on ``device``, each leaf in the dtype of the
    port's own init (``cfg.dtype``; recurrentgemma's ``lam``, xLSTM's
    ``bif``/``bg`` and a moe layer's ``router`` float32), or
    all in ``dtype``.  ``lead`` is the shape of leading dims every leaf
    carries (``(P,)`` for a stacked replica tree).

    Checks every leaf's shape against the port's own init of ``cfg``'s
    family, so a tree of another config or family fails here and not inside
    a matmul.
    """
    if cfg.family not in PARAM_SPECS:
        raise NotImplementedError(f"params_from_jax: family {cfg.family!r} "
                                  f"is not ported")
    lead = tuple(lead)

    def conv(node, spec, path):
        if isinstance(spec, dict):
            if not isinstance(node, dict) or set(node) != set(spec):
                got = sorted(node) if isinstance(node, dict) else type(node)
                raise ValueError(f"params_from_jax: {path or 'root'} has "
                                 f"{got}, expected {sorted(spec)}")
            return {k: conv(node[k], spec[k], f"{path}/{k}") for k in spec}
        arr = np.array(node, dtype=np.float32)
        shape = lead + spec.shape
        if arr.shape != shape:
            raise ValueError(f"params_from_jax: {path} has shape "
                             f"{arr.shape}, expected {shape}")
        return torch.from_numpy(arr).to(device=device,
                                        dtype=dtype or spec.dtype)

    return conv(tree, PARAM_SPECS[cfg.family](cfg), "")


def replica_state_from_jax(cfg, state, device="cuda"):
    """A JAX replicated ``ReplicaState`` (leaves as numpy, e.g. after
    ``jax.device_get``) -> the port's :class:`ReplicaState` on ``device``.

    Params are stacked ``(P, ...)`` in ``cfg.dtype``; the SGD or AdamW
    moments float32 of the same shapes; ``count`` an int32 ``(P,)`` vector
    on the CPU; ``step`` and ``phase`` ints.
    """
    from repro_torch.core.replica import ReplicaState
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.optim.sgd import SGDState

    # optimiser states by their fields (the JAX NamedTuples cross as such)
    by_fields = {SGDState._fields: SGDState, AdamWState._fields: AdamWState}

    lead = (np.asarray(state.params["emb"]).shape[0],)
    params = params_from_jax(cfg, state.params, device, lead=lead)
    fields = tuple(getattr(state.opt_state, "_fields", ()))
    if fields not in by_fields:
        raise TypeError(f"replica_state_from_jax: optimiser state with "
                        f"fields {fields}; expected one of "
                        f"{sorted(by_fields)}")
    opt = {}
    for f in fields:
        val = getattr(state.opt_state, f)
        if f == "count":
            opt[f] = torch.from_numpy(np.array(val, dtype=np.int32))
        else:
            opt[f] = params_from_jax(cfg, val, device, lead=lead,
                                     dtype=torch.float32)
    return ReplicaState(params, by_fields[fields](**opt),
                        step=int(np.asarray(state.step)),
                        phase=int(np.asarray(state.phase)))
