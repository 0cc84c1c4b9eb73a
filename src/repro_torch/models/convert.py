"""Weights across the two packages.

``jax.random`` cannot be reproduced in torch, so tests that hold the port
against the JAX package draw the weights once with the JAX init and carry
them over as numpy arrays.  The port's parameter tree has the JAX tree's
structure and layouts, so the conversion is leaf by leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import transformer as tfm


def params_from_jax(cfg, tree, device="cuda"):
    """JAX param tree (leaves as numpy arrays, or anything ``np.asarray``
    takes) -> the port's params on ``device`` in ``cfg.dtype``.

    Checks every leaf's shape against the port's own init, so a tree of
    another config or family fails here and not inside a matmul.
    """
    dtype = tfm.torch_dtype(cfg)

    def conv(node, spec, path):
        if isinstance(spec, dict):
            if not isinstance(node, dict) or set(node) != set(spec):
                got = sorted(node) if isinstance(node, dict) else type(node)
                raise ValueError(f"params_from_jax: {path or 'root'} has "
                                 f"{got}, expected {sorted(spec)}")
            return {k: conv(node[k], spec[k], f"{path}/{k}") for k in spec}
        arr = np.array(node, dtype=np.float32)
        if arr.shape != spec:
            raise ValueError(f"params_from_jax: {path} has shape "
                             f"{arr.shape}, expected {spec}")
        return torch.from_numpy(arr).to(device=device, dtype=dtype)

    return conv(tree, tfm.param_shapes(cfg), "")
