"""Shared building blocks of the dense decoder: norms, RoPE, attention for
prefill (through the flash-attention kernel) and for one-token decode
against a cache, and the KV cache helpers.

Counterpart of ``repro/models/common.py``.  The sharding helpers (``wsc``,
the spec tables) have no counterpart: the port runs on one device.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps: float = 1e-6):
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def _gelu_tanh(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(hd: int, theta: float, device=None):
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / torch.pow(float(theta), exps)


def apply_rope(x, positions, theta: float):
    """x: (..., T, H, hd); positions: (..., T) int.  Split-half rotation."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                   # (hd/2,)
    ang = positions[..., None].float() * freqs                # (..., T, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def blocked_attention(q, k, v, *, causal: bool = True,
                      window: Optional[int] = None,
                      block_q: int = 512, block_k: int = 1024,
                      q_offset: int = 0):
    """Online-softmax attention; q (B,Sq,H,hd), k/v (B,Sk,KH,hd).

    Routes through ``kernels.ops.flash_attention``: the Hopper kernel for
    CUDA tensors, its plain torch version (this function's algorithm in
    the JAX package) for CPU tensors.
    """
    return ops.flash_attention(q, k, v, causal=causal, window=window,
                               block_q=block_q, block_k=block_k,
                               q_offset=q_offset)


def decode_attention(q, k_cache, v_cache, *, length, window: Optional[int] = None):
    """One-token attention against a cache. q (B,1,H,hd); cache (B,S,KH,hd).

    ``length``: number of valid cache entries, an int or a (B,) tensor (each
    row of a paged batch has its own).  For ring-buffer window caches,
    S == window and all entries < length are valid.  Plain torch: the JAX
    package computes this outside any kernel too.
    """
    b, _, h, hd = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    rep = h // kh
    scale = 1.0 / math.sqrt(hd)
    qg = q.float().reshape(b, kh, rep, hd)
    sc = torch.einsum("bgrd,bsgd->bgrs", qg, k_cache.float()) * scale
    length = torch.as_tensor(length, device=q.device).reshape(-1)
    valid = torch.arange(s, device=q.device)[None, :] < length[:, None]
    sc = torch.where(valid[:, None, None, :], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bgrs,bsgd->bgrd", p, v_cache.float())
    return out.reshape(b, 1, h, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

def init_kv_cache(n_layers: int, batch: int, max_len: int, n_kv: int, hd: int,
                  dtype, device) -> dict:
    shape = (n_layers, batch, max_len, n_kv, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_update(cache_k, cache_v, k_new, v_new, pos, ring: bool = False):
    """Write (B,1,KH,hd) at ``pos`` (an int or a (B,) tensor, one position
    per row; ring-buffer modulo for windows).  Updates the caches in place,
    where the JAX package returns new arrays, and returns them."""
    b, s = cache_k.shape[:2]
    pos = torch.as_tensor(pos, device=cache_k.device).reshape(-1).expand(b)
    idx = torch.remainder(pos, s) if ring else pos
    rows = torch.arange(b, device=cache_k.device)
    cache_k[rows, idx] = k_new[:, 0]
    cache_v[rows, idx] = v_new[:, 0]
    return cache_k, cache_v
