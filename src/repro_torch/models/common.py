"""Shared building blocks of the dense decoder: norms, RoPE, attention for
prefill (through the flash-attention kernel), for training (differentiable
torch) and for one-token decode against a cache, the KV cache helpers and
the cross-entropy loss.

Counterpart of ``repro/models/common.py``.  The sharding helpers (``wsc``,
the spec tables) have no counterpart: the port runs on one device.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Per-layer apply decomposition (layer-streamed FSDP engine, DESIGN.md §11)
# ---------------------------------------------------------------------------

class LayeredModel(NamedTuple):
    """Per-layer apply decomposition of a model.

    The layer-streamed FSDP engine (``core/streaming.py``) consumes
    parameters one **span** (a superblock for the dense family) at a time,
    so the model exposes its forward as stem -> span* -> head over a
    *layered* param tree

        {"stem": {...}, "layers": (span_0, ..., span_{n-1}), "head": {...}}

    made by ``split`` (views of the canonical stacked tree; ``merge`` is
    its exact inverse, and both take ``lead=``, the count of leading
    replica dims every leaf carries, and ``Spec`` leaves).
    ``stem(stem_tree, batch) -> (carry, aux)``: ``carry`` is the
    differentiable activation threaded through the spans, ``aux`` side
    data without a gradient (positions); ``span(k, span_tree, carry, aux,
    remat=True) -> carry`` applies span k; ``head_loss(head_tree,
    stem_tree, carry, aux, batch) -> (loss, metrics)`` is the registry
    loss's tail (the stem tree is passed for tied unembeddings).  The
    composition runs the ops of ``ModelAPI.loss``.
    """
    n_spans: int
    split: Callable                 # (params, lead=0) -> layered tree
    merge: Callable                 # (layered, lead=0) -> params
    stem: Callable                  # (stem_tree, batch) -> (carry, aux)
    span: Callable                  # (k, span_tree, carry, aux, remat=True) -> carry
    head_loss: Callable             # (head, stem, carry, aux, batch) -> (loss, metrics)


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


def differentiable_blocked_attention(q, k, v, *, causal: bool = True,
                                     window: Optional[int] = None,
                                     block_q: int = 512, block_k: int = 1024):
    """The training attention: the JAX package's ``blocked_attention``
    algorithm in plain torch, differentiable by autograd.

    q (B,Sq,H,hd), k/v (B,Sk,KH,hd) -> (B,Sq,H,hd).  KV heads are repeated
    to H, sequences zero-padded to block multiples, and each q block runs an
    online softmax in fp32 over the KV blocks it can see (for a window only
    ``(window + block_q) // block_k + 1`` of them, from the window's left
    edge).  JAX differentiates the same code in its training loss; no
    kernel runs here, in either package.
    """
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    n_rep = h // kh
    k = k.repeat_interleave(n_rep, dim=2)
    v = v.repeat_interleave(n_rep, dim=2)
    block_q, block_k = min(block_q, sq), min(block_k, sk)
    pq, pk = (-sq) % block_q, (-sk) % block_k
    qp = F.pad(q, (0, 0, 0, 0, 0, pq))
    kp = F.pad(k, (0, 0, 0, 0, 0, pk))
    vp = F.pad(v, (0, 0, 0, 0, 0, pk))
    nq, nk = qp.shape[1] // block_q, kp.shape[1] // block_k
    scale = 1.0 / math.sqrt(hd)
    dev = q.device
    q_blocks = qp.reshape(b, nq, block_q, h, hd).permute(1, 0, 3, 2, 4)
    k_all = kp.permute(0, 2, 1, 3).float()                 # (B,H,Sk,hd)
    v_all = vp.permute(0, 2, 1, 3).float()
    n_vis = (window + block_q) // block_k + 1 if window is not None else nk

    outs = []
    for qi in range(nq):
        qblk = q_blocks[qi].float()                         # (B,H,bq,hd)
        q_pos = qi * block_q + torch.arange(block_q, device=dev)
        m = torch.full((b, h, block_q), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, h, block_q), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, block_q, hd), dtype=torch.float32,
                          device=dev)
        first = (max((qi * block_q - (window - 1)) // block_k, 0)
                 if window is not None else 0)
        for kj_rel in range(n_vis):
            kj_unclipped = first + kj_rel
            kj = min(max(kj_unclipped, 0), nk - 1)
            kblk = k_all[:, :, kj * block_k:(kj + 1) * block_k]
            vblk = v_all[:, :, kj * block_k:(kj + 1) * block_k]
            s = torch.einsum("bhqd,bhkd->bhqk", qblk, kblk) * scale
            k_pos = kj * block_k + torch.arange(block_k, device=dev)
            mask = (k_pos[None, :] < sk) & (kj_unclipped < nk)
            if causal:
                mask = mask & (k_pos[None, :] <= q_pos[:, None])
            if window is not None:
                mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p,
                                                       vblk)
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(
        b, nq * block_q, h, hd)
    return out[:, :sq].to(q.dtype)


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


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def softmax_cross_entropy(logits, labels, mask=None):
    """logits (B,S,V), labels (B,S) int -> mean NLL in float32 (over the
    mask's weight when given)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    lab = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - lab
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
