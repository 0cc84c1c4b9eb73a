"""RecurrentGemma / Griffin (arXiv:2402.19427): RG-LRU + local attention, 1:2,
counterpart of ``repro/models/rglru.py``.

26 layers, pattern (recurrent, recurrent, local-attention) x 8 + a trailing
(recurrent, recurrent) pair. Each residual block = temporal mixing + gated MLP.

RG-LRU recurrence (linear, gated):
    r_t = sigmoid(W_r u_t);  i_t = sigmoid(W_i u_t)
    a_t = exp(-c * softplus(Lambda) * r_t)              (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

The JAX model scans with ``jax.lax.associative_scan``; here the recurrence
runs through ``kernels.ops.rglru_scan`` (serving) or
``kernels.ops.rglru_scan_train`` (training, whose backward is the reverse
scan): the Hopper kernel K4 on CUDA tensors, its plain sequential loop on
CPU tensors.  The local-attention layers are the dense family's
(``transformer._attn_block``, whose prefill attention is K3, and
``transformer._decode_layer``) with a window of ``ATTN_WINDOW``.

Parameters are a dict with the JAX package's tree and layouts: ``emb``,
``blocks/{rec1,rec2,attn}`` stacked over the 8 superblocks, ``ln_f`` and
``tail`` stacked over the trailing recurrent layers.  ``lam`` is float32
whatever ``cfg.dtype`` is.  Serving state per recurrent layer is
``(h (B,w) fp32, conv (B,K-1,w) in cfg.dtype)``; ``decode_step`` writes
every cache in place and returns them.  ``forward_train`` is the JAX
``forward`` with autograd, which the training loss runs.

**The model axis.**  Every entry point takes ``mw``, the model world of
one replica (``common.ModelWorld``), or ``None``.  With a model world the
params are this rank's slices by ``common.placement``: ``w_x``,
``w_gate`` and ``conv_w`` by channel, ``w_out`` by row, the square gate
kernels ``w_r``/``w_i`` and ``lam`` held whole.  A recurrent layer runs
the rank's ``w/M`` channels from ``copy_to_model`` of its input to
``reduce_from_model`` of ``w_out``'s partial product; the gates read all
``w`` channels of ``u`` through ``gather_from_model`` and the rank's
columns of ``w_r`` and ``w_i`` (under ``copy_to_model``, as ``lam`` is,
so that their gradients are whole); the scan runs on the rank's
channels.  The attention layers and the MLPs are the dense family's over
the rank's heads and ``d_ff`` columns, the tied embedding split by
vocab.  A rank's recurrence state is ``(h (B,w/M), conv (B,K-1,w/M))``
and its ring cache holds the KV heads it reads (``kv_heads_held``).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.tree import Spec
from repro_torch.kernels import ops
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm

C_FACTOR = 8.0
ATTN_WINDOW = 2048    # Griffin's local attention window
LAM = "lam"           # init of Lambda: fp32 linspace(0.9, 0.999, w)


def layout(cfg):
    """(superblocks, trailing recurrent layers) covering cfg.n_layers."""
    n_sb = cfg.n_layers // 3
    return n_sb, cfg.n_layers - 3 * n_sb


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def _param_tree(cfg, leaf):
    """The param tree with each leaf made by ``leaf(shape, init)``: init is
    the std of a normal init, None for a zero leaf, or ``LAM``."""
    d, ff = cfg.d_model, cfg.d_ff
    w = cfg.lru_width or d
    n_sb, tail = layout(cfg)

    def dense(lead, d_in, d_out, std=None):
        return leaf(lead + (d_in, d_out), std or 1.0 / math.sqrt(d_in))

    def recurrent(lead):
        return {
            "ln": {"scale": leaf(lead + (d,), None)},
            "w_x": dense(lead, d, w),
            "w_gate": dense(lead, d, w),
            "conv_w": leaf(lead + (cfg.conv_width, w), 0.1),
            "w_r": dense(lead, w, w, 0.01),
            "w_i": dense(lead, w, w, 0.01),
            "lam": leaf(lead + (w,), LAM),
            "w_out": dense(lead, w, d),
            "mlp": {"ln": {"scale": leaf(lead + (d,), None)},
                    "w1": dense(lead, d, ff), "w3": dense(lead, d, ff),
                    "w2": dense(lead, ff, d)},
        }

    params = {
        "emb": leaf((cfg.vocab_padded, d), 0.02),
        "blocks": {"rec1": recurrent((n_sb,)), "rec2": recurrent((n_sb,)),
                   "attn": tfm.layer_tree(cfg, (n_sb,), leaf)},
        "ln_f": {"scale": leaf((d,), None)},
    }
    if tail:
        params["tail"] = recurrent((tail,))
    return params


def param_shapes(cfg):
    """The param tree with each leaf's shape tuple in place of a tensor."""
    return _param_tree(cfg, lambda shape, init: tuple(shape))


def param_specs(cfg):
    """The param tree with each leaf's shape and dtype (``lam`` float32)."""
    dtype = tfm.torch_dtype(cfg)
    return _param_tree(cfg, lambda shape, init: Spec(
        tuple(shape), torch.float32 if init == LAM else dtype))


def init_params(cfg, generator: torch.Generator, device="cuda"):
    """Random weights with the JAX init's distributions (N(0, 1/d_in) dense
    kernels, N(0, 0.01^2) gate kernels, N(0, 0.1^2) conv taps, N(0, 0.02^2)
    embeddings, zero norm scales) and its deterministic ``lam``.  Numbers
    are drawn on the generator's device, one leaf at a time."""
    dtype = tfm.torch_dtype(cfg)

    def leaf(shape, init):
        if init == LAM:
            lam = np.linspace(0.9, 0.999, shape[-1], dtype=np.float32)
            return torch.from_numpy(lam).to(device).expand(shape).clone()
        if init is None:
            return torch.zeros(shape, dtype=dtype, device=device)
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) * init
        return x.to(device=device, dtype=dtype)

    return _param_tree(cfg, leaf)


# ---------------------------------------------------------------------------
# RG-LRU core
# ---------------------------------------------------------------------------

def channels_split(p, mw) -> bool:
    """Whether the rank holds a slice of a recurrent layer's channels (the
    placement splits ``w_x`` by column)."""
    return mw is not None and p["w_x"].shape[-1] < p["w_r"].shape[0]


def state_width(cfg, mw) -> int:
    """The recurrence channels a rank holds: its slice where the placement
    splits the lru width over the model ranks, else all of them."""
    w = cfg.lru_width or cfg.d_model
    if mw is not None and cm.model_slice((None, "model"), (cfg.d_model, w),
                                         mw.size) is not None:
        return w // mw.size
    return w


def _gates(p, u, mw=None):
    """(a, gated input) of ``u`` (B,S,w).  With a model world ``u`` holds
    the rank's channels: the gate matmuls read all of them through the
    model group and give the rank's columns."""
    w_r, w_i, lam, u_all = p["w_r"], p["w_i"], p["lam"], u
    if mw is not None:
        n = u.shape[-1]
        cols = slice(mw.rank * n, (mw.rank + 1) * n)
        u_all = cm.gather_from_model(u, mw)
        w_r = cm.copy_to_model(w_r, mw)[..., cols]
        w_i = cm.copy_to_model(w_i, mw)[..., cols]
        lam = cm.copy_to_model(lam, mw)[..., cols]
    r = torch.sigmoid((u_all @ w_r).float())
    i = torch.sigmoid((u_all @ w_i).float())
    log_a = -C_FACTOR * F.softplus(lam) * r                  # (B,S,w) fp32
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 1e-12,
                                      1.0)) * (i * u.float())
    return a, gated_in


def conv1d_causal(u, w, state=None):
    """Depthwise causal conv, width K. u (B,S,w); state (B,K-1,w) history.
    The K products are summed in order from 0, in u's dtype."""
    K = w.shape[0]
    if state is None:
        pad = u.new_zeros((u.shape[0], K - 1, u.shape[2]))
    else:
        pad = state.to(u.dtype)
    up = torch.cat([pad, u], dim=1)
    out = sum(up[:, k:k + u.shape[1]] * w[k] for k in range(K))
    # a copy: a view would keep the whole (B, S+K-1, w) buffer alive in the
    # cache
    new_state = up[:, -(K - 1):].clone()
    return out, new_state


def recurrent_block(cfg, p, x, state=None, scan=ops.rglru_scan, mw=None):
    """state = (h (B,w) fp32, conv (B,K-1,w)) or None. Returns (x, state).
    ``scan`` is the serving scan, or ``ops.rglru_scan_train`` for training.
    With a model world: the rank's channels (its state too), ``w_out``'s
    rows summed over the ranks, and the MLP's split."""
    split = mw if channels_split(p, mw) else None
    h = cm.copy_to_model(cm.rms_norm(x, p["ln"]["scale"], cfg.norm_eps),
                         split)
    gate = cm.act_fn("gelu")(h @ p["w_gate"])
    u = h @ p["w_x"]
    h0, conv_state = (None, None) if state is None else state
    u, conv_state = conv1d_causal(u, p["conv_w"], conv_state)
    a, gin = _gates(p, u, split)
    hs = scan(a, gin, h0)                                     # (B,S,w) fp32
    y = cm.reduce_from_model((hs.to(x.dtype) * gate) @ p["w_out"], split)
    x = x + y
    x = x + tfm.mlp(cfg, p["mlp"], cm.rms_norm(x, p["mlp"]["ln"]["scale"],
                                               cfg.norm_eps), mw)
    return x, (hs[:, -1].clone(), conv_state)     # a copy, as for conv


def _final(cfg, params, x, mw=None):
    x = cm.rms_norm(x, params["ln_f"]["scale"], cfg.norm_eps)
    return tfm.unembed(cfg, params, x, mw)


# ---------------------------------------------------------------------------
# Forward (scoring)
# ---------------------------------------------------------------------------

@torch.no_grad()
def forward(cfg, params, tokens, mw=None):
    """tokens (B,S) -> logits (B,S,V) (the rank's vocab columns with a
    vocab-split model world)."""
    x = tfm.embed(cfg, params, tokens, mw)
    positions = tfm._positions(x)
    n_sb, tail = layout(cfg)
    for i in range(n_sb):
        bp = tfm._index(params["blocks"], i)
        x, _ = recurrent_block(cfg, bp["rec1"], x, mw=mw)
        x, _ = recurrent_block(cfg, bp["rec2"], x, mw=mw)
        x = tfm.attn_layer(cfg, bp["attn"], x, positions, ATTN_WINDOW, mw)
    for i in range(tail):
        x, _ = recurrent_block(cfg, tfm._index(params["tail"], i), x, mw=mw)
    return _final(cfg, params, x, mw)


def forward_train(cfg, params, tokens, remat: bool = True,
                  return_hidden: bool = False, mw=None):
    """tokens (B,S) -> logits (B,S,V) with autograd: the JAX ``forward``.
    With ``return_hidden`` the hidden state after ``ln_f`` instead, before
    the unembed (the chunked cross-entropy's input).

    The scan is ``ops.rglru_scan_train`` (K4 forward and backward on CUDA
    tensors), attention ``cm.differentiable_blocked_attention`` with window
    ``ATTN_WINDOW`` (no kernel, as in the JAX training loss).  ``remat``
    recomputes each (rec1, rec2, attn) superblock in the backward
    (``torch.utils.checkpoint``), as ``jax.remat`` wraps the superblock
    body that JAX scans; the trailing recurrent layers are not recomputed,
    as JAX's ``tail_body`` is not.  With a model world the logits are the
    rank's vocab columns; the hidden state is whole.
    """
    x = tfm.embed(cfg, params, tokens, mw)
    positions = tfm._positions(x)
    n_sb, tail = layout(cfg)

    def rec(p, x):
        return recurrent_block(cfg, p, x, scan=ops.rglru_scan_train,
                               mw=mw)[0]

    def superblock(x, bp):
        x = rec(bp["rec2"], rec(bp["rec1"], x))
        return tfm._attn_block(cfg, bp["attn"], x, positions, ATTN_WINDOW,
                               cfg.causal,
                               attention=cm.differentiable_blocked_attention,
                               mw=mw)[0]

    for i in range(n_sb):
        bp = tfm._index(params["blocks"], i)
        x = (checkpoint(superblock, x, bp, use_reentrant=False) if remat
             else superblock(x, bp))
    for i in range(tail):
        x = rec(tfm._index(params["tail"], i), x)
    x = cm.rms_norm(x, params["ln_f"]["scale"], cfg.norm_eps)
    return x if return_hidden else tfm.unembed(cfg, params, x, mw)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_caches(cfg, batch: int, max_len: int, device="cuda", mw=None):
    """Zero state for every recurrent layer and a ring of
    ``min(ATTN_WINDOW, max_len)`` positions for every attention layer; of
    the channels and KV heads the rank holds with a model world."""
    n_sb, tail = layout(cfg)
    w = state_width(cfg, mw)
    K = cfg.conv_width
    dtype = tfm.torch_dtype(cfg)

    def rec_state(n):
        return (torch.zeros((n, batch, w), dtype=torch.float32, device=device),
                torch.zeros((n, batch, K - 1, w), dtype=dtype, device=device))

    caches = {
        "rec1": rec_state(n_sb),
        "rec2": rec_state(n_sb),
        "attn": cm.init_kv_cache(n_sb, batch, min(ATTN_WINDOW, max_len),
                                 tfm.kv_heads_held(cfg, mw), cfg.hd, dtype,
                                 device),
    }
    if tail:
        caches["tail"] = rec_state(tail)
    return caches


def _decode_recurrent(cfg, p, x, state, i, mw=None):
    """One recurrent layer of a decode step; writes layer i of the stacked
    state ``(h, conv)`` in place."""
    h, conv = state
    x, (h_new, conv_new) = recurrent_block(cfg, p, x, state=(h[i], conv[i]),
                                           mw=mw)
    h[i] = h_new
    conv[i] = conv_new
    return x


@torch.no_grad()
def decode_step(cfg, params, caches, token, pos, mw=None):
    """token (B,1) int; pos an int or a (B,) int tensor -> (logits (B,1,V),
    caches): the rank's vocab columns with a vocab-split model world.  The
    caches are updated in place and returned."""
    x = tfm.embed(cfg, params, token, mw)
    pos = torch.as_tensor(pos, device=x.device).to(torch.int64)
    n_sb, tail = layout(cfg)
    for i in range(n_sb):
        bp = tfm._index(params["blocks"], i)
        x = _decode_recurrent(cfg, bp["rec1"], x, caches["rec1"], i, mw)
        x = _decode_recurrent(cfg, bp["rec2"], x, caches["rec2"], i, mw)
        x = tfm._decode_layer(cfg, bp["attn"], x, caches["attn"]["k"][i],
                              caches["attn"]["v"][i], pos, ATTN_WINDOW, mw)
    for i in range(tail):
        x = _decode_recurrent(cfg, tfm._index(params["tail"], i), x,
                              caches["tail"], i, mw)
    return _final(cfg, params, x, mw), caches


@torch.no_grad()
def prefill(cfg, params, tokens, max_len: Optional[int] = None, mw=None):
    """Fill the caches for tokens (B,S); returns (last-token logits,
    caches): each recurrent layer's last h and conv history, each attention
    layer's trailing window of K/V (after rope) in ring order.  With a
    model world: the rank's channels and KV heads, and the last logits of
    its vocab columns."""
    x = tfm.embed(cfg, params, tokens, mw)
    max_len = max_len or x.shape[1]
    positions = tfm._positions(x)
    n_sb, tail = layout(cfg)

    def stack(states):
        return tuple(torch.stack(parts) for parts in zip(*states))

    r1, r2, ks, vs = [], [], [], []
    for i in range(n_sb):
        bp = tfm._index(params["blocks"], i)
        x, st = recurrent_block(cfg, bp["rec1"], x, mw=mw)
        r1.append(st)
        x, st = recurrent_block(cfg, bp["rec2"], x, mw=mw)
        r2.append(st)
        x, k, v = tfm._attn_block(cfg, bp["attn"], x, positions, ATTN_WINDOW,
                                  True, mw=mw)
        ks.append(tfm.window_ring(k, ATTN_WINDOW, max_len))
        vs.append(tfm.window_ring(v, ATTN_WINDOW, max_len))
    caches = {"rec1": stack(r1), "rec2": stack(r2),
              "attn": {"k": torch.stack(ks), "v": torch.stack(vs)}}
    if tail:
        ts = []
        for i in range(tail):
            x, st = recurrent_block(cfg, tfm._index(params["tail"], i), x,
                                    mw=mw)
            ts.append(st)
        caches["tail"] = stack(ts)
    return _final(cfg, params, x[:, -1:], mw), caches
