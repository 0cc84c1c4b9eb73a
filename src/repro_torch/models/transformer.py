"""Dense decoder-only transformer family (qwen3, starcoder2, tinyllama, the
gemma3 local:global pattern), counterpart of ``repro/models/transformer.py``.

Parameters are a dict of tensors with the JAX package's tree and layouts:
per-layer weights stacked on a leading superblock dim under
``blocks/global`` (and ``blocks/local`` with a second stack dim), plus
``emb``, ``ln_f`` and, untied, ``lm_head``.  Where JAX scans over the stack
this module loops in Python over views of it.

Entry points:
    init_params(cfg, generator, device)
    forward(cfg, params, tokens, prefix_embeds) -> logits (scoring, no
        autograd)
    forward_train(cfg, params, tokens, remat, return_hidden,
        prefix_embeds) -> logits, or the hidden state after ``ln_f`` (with
        autograd)
    prefill(cfg, params, tokens, max_len, prefix_embeds) -> (last_logits,
        caches)
    decode_step(cfg, params, caches, token, pos) -> (logits, caches)

``prefix_embeds`` (B,Np,d), the VLM's patch embeddings, is cast to the
model dtype and put before the token embeddings; positions then run over
the whole sequence, so the text starts at position Np, and the logits (or
hidden state) cover all Np+S positions.

``decode_step`` takes ``pos`` as an int or as a (B,) tensor, one position
per row (the paged decode batch), and writes the caches in place.

The layered decomposition of the layer-streamed FSDP engine
(``split_layered``, ``merge_layered``, ``stem_apply``, ``span_apply``,
``head_params_for_unembed``) runs the body ``forward_train`` runs per
superblock (``_superblock``), so the streamed composition is the training
forward's ops.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import tree as tr
from repro_torch.core.tree import Spec
from repro_torch.models import common as cm

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def torch_dtype(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]


def _index(tree, i):
    """The i-th slice of every leaf of a stacked param or cache tree."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# Structure helpers
# ---------------------------------------------------------------------------

def superblock_layout(cfg):
    """(n_superblocks, locals_per_block, has_global) covering cfg.n_layers."""
    if cfg.local_per_global > 0:
        k = cfg.local_per_global
        if cfg.n_layers % (k + 1):
            raise ValueError(f"{cfg.n_layers} layers are not a multiple of "
                             f"{k + 1} (local_per_global={k})")
        return cfg.n_layers // (k + 1), k, True
    if cfg.sliding_window is not None:
        return cfg.n_layers, 1, False       # uniform windowed
    return cfg.n_layers, 0, True            # uniform global


def norm_apply(cfg, x, p):
    if cfg.norm == "ln":
        x32 = x.float()
        mu = x32.mean(-1, keepdim=True)
        var = x32.var(-1, keepdim=True, unbiased=False)
        out = (x32 - mu) * torch.rsqrt(var + cfg.norm_eps)
        return (out * (1.0 + p["scale"].float())
                + p["bias"].float()).to(x.dtype)
    return cm.rms_norm(x, p["scale"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def layer_tree(cfg, lead, leaf):
    """One attention layer's params (norms, attention, MLP), each leaf made
    by ``leaf(lead + shape, std)`` (std None: a zero-initialised leaf)."""
    d, h, kh, hd, ff = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                        cfg.d_ff)

    def norm(width):
        p = {"scale": leaf(lead + (width,), None)}
        if cfg.norm == "ln":
            p["bias"] = leaf(lead + (width,), None)
        return p

    def dense(d_in, d_out):
        return leaf(lead + (d_in, d_out), 1.0 / math.sqrt(d_in))

    p = {
        "ln1": norm(d), "ln2": norm(d),
        "attn": {"wq": dense(d, h * hd), "wk": dense(d, kh * hd),
                 "wv": dense(d, kh * hd), "wo": dense(h * hd, d)},
        "mlp": {"w1": dense(d, ff), "w2": dense(ff, d)},
    }
    if cfg.gated_mlp:
        p["mlp"]["w3"] = dense(d, ff)
    if cfg.qk_norm:
        p["attn"]["q_norm"] = leaf(lead + (hd,), None)
        p["attn"]["k_norm"] = leaf(lead + (hd,), None)
    return p


def _param_tree(cfg, leaf):
    """The param tree with each leaf made by ``leaf(shape, std)``: std is
    the init's standard deviation, or None for a zero-initialised leaf."""
    n_sb, n_local, has_global = superblock_layout(cfg)
    d = cfg.d_model
    blocks = {}
    if n_local:
        blocks["local"] = layer_tree(cfg, (n_sb, n_local), leaf)
    if has_global:
        blocks["global"] = layer_tree(cfg, (n_sb,), leaf)
    params = {"emb": leaf((cfg.vocab_padded, d), 0.02), "blocks": blocks,
              "ln_f": {"scale": leaf((d,), None)}}
    if cfg.norm == "ln":
        params["ln_f"]["bias"] = leaf((d,), None)
    if not cfg.tie_embeddings:
        params["lm_head"] = leaf((cfg.vocab_padded, d), 0.02)
    return params


def param_shapes(cfg):
    """The param tree with each leaf's shape tuple in place of a tensor."""
    return _param_tree(cfg, lambda shape, std: tuple(shape))


def param_specs(cfg):
    """The param tree with each leaf's shape and dtype (``Spec``): what a
    plan or a bucket layout is compiled from."""
    dtype = torch_dtype(cfg)
    return _param_tree(cfg, lambda shape, std: Spec(tuple(shape), dtype))


def init_params(cfg, generator: torch.Generator, device="cuda"):
    """Random weights with the JAX init's distributions: N(0, 1/d_in) dense
    kernels, N(0, 0.02^2) embeddings, zero norm scales.  Numbers are drawn
    on the generator's device, one leaf at a time, and cast to cfg.dtype."""
    dtype = torch_dtype(cfg)

    def leaf(shape, std):
        if std is None:
            return torch.zeros(shape, dtype=dtype, device=device)
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) * std
        return x.to(device=device, dtype=dtype)

    return _param_tree(cfg, leaf)


# ---------------------------------------------------------------------------
# Layer compute
# ---------------------------------------------------------------------------

def _qkv(cfg, p, h):
    b, s, _ = h.shape
    q = (h @ p["wq"]).reshape(b, s, cfg.n_heads, cfg.hd)
    k = (h @ p["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.hd)
    v = (h @ p["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.hd)
    if cfg.qk_norm:
        q = cm.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = cm.rms_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def mlp(cfg, p, h):
    act = cm.act_fn(cfg.act)
    if cfg.gated_mlp:
        return (act(h @ p["w1"]) * (h @ p["w3"])) @ p["w2"]
    return act(h @ p["w1"]) @ p["w2"]


def attn_residual(cfg, p, x, positions, window, causal,
                  attention=cm.blocked_attention):
    """A layer's attention half over a whole sequence: x plus the attention
    of ``norm(x)``; returns (x, k, v) with k/v after rope, as the cache
    stores them.  ``attention`` is the prefill kernel's route, or the
    differentiable one for training."""
    b, s, _ = x.shape
    h = norm_apply(cfg, x, p["ln1"])
    q, k, v = _qkv(cfg, p["attn"], h)
    q = cm.apply_rope(q, positions, cfg.rope_theta)
    k = cm.apply_rope(k, positions, cfg.rope_theta)
    out = attention(q, k, v, causal=causal, window=window,
                    block_q=cfg.attn_block_q, block_k=cfg.attn_block_k)
    return x + out.reshape(b, s, -1) @ p["attn"]["wo"], k, v


def _attn_block(cfg, p, x, positions, window, causal,
                attention=cm.blocked_attention):
    """One layer over a whole sequence (:func:`attn_residual`, then the
    MLP); returns (x, k, v)."""
    x, k, v = attn_residual(cfg, p, x, positions, window, causal, attention)
    x = x + mlp(cfg, p["mlp"], norm_apply(cfg, x, p["ln2"]))
    return x, k, v


def attn_layer(cfg, p, x, positions, window: Optional[int]):
    return _attn_block(cfg, p, x, positions, window, cfg.causal)[0]


def embed(cfg, params, tokens):
    x = params["emb"][tokens]
    if cfg.emb_scale:
        x = x * torch.tensor(math.sqrt(float(cfg.d_model)),
                             dtype=torch.float32).to(x.dtype)
    return x


def unembed(cfg, params, x):
    table = params.get("lm_head", params["emb"])
    return x @ table.T


def embed_with_prefix(cfg, params, tokens, prefix_embeds=None):
    """The token embeddings, after ``prefix_embeds`` (B,Np,d) where given."""
    x = embed(cfg, params, tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    return x


def _positions(x):
    b, s = x.shape[:2]
    return torch.arange(s, device=x.device).expand(b, s)


# ---------------------------------------------------------------------------
# Forward (scoring)
# ---------------------------------------------------------------------------

@torch.no_grad()
def forward(cfg, params, tokens, prefix_embeds=None):
    """tokens (B,S) -> logits (B,Np+S,V)."""
    x = embed_with_prefix(cfg, params, tokens, prefix_embeds)
    positions = _positions(x)
    n_sb, n_local, has_global = superblock_layout(cfg)
    for i in range(n_sb):
        for j in range(n_local):
            lp = _index(_index(params["blocks"]["local"], i), j)
            x = attn_layer(cfg, lp, x, positions, cfg.sliding_window)
        if has_global:
            x = attn_layer(cfg, _index(params["blocks"]["global"], i), x,
                           positions, None)
    x = norm_apply(cfg, x, params["ln_f"])
    return unembed(cfg, params, x)


def forward_train(cfg, params, tokens, remat: bool = True,
                  return_hidden: bool = False, prefix_embeds=None):
    """tokens (B,S) -> logits (B,Np+S,V) with autograd: the JAX
    ``forward``.  With ``return_hidden`` the hidden state after ``ln_f``
    (B,Np+S,d) instead, before the unembed (the chunked cross-entropy's
    input).

    Attention is ``cm.differentiable_blocked_attention`` (no kernel, as in
    the JAX training loss).  ``remat`` recomputes each superblock in the
    backward (``torch.utils.checkpoint``), as ``jax.remat`` wraps the
    superblock body that JAX scans.
    """
    x = embed_with_prefix(cfg, params, tokens, prefix_embeds)
    positions = _positions(x)
    n_sb, _, _ = superblock_layout(cfg)
    for i in range(n_sb):
        x = span_apply(cfg, _index(params["blocks"], i), x, positions,
                       remat=remat)
    x = norm_apply(cfg, x, params["ln_f"])
    return x if return_hidden else unembed(cfg, params, x)


def _superblock(cfg, bp, x, positions):
    """One superblock (its local layers, then its global one) with
    autograd: the unit the training forward recomputes and the streamed
    engine's span."""
    _, n_local, has_global = superblock_layout(cfg)

    def layer(lp, x, window):
        return _attn_block(cfg, lp, x, positions, window, cfg.causal,
                           attention=cm.differentiable_blocked_attention)[0]

    for j in range(n_local):
        x = layer(_index(bp["local"], j), x, cfg.sliding_window)
    if has_global:
        x = layer(bp["global"], x, None)
    return x


# ---------------------------------------------------------------------------
# Layered decomposition (layer-streamed FSDP execution, DESIGN.md §11)
# ---------------------------------------------------------------------------

def _take(a, k: int, lead: int):
    """Slice ``k`` of a stacked leaf's superblock dim (after ``lead``
    replica dims): a view, or a ``Spec`` without that dim."""
    if isinstance(a, Spec):
        return Spec(tuple(a.shape[:lead]) + tuple(a.shape[lead + 1:]),
                    a.dtype)
    return a.select(lead, k)


def _stack(xs, lead: int):
    """Inverse of :func:`_take` over every k."""
    a = xs[0]
    if isinstance(a, Spec):
        return Spec(tuple(a.shape[:lead]) + (len(xs),)
                    + tuple(a.shape[lead:]), a.dtype)
    return torch.stack(xs, dim=lead)


def split_layered(cfg, params, lead: int = 0):
    """Full param tree -> ``{"stem", "layers", "head"}`` (views).

    One span per superblock, the unit ``forward_train`` recomputes, so
    ``span_apply(k, ...)`` composed over k is the training forward.
    ``lead`` leading replica dims pass through.  Exact inverse of
    :func:`merge_layered`.
    """
    n_sb, _, _ = superblock_layout(cfg)
    spans = tuple(tr.tree_map(lambda a: _take(a, k, lead), params["blocks"])
                  for k in range(n_sb))
    head = {"ln_f": params["ln_f"]}
    if "lm_head" in params:
        head["lm_head"] = params["lm_head"]
    return {"stem": {"emb": params["emb"]}, "layers": spans, "head": head}


def merge_layered(cfg, layered, lead: int = 0):
    """``{"stem", "layers", "head"}`` -> the canonical stacked param tree
    (the blocks stacked into new tensors)."""
    blocks = tr.tree_map(lambda *xs: _stack(xs, lead), *layered["layers"])
    params = {"emb": layered["stem"]["emb"], "blocks": blocks,
              "ln_f": layered["head"]["ln_f"]}
    if "lm_head" in layered["head"]:
        params["lm_head"] = layered["head"]["lm_head"]
    return params


def stem_apply(cfg, stem, tokens, prefix_embeds=None):
    """Embedding stem: tokens -> (x, positions), ``forward_train``'s
    prologue."""
    x = embed_with_prefix(cfg, {"emb": stem["emb"]}, tokens, prefix_embeds)
    return x, _positions(x)


def span_apply(cfg, span_params, x, positions, remat: bool = True):
    """Apply ONE superblock, the body ``forward_train`` runs per slice;
    with ``remat`` under ``checkpoint`` (recomputed in the backward), as
    ``jax.remat`` wraps the JAX scan body."""
    if remat:
        return checkpoint(_superblock, cfg, span_params, x, positions,
                          use_reentrant=False)
    return _superblock(cfg, span_params, x, positions)


def head_params_for_unembed(stem, head):
    """Pseudo param tree :func:`unembed` reads (tied or explicit lm_head)."""
    up = {"emb": stem["emb"]}
    if "lm_head" in head:
        up["lm_head"] = head["lm_head"]
    return up


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode with KV caches
# ---------------------------------------------------------------------------

def init_caches(cfg, batch: int, max_len: int, device="cuda"):
    """Per-superblock caches: ring buffers for local, full for global."""
    dtype = torch_dtype(cfg)
    n_sb, n_local, has_global = superblock_layout(cfg)
    caches = {}
    if n_local:
        w = min(cfg.sliding_window, max_len)
        c = cm.init_kv_cache(n_sb * n_local, batch, w, cfg.n_kv_heads, cfg.hd,
                             dtype, device)
        caches["local"] = {n: a.reshape((n_sb, n_local) + a.shape[1:])
                           for n, a in c.items()}
    if has_global:
        caches["global"] = cm.init_kv_cache(n_sb, batch, max_len,
                                            cfg.n_kv_heads, cfg.hd, dtype,
                                            device)
    return caches


def decode_attn_residual(cfg, p, x, ck, cv, pos, window: Optional[int]):
    """A decode layer's attention half: x (B,1,d) plus its attention over
    the cache (B,S,KH,hd), which is written in place."""
    b = x.shape[0]
    h = norm_apply(cfg, x, p["ln1"])
    q, k, v = _qkv(cfg, p["attn"], h)
    posv = pos.reshape(-1, 1).expand(b, 1)
    q = cm.apply_rope(q, posv, cfg.rope_theta)
    k = cm.apply_rope(k, posv, cfg.rope_theta)
    cm.cache_update(ck, cv, k, v, pos, ring=window is not None)
    length = torch.clamp(pos + 1, max=ck.shape[1])
    out = cm.decode_attention(q, ck, cv, length=length, window=window)
    return x + out.reshape(b, 1, -1) @ p["attn"]["wo"]


def _decode_layer(cfg, p, x, ck, cv, pos, window: Optional[int]):
    """One decode layer; x (B,1,d); cache (B,S,KH,hd) written in place."""
    x = decode_attn_residual(cfg, p, x, ck, cv, pos, window)
    return x + mlp(cfg, p["mlp"], norm_apply(cfg, x, p["ln2"]))


@torch.no_grad()
def decode_step(cfg, params, caches, token, pos):
    """token (B,1) int; pos an int or a (B,) int tensor -> (logits (B,1,V),
    caches).  The caches are updated in place and returned."""
    x = embed(cfg, params, token)
    pos = torch.as_tensor(pos, device=x.device).to(torch.int64)
    n_sb, n_local, has_global = superblock_layout(cfg)
    for i in range(n_sb):
        for j in range(n_local):
            lp = _index(_index(params["blocks"]["local"], i), j)
            x = _decode_layer(cfg, lp, x, caches["local"]["k"][i, j],
                              caches["local"]["v"][i, j], pos,
                              cfg.sliding_window)
        if has_global:
            x = _decode_layer(cfg, _index(params["blocks"]["global"], i), x,
                              caches["global"]["k"][i],
                              caches["global"]["v"][i], pos, None)
    x = norm_apply(cfg, x, params["ln_f"])
    return unembed(cfg, params, x), caches


def window_ring(a, window: int, max_len: int):
    """A prefill's K or V (B,S,KH,hd) -> the ring cache of a windowed layer,
    (B, min(window, max_len), KH, hd): slot j holds the latest position p
    with p % w == j, i.e. p_j = S-1 - ((S-1-j) % w); slots without a
    position are zero."""
    s = a.shape[1]
    w = min(window, max_len)
    j = torch.arange(w, device=a.device)
    p_j = (s - 1) - torch.remainder(s - 1 - j, w)
    taken = a[:, torch.clamp(p_j, 0, s - 1)]
    return torch.where((p_j >= 0)[None, :, None, None], taken,
                       torch.zeros((), dtype=a.dtype, device=a.device))


def pad_cache(a, max_len: int):
    """A prefill's K or V (B,S,KH,hd) -> the full cache of a global layer,
    (B,max_len,KH,hd), zero past S."""
    b, s = a.shape[:2]
    if max_len == s:
        return a
    out = a.new_zeros((b, max_len) + a.shape[2:])
    out[:, :s] = a
    return out


@torch.no_grad()
def prefill(cfg, params, tokens, max_len: Optional[int] = None,
            prefix_embeds=None):
    """Fill caches for tokens (B,S) after ``prefix_embeds`` (B,Np,d) where
    given; returns (last-token logits, caches).  ``max_len`` counts the
    prefix's positions too.

    The cache is the product of the forward pass: each layer's K/V after
    rope.  Global caches are padded to ``max_len`` after attention, so the
    prompt itself is never padded; local layers keep the trailing window in
    ring order.
    """
    x = embed_with_prefix(cfg, params, tokens, prefix_embeds)
    b, s, _ = x.shape
    max_len = max_len or s
    positions = _positions(x)
    n_sb, n_local, has_global = superblock_layout(cfg)

    local_k, local_v, global_k, global_v = [], [], [], []
    for i in range(n_sb):
        lk, lv = [], []
        for j in range(n_local):
            lp = _index(_index(params["blocks"]["local"], i), j)
            x, k, v = _attn_block(cfg, lp, x, positions, cfg.sliding_window,
                                  True)
            lk.append(window_ring(k, cfg.sliding_window, max_len))
            lv.append(window_ring(v, cfg.sliding_window, max_len))
        if n_local:
            local_k.append(torch.stack(lk))
            local_v.append(torch.stack(lv))
        if has_global:
            x, k, v = _attn_block(cfg, _index(params["blocks"]["global"], i),
                                  x, positions, None, True)
            global_k.append(pad_cache(k, max_len))
            global_v.append(pad_cache(v, max_len))
    caches = {}
    if n_local:
        caches["local"] = {"k": torch.stack(local_k), "v": torch.stack(local_v)}
    if has_global:
        caches["global"] = {"k": torch.stack(global_k),
                            "v": torch.stack(global_v)}
    x = norm_apply(cfg, x, params["ln_f"])
    return unembed(cfg, params, x[:, -1:]), caches
