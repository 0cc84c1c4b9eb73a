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

**The model axis.**  Every entry point takes ``mw``, the model world of
one replica (``common.ModelWorld``), or ``None``.  With a model world the
params are this rank's slices by ``common.placement`` (Megatron's split:
q/k/v and w1/w3 by column, head-aligned for attention, wo and w2 by row,
emb and lm_head by vocab) and each function computes the rank's part:
the rank's q heads and their KV heads (split where the KV heads divide
over the ranks, else computed whole and read by head), ``copy_to_model``
on each split computation's input and ``reduce_from_model`` on its
output, so the residual stream is whole on every rank, and logits of the
rank's vocab columns.  A dim the placement holds whole is computed
replicated.  The caches hold the rank's KV heads (all of them where those
are computed whole).

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
# The model axis: which heads a rank computes
# ---------------------------------------------------------------------------

def heads_split(cfg, mw) -> bool:
    """Whether the rank computes a slice of the q heads (the placement
    splits ``wq`` into whole heads)."""
    return mw is not None and cm.model_slice(
        (None, "model"), (cfg.d_model, cfg.n_heads * cfg.hd), mw.size,
        cfg.n_heads) is not None


def kv_heads_held(cfg, mw) -> int:
    """The KV heads a rank holds and caches: its slice where the KV heads
    split over the ranks, else all of them (computed whole)."""
    if mw is not None and cm.model_slice(
            (None, "model"), (cfg.d_model, cfg.n_kv_heads * cfg.hd), mw.size,
            cfg.n_kv_heads) is not None:
        return cfg.n_kv_heads // mw.size
    return cfg.n_kv_heads


def kv_of_rank(cfg, k, v, mw):
    """The KV heads (B,S,KH,hd) that the rank's q heads read: all of ``k``
    and ``v`` where they are the rank's slice, else the run of whole heads
    its q heads map to (a view), or one head per q head where the run is
    uneven."""
    if not heads_split(cfg, mw) or kv_heads_held(cfg, mw) < cfg.n_kv_heads:
        return k, v
    hl = cfg.n_heads // mw.size
    rep = cfg.n_heads // cfg.n_kv_heads
    idx = [(mw.rank * hl + i) // rep for i in range(hl)]
    lo, n = idx[0], idx[-1] + 1 - idx[0]
    if hl % n == 0 and all(j - lo == i // (hl // n)
                           for i, j in enumerate(idx)):
        return k[:, :, lo:lo + n], v[:, :, lo:lo + n]
    sel = torch.tensor(idx, device=k.device)
    return k.index_select(2, sel), v.index_select(2, sel)


def vocab_split(cfg, params, mw) -> bool:
    """Whether the rank holds a slice of the embedding's vocab rows."""
    return mw is not None and params["emb"].shape[0] < cfg.vocab_padded


# ---------------------------------------------------------------------------
# Layer compute
# ---------------------------------------------------------------------------

def _qkv(cfg, p, h, mw=None):
    """q, k, v of ``h``: the rank's heads with a model world (``mw`` given
    only where the q heads split).  Leaves held whole whose use here sees
    only the rank's heads (``q_norm``, ``k_norm``, and ``wk``/``wv`` where
    the KV heads are computed whole) pass through ``copy_to_model``, so
    their gradients are the sum over the ranks."""
    b, s, _ = h.shape
    wk, wv = p["wk"], p["wv"]
    if kv_heads_held(cfg, mw) == cfg.n_kv_heads:
        wk, wv = cm.copy_to_model(wk, mw), cm.copy_to_model(wv, mw)
    q = (h @ p["wq"]).reshape(b, s, -1, cfg.hd)
    k = (h @ wk).reshape(b, s, -1, cfg.hd)
    v = (h @ wv).reshape(b, s, -1, cfg.hd)
    if cfg.qk_norm:
        q = cm.rms_norm(q, cm.copy_to_model(p["q_norm"], mw), cfg.norm_eps)
        k = cm.rms_norm(k, cm.copy_to_model(p["k_norm"], mw), cfg.norm_eps)
    return q, k, v


def mlp(cfg, p, h, mw=None):
    """The MLP of ``h``; with a model world whose placement splits d_ff,
    the rank's w1/w3 columns and w2 rows, summed over the ranks."""
    if mw is not None and p["w1"].shape[-1] == cfg.d_ff:
        mw = None
    h = cm.copy_to_model(h, mw)
    act = cm.act_fn(cfg.act)
    if cfg.gated_mlp:
        out = (act(h @ p["w1"]) * (h @ p["w3"])) @ p["w2"]
    else:
        out = act(h @ p["w1"]) @ p["w2"]
    return cm.reduce_from_model(out, mw)


def attn_residual(cfg, p, x, positions, window, causal,
                  attention=cm.blocked_attention, mw=None):
    """A layer's attention half over a whole sequence: x plus the attention
    of ``norm(x)``; returns (x, k, v) with k/v after rope, as the cache
    stores them.  ``attention`` is the prefill kernel's route, or the
    differentiable one for training.  With a model world: the rank's q
    heads, ``wo``'s rows and the sum over the ranks."""
    b, s, _ = x.shape
    mw = mw if heads_split(cfg, mw) else None
    h = cm.copy_to_model(norm_apply(cfg, x, p["ln1"]), mw)
    q, k, v = _qkv(cfg, p["attn"], h, mw)
    q = cm.apply_rope(q, positions, cfg.rope_theta)
    k = cm.apply_rope(k, positions, cfg.rope_theta)
    kq, vq = kv_of_rank(cfg, k, v, mw)
    out = attention(q, kq, vq, causal=causal, window=window,
                    block_q=cfg.attn_block_q, block_k=cfg.attn_block_k)
    out = cm.reduce_from_model(out.reshape(b, s, -1) @ p["attn"]["wo"], mw)
    return x + out, k, v


def _attn_block(cfg, p, x, positions, window, causal,
                attention=cm.blocked_attention, mw=None):
    """One layer over a whole sequence (:func:`attn_residual`, then the
    MLP); returns (x, k, v)."""
    x, k, v = attn_residual(cfg, p, x, positions, window, causal, attention,
                            mw)
    x = x + mlp(cfg, p["mlp"], norm_apply(cfg, x, p["ln2"]), mw)
    return x, k, v


def attn_layer(cfg, p, x, positions, window: Optional[int], mw=None):
    return _attn_block(cfg, p, x, positions, window, cfg.causal, mw=mw)[0]


def lookup(cfg, table, tokens, mw=None):
    """The rows of an embedding ``table`` (``emb``, or an encoder's
    ``src_emb``) for ``tokens``; with a vocab-split table, this rank's rows
    (zero for a token outside them) summed over the ranks: one term is
    non-zero, so the sum is exact."""
    if mw is None or table.shape[0] == cfg.vocab_padded:
        return table[tokens]
    n = table.shape[0]
    local = tokens - mw.rank * n
    inside = ((local >= 0) & (local < n))[..., None]
    return cm.reduce_from_model(
        torch.where(inside, table[local.clamp(0, n - 1)], 0.0), mw)


def embed(cfg, params, tokens, mw=None):
    """The token embeddings (:func:`lookup` of ``emb``), scaled by
    sqrt(d_model) where the config says so."""
    x = lookup(cfg, params["emb"], tokens, mw)
    if cfg.emb_scale:
        x = x * torch.tensor(math.sqrt(float(cfg.d_model)),
                             dtype=torch.float32).to(x.dtype)
    return x


def unembed(cfg, params, x, mw=None):
    """Logits of ``x``; with a vocab-split table (tied or not), this
    rank's vocab columns."""
    table = params.get("lm_head", params["emb"])
    if vocab_split(cfg, params, mw):
        x = cm.copy_to_model(x, mw)
    return x @ table.T


def embed_with_prefix(cfg, params, tokens, prefix_embeds=None, mw=None):
    """The token embeddings, after ``prefix_embeds`` (B,Np,d) where given."""
    x = embed(cfg, params, tokens, mw)
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
def forward(cfg, params, tokens, prefix_embeds=None, mw=None):
    """tokens (B,S) -> logits (B,Np+S,V) (the rank's vocab columns with a
    vocab-split model world)."""
    x = embed_with_prefix(cfg, params, tokens, prefix_embeds, mw)
    positions = _positions(x)
    n_sb, n_local, has_global = superblock_layout(cfg)
    for i in range(n_sb):
        for j in range(n_local):
            lp = _index(_index(params["blocks"]["local"], i), j)
            x = attn_layer(cfg, lp, x, positions, cfg.sliding_window, mw)
        if has_global:
            x = attn_layer(cfg, _index(params["blocks"]["global"], i), x,
                           positions, None, mw)
    x = norm_apply(cfg, x, params["ln_f"])
    return unembed(cfg, params, x, mw)


def forward_train(cfg, params, tokens, remat: bool = True,
                  return_hidden: bool = False, prefix_embeds=None, mw=None):
    """tokens (B,S) -> logits (B,Np+S,V) with autograd: the JAX
    ``forward``.  With ``return_hidden`` the hidden state after ``ln_f``
    (B,Np+S,d) instead, before the unembed (the chunked cross-entropy's
    input).

    Attention is ``cm.differentiable_blocked_attention`` (no kernel, as in
    the JAX training loss).  ``remat`` recomputes each superblock in the
    backward (``torch.utils.checkpoint``), as ``jax.remat`` wraps the
    superblock body that JAX scans.  With a model world the logits are
    the rank's vocab columns; the hidden state is whole.
    """
    x = embed_with_prefix(cfg, params, tokens, prefix_embeds, mw)
    positions = _positions(x)
    n_sb, _, _ = superblock_layout(cfg)
    for i in range(n_sb):
        x = span_apply(cfg, _index(params["blocks"], i), x, positions,
                       remat=remat, mw=mw)
    x = norm_apply(cfg, x, params["ln_f"])
    return x if return_hidden else unembed(cfg, params, x, mw)


def _superblock(cfg, bp, x, positions, mw=None):
    """One superblock (its local layers, then its global one) with
    autograd: the unit the training forward recomputes and the streamed
    engine's span."""
    _, n_local, has_global = superblock_layout(cfg)

    def layer(lp, x, window):
        return _attn_block(cfg, lp, x, positions, window, cfg.causal,
                           attention=cm.differentiable_blocked_attention,
                           mw=mw)[0]

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
    """Full param tree (or a model rank's slice tree) -> ``{"stem",
    "layers", "head"}`` (views).

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


def stem_apply(cfg, stem, tokens, prefix_embeds=None, mw=None):
    """Embedding stem: tokens -> (x, positions), ``forward_train``'s
    prologue (a vocab-parallel lookup with a vocab-split ``emb``)."""
    x = embed_with_prefix(cfg, {"emb": stem["emb"]}, tokens, prefix_embeds,
                          mw)
    return x, _positions(x)


def span_apply(cfg, span_params, x, positions, remat: bool = True,
               mw=None):
    """Apply ONE superblock, the body ``forward_train`` runs per slice;
    with ``remat`` under ``checkpoint`` (recomputed in the backward), as
    ``jax.remat`` wraps the JAX scan body."""
    if remat:
        return checkpoint(_superblock, cfg, span_params, x, positions, mw,
                          use_reentrant=False)
    return _superblock(cfg, span_params, x, positions, mw)


def head_params_for_unembed(stem, head):
    """Pseudo param tree :func:`unembed` reads (tied or explicit lm_head)."""
    up = {"emb": stem["emb"]}
    if "lm_head" in head:
        up["lm_head"] = head["lm_head"]
    return up


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode with KV caches
# ---------------------------------------------------------------------------

def init_caches(cfg, batch: int, max_len: int, device="cuda", mw=None):
    """Per-superblock caches: ring buffers for local, full for global; of
    the KV heads the rank holds (:func:`kv_heads_held`)."""
    dtype = torch_dtype(cfg)
    n_sb, n_local, has_global = superblock_layout(cfg)
    kh = kv_heads_held(cfg, mw)
    caches = {}
    if n_local:
        w = min(cfg.sliding_window, max_len)
        c = cm.init_kv_cache(n_sb * n_local, batch, w, kh, cfg.hd, dtype,
                             device)
        caches["local"] = {n: a.reshape((n_sb, n_local) + a.shape[1:])
                           for n, a in c.items()}
    if has_global:
        caches["global"] = cm.init_kv_cache(n_sb, batch, max_len, kh, cfg.hd,
                                            dtype, device)
    return caches


def decode_attn_residual(cfg, p, x, ck, cv, pos, window: Optional[int],
                         mw=None):
    """A decode layer's attention half: x (B,1,d) plus its attention over
    the cache (B,S,KH,hd), which is written in place."""
    b = x.shape[0]
    mw = mw if heads_split(cfg, mw) else None
    h = cm.copy_to_model(norm_apply(cfg, x, p["ln1"]), mw)
    q, k, v = _qkv(cfg, p["attn"], h, mw)
    posv = pos.reshape(-1, 1).expand(b, 1)
    q = cm.apply_rope(q, posv, cfg.rope_theta)
    k = cm.apply_rope(k, posv, cfg.rope_theta)
    cm.cache_update(ck, cv, k, v, pos, ring=window is not None)
    length = torch.clamp(pos + 1, max=ck.shape[1])
    kq, vq = kv_of_rank(cfg, ck, cv, mw)
    out = cm.decode_attention(q, kq, vq, length=length, window=window)
    return x + cm.reduce_from_model(out.reshape(b, 1, -1) @ p["attn"]["wo"],
                                    mw)


def _decode_layer(cfg, p, x, ck, cv, pos, window: Optional[int], mw=None):
    """One decode layer; x (B,1,d); cache (B,S,KH,hd) written in place."""
    x = decode_attn_residual(cfg, p, x, ck, cv, pos, window, mw)
    return x + mlp(cfg, p["mlp"], norm_apply(cfg, x, p["ln2"]), mw)


@torch.no_grad()
def decode_step(cfg, params, caches, token, pos, mw=None):
    """token (B,1) int; pos an int or a (B,) int tensor -> (logits (B,1,V),
    caches): the rank's vocab columns with a vocab-split model world.  The
    caches are updated in place and returned."""
    x = embed(cfg, params, token, mw)
    pos = torch.as_tensor(pos, device=x.device).to(torch.int64)
    n_sb, n_local, has_global = superblock_layout(cfg)
    for i in range(n_sb):
        for j in range(n_local):
            lp = _index(_index(params["blocks"]["local"], i), j)
            x = _decode_layer(cfg, lp, x, caches["local"]["k"][i, j],
                              caches["local"]["v"][i, j], pos,
                              cfg.sliding_window, mw)
        if has_global:
            x = _decode_layer(cfg, _index(params["blocks"]["global"], i), x,
                              caches["global"]["k"][i],
                              caches["global"]["v"][i], pos, None, mw)
    x = norm_apply(cfg, x, params["ln_f"])
    return unembed(cfg, params, x, mw), caches


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
            prefix_embeds=None, mw=None):
    """Fill caches for tokens (B,S) after ``prefix_embeds`` (B,Np,d) where
    given; returns (last-token logits, caches).  ``max_len`` counts the
    prefix's positions too.

    The cache is the product of the forward pass: each layer's K/V after
    rope.  Global caches are padded to ``max_len`` after attention, so the
    prompt itself is never padded; local layers keep the trailing window in
    ring order.  With a model world: the caches of the rank's KV heads
    and the last logits of its vocab columns.
    """
    x = embed_with_prefix(cfg, params, tokens, prefix_embeds, mw)
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
                                  True, mw=mw)
            lk.append(window_ring(k, cfg.sliding_window, max_len))
            lv.append(window_ring(v, cfg.sliding_window, max_len))
        if n_local:
            local_k.append(torch.stack(lk))
            local_v.append(torch.stack(lv))
        if has_global:
            x, k, v = _attn_block(cfg, _index(params["blocks"]["global"], i),
                                  x, positions, None, True, mw=mw)
            global_k.append(pad_cache(k, max_len))
            global_v.append(pad_cache(v, max_len))
    caches = {}
    if n_local:
        caches["local"] = {"k": torch.stack(local_k), "v": torch.stack(local_v)}
    if has_global:
        caches["global"] = {"k": torch.stack(global_k),
                            "v": torch.stack(global_v)}
    x = norm_apply(cfg, x, params["ln_f"])
    return unembed(cfg, params, x[:, -1:], mw), caches
