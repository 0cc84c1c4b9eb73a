"""Encoder-decoder transformer: whisper-medium backbone + transformer_wmt,
counterpart of ``repro/models/encdec.py``.

The whisper *modality frontend* (mel-spectrogram + conv feature extractor)
is a stub: the batch's ``frames`` are precomputed frame embeddings
(B, encoder_frames, d_model).  transformer_wmt's encoder consumes source
tokens (``src``, embedded by ``src_emb``) instead.  The encoder applies
RoPE in every layer *and* adds the learned ``enc_pos``; the decoder's
self-attention uses RoPE.  Cross-attention K/V are computed from the
encoder output once at prefill and cached.

Parameters are a dict with the JAX package's tree and layouts: the layers
stacked on a leading layer dim under ``enc_blocks`` and ``dec_blocks``
(each decoder layer with ``cross`` and ``ln_x`` besides the dense layer's
leaves), ``emb`` (tied), ``enc_pos``, ``ln_enc``, ``ln_f`` and, for a
token encoder, ``src_emb``.

Entry points (each also takes ``mw``, below):
    init_params(cfg, generator, device)
    forward(cfg, params, tokens, enc_input) -> logits (scoring, no autograd)
    forward_train(cfg, params, tokens, enc_input, remat, return_hidden)
        -> logits, or the hidden state after ``ln_f`` (with autograd)
    prefill(cfg, params, tokens, enc_input, max_len) -> (last_logits, caches)
    decode_step(cfg, params, caches, token, pos) -> (logits, caches)

**The model axis.**  Every entry point takes ``mw``, the model world of
one replica (``common.ModelWorld``), as ``models/transformer.py``'s do:
the encoder's and the decoder's layers split their heads, the
cross-attention's ``wq``/``wk``/``wv``/``wo`` split by heads like
self-attention, the MLPs ``d_ff``, ``emb`` and ``src_emb`` their vocab
(a masked lookup summed over the ranks), and the residual streams stay
whole.  The encoder's output enters every rank whole, and each rank
computes the cross K/V of its own heads, under ``copy_to_model`` once
(``_cross_input``) so that the encoder's gradient, ``enc_pos``'s among
it, is the sum over the ranks.  The caches, self and cross, hold the
rank's KV heads.

Every prefill and scoring attention (encoder, decoder, cross) goes through
``cm.blocked_attention``, which is the Hopper kernel K3 on CUDA tensors;
``forward_train`` uses ``cm.differentiable_blocked_attention`` and
recomputes each layer in the backward, as ``jax.remat`` does; decode uses
``cm.decode_attention`` and writes the self-attention cache in place.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.tree import Spec
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm

ENC_POS_DEFAULT = 4096       # enc_pos rows of a token encoder
CROSS_CACHE_DEFAULT = 128    # init_caches' cross length for a token encoder


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def _param_tree(cfg, leaf):
    """The param tree with each leaf made by ``leaf(shape, std)`` (std None:
    a zero-initialised leaf)."""
    d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    n_dec = (cfg.n_layers,)

    def dense(d_in, d_out):
        return leaf(n_dec + (d_in, d_out), 1.0 / math.sqrt(d_in))

    def norm(lead):
        p = {"scale": leaf(lead + (d,), None)}
        if cfg.norm == "ln":
            p["bias"] = leaf(lead + (d,), None)
        return p

    dec = tfm.layer_tree(cfg, n_dec, leaf)
    dec["cross"] = {"wq": dense(d, h * hd), "wk": dense(d, kh * hd),
                    "wv": dense(d, kh * hd), "wo": dense(h * hd, d)}
    dec["ln_x"] = norm(n_dec)
    params = {
        "enc_blocks": tfm.layer_tree(cfg.variant(causal=False),
                                     (cfg.encoder_layers,), leaf),
        "dec_blocks": dec,
        "emb": leaf((cfg.vocab_padded, d), 0.02),
        "enc_pos": leaf((cfg.encoder_frames or ENC_POS_DEFAULT, d), 0.02),
        "ln_enc": norm(()),
        "ln_f": norm(()),
    }
    if cfg.encoder_frames == 0:           # wmt: token encoder
        params["src_emb"] = leaf((cfg.vocab_padded, d), 0.02)
    return params


def param_specs(cfg):
    """The param tree with each leaf's shape and dtype (``Spec``)."""
    dtype = tfm.torch_dtype(cfg)
    return _param_tree(cfg, lambda shape, std: Spec(tuple(shape), dtype))


def init_params(cfg, generator: torch.Generator, device="cuda"):
    """Random weights with the JAX init's distributions: N(0, 1/d_in) dense
    kernels, N(0, 0.02^2) embeddings and ``enc_pos``, zero norms.  Numbers
    are drawn on the generator's device, one leaf at a time, in float32 and
    cast to cfg.dtype."""
    dtype = tfm.torch_dtype(cfg)

    def leaf(shape, std):
        if std is None:
            return torch.zeros(shape, dtype=dtype, device=device)
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) * std
        return x.to(device=device, dtype=dtype)

    return _param_tree(cfg, leaf)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _enc_embed(cfg, params, enc_input, mw=None):
    """enc_input: frame embeddings (B,F,d) [audio stub] or tokens (B,F)
    [wmt] -> (B,F,d) with ``enc_pos`` added (held whole: its gradient,
    the residual stream's at the encoder's input, is whole on every
    rank)."""
    if enc_input.dim() == 2:
        x = tfm.lookup(cfg, params["src_emb"], enc_input, mw)
    else:
        x = enc_input.to(tfm.torch_dtype(cfg))
    return x + params["enc_pos"][:x.shape[1]]


def encode(cfg, params, enc_input, attention=cm.blocked_attention,
           remat: bool = False, mw=None):
    """The encoder's output (B,F,d) after ``ln_enc``: non-causal layers
    with RoPE, whole on every rank of a model world.  ``attention`` is
    K3's route or the differentiable one; ``remat`` recomputes each layer
    in the backward."""
    x = _enc_embed(cfg, params, enc_input, mw)
    positions = tfm._positions(x)
    enc_cfg = cfg.variant(causal=False)

    def layer(x, p):
        return tfm._attn_block(enc_cfg, p, x, positions, None, False,
                               attention=attention, mw=mw)[0]

    for i in range(cfg.encoder_layers):
        p = tfm._index(params["enc_blocks"], i)
        x = (checkpoint(layer, x, p, use_reentrant=False) if remat
             else layer(x, p))
    return tfm.norm_apply(cfg, x, params["ln_enc"])


def _cross_input(cfg, enc_out, mw=None):
    """The encoder output as every decoder layer's cross-attention reads
    it: under ``copy_to_model`` where the heads split, since each rank's
    cross K/V see only its heads, so that the gradient of ``enc_out`` (and
    of the whole encoder, ``enc_pos`` among it) is the sum over the
    ranks."""
    return cm.copy_to_model(enc_out, mw if tfm.heads_split(cfg, mw) else None)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def _enc_kv(cfg, p, enc_out, mw=None):
    """The cross K/V of ``enc_out`` (B,F,d): the rank's KV heads, or all
    of them where they are computed whole (``wk``/``wv`` then under
    ``copy_to_model``, as ``transformer._qkv`` holds them)."""
    b, f, _ = enc_out.shape
    wk, wv = p["wk"], p["wv"]
    if tfm.kv_heads_held(cfg, mw) == cfg.n_kv_heads:
        wk, wv = cm.copy_to_model(wk, mw), cm.copy_to_model(wv, mw)
    ek = (enc_out @ wk).reshape(b, f, -1, cfg.hd)
    ev = (enc_out @ wv).reshape(b, f, -1, cfg.hd)
    return ek, ev


def _cross_attn(cfg, p, x, enc_kv, attention=cm.blocked_attention, mw=None):
    """The cross-attention of ``x`` (B,S,d) over the cached cross K/V:
    with a model world the rank's q heads, ``wo``'s rows and the sum over
    the ranks (*g*), as self-attention splits."""
    b, s, _ = x.shape
    mw = mw if tfm.heads_split(cfg, mw) else None
    q = (cm.copy_to_model(x, mw) @ p["wq"]).reshape(b, s, -1, cfg.hd)
    ek, ev = tfm.kv_of_rank(cfg, *enc_kv, mw)
    out = attention(q, ek, ev, causal=False, block_q=cfg.attn_block_q,
                    block_k=cfg.attn_block_k)
    return cm.reduce_from_model(out.reshape(b, s, -1) @ p["wo"], mw)


def _cross_decode(cfg, p, x, xk, xv, mw=None):
    """One token's cross-attention (x (B,1,d)) over the cached cross K/V
    (B,F,KH,hd), read whole; split over the model ranks as
    :func:`_cross_attn`."""
    b = x.shape[0]
    mw = mw if tfm.heads_split(cfg, mw) else None
    xk, xv = tfm.kv_of_rank(cfg, xk, xv, mw)
    q = (cm.copy_to_model(x, mw) @ p["wq"]).reshape(b, 1, -1, cfg.hd)
    out = cm.decode_attention(q, xk, xv, length=xk.shape[1])
    return cm.reduce_from_model(out.reshape(b, 1, -1) @ p["wo"], mw)


def _dec_block(cfg, p, x, positions, enc_out, attention, mw=None):
    """One decoder layer over a whole sequence; returns (x, k, v, ek, ev):
    the self-attention K/V after rope and the cross K/V, as the caches hold
    them (the rank's KV heads with a model world)."""
    x, k, v = tfm.attn_residual(cfg, p, x, positions, None, True, attention,
                                mw)
    hx = tfm.norm_apply(cfg, x, p["ln_x"])
    ek, ev = _enc_kv(cfg, p["cross"], enc_out, mw)
    x = x + _cross_attn(cfg, p["cross"], hx, (ek, ev), attention, mw)
    x = x + tfm.mlp(cfg, p["mlp"], tfm.norm_apply(cfg, x, p["ln2"]), mw)
    return x, k, v, ek, ev


def dec_layer(cfg, p, x, positions, enc_out, mw=None):
    return _dec_block(cfg, p, x, positions, enc_out, cm.blocked_attention,
                      mw)[0]


@torch.no_grad()
def forward(cfg, params, tokens, enc_input, mw=None):
    """(enc_input, decoder tokens (B,S)) -> decoder logits (B,S,V) (the
    rank's vocab columns with a vocab-split model world)."""
    enc_out = _cross_input(cfg, encode(cfg, params, enc_input, mw=mw), mw)
    x = tfm.embed(cfg, params, tokens, mw)
    positions = tfm._positions(x)
    for i in range(cfg.n_layers):
        x = dec_layer(cfg, tfm._index(params["dec_blocks"], i), x, positions,
                      enc_out, mw)
    x = tfm.norm_apply(cfg, x, params["ln_f"])
    return tfm.unembed(cfg, params, x, mw)


def forward_train(cfg, params, tokens, enc_input, remat: bool = True,
                  return_hidden: bool = False, mw=None):
    """:func:`forward` with autograd: the JAX ``forward`` that the training
    loss differentiates.  Attention is ``cm.differentiable_blocked_attention``
    (non-causal in the encoder and the cross-attention, causal in the
    decoder's self-attention); ``remat`` recomputes every encoder and
    decoder layer in the backward (``torch.utils.checkpoint``), as
    ``jax.remat`` wraps both scans' bodies.  With ``return_hidden`` the
    hidden state after ``ln_f`` (whole on every rank) instead of the
    logits."""
    attention = cm.differentiable_blocked_attention
    enc_out = _cross_input(cfg, encode(cfg, params, enc_input,
                                       attention=attention, remat=remat,
                                       mw=mw), mw)
    x = tfm.embed(cfg, params, tokens, mw)
    positions = tfm._positions(x)

    def layer(x, p, enc_out):
        return _dec_block(cfg, p, x, positions, enc_out, attention, mw)[0]

    for i in range(cfg.n_layers):
        p = tfm._index(params["dec_blocks"], i)
        x = (checkpoint(layer, x, p, enc_out, use_reentrant=False) if remat
             else layer(x, p, enc_out))
    x = tfm.norm_apply(cfg, x, params["ln_f"])
    return x if return_hidden else tfm.unembed(cfg, params, x, mw)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_caches(cfg, batch: int, max_len: int, device="cuda", mw=None):
    """Self-attention caches of ``max_len`` and cross caches of the encoder
    length (``encoder_frames``, or 128 for a token encoder), of the KV
    heads the rank holds (``transformer.kv_heads_held``)."""
    dtype = tfm.torch_dtype(cfg)
    f = cfg.encoder_frames or CROSS_CACHE_DEFAULT
    kh = tfm.kv_heads_held(cfg, mw)
    return {"self": cm.init_kv_cache(cfg.n_layers, batch, max_len, kh,
                                     cfg.hd, dtype, device),
            "cross": cm.init_kv_cache(cfg.n_layers, batch, f, kh, cfg.hd,
                                      dtype, device)}


@torch.no_grad()
def prefill(cfg, params, tokens, enc_input, max_len: Optional[int] = None,
            mw=None):
    """Encode the source, compute every layer's cross K/V, consume the
    prompt tokens (B,S); returns (last-token logits, caches).  The self
    caches are padded to ``max_len`` after attention; the cross caches hold
    the source's real length.  With a model world: the caches of the
    rank's KV heads and the last logits of its vocab columns."""
    enc_out = encode(cfg, params, enc_input, mw=mw)
    x = tfm.embed(cfg, params, tokens, mw)
    b, s, _ = x.shape
    max_len = max_len or s
    positions = tfm._positions(x)
    ks, vs, eks, evs = [], [], [], []
    for i in range(cfg.n_layers):
        x, k, v, ek, ev = _dec_block(cfg, tfm._index(params["dec_blocks"], i),
                                     x, positions, enc_out,
                                     cm.blocked_attention, mw)
        if max_len > s:
            pad = (0, 0, 0, 0, 0, max_len - s)
            k, v = (torch.nn.functional.pad(a, pad) for a in (k, v))
        ks.append(k)
        vs.append(v)
        eks.append(ek)
        evs.append(ev)
    x = tfm.norm_apply(cfg, x, params["ln_f"])
    caches = {"self": {"k": torch.stack(ks), "v": torch.stack(vs)},
              "cross": {"k": torch.stack(eks), "v": torch.stack(evs)}}
    return tfm.unembed(cfg, params, x[:, -1:], mw), caches


@torch.no_grad()
def decode_step(cfg, params, caches, token, pos, mw=None):
    """token (B,1) int; pos an int or a (B,) int tensor -> (logits (B,1,V),
    caches): the rank's vocab columns with a vocab-split model world.  The
    self caches are updated in place and returned; the cross caches are
    read whole."""
    x = tfm.embed(cfg, params, token, mw)
    pos = torch.as_tensor(pos, device=x.device).to(torch.int64)
    for i in range(cfg.n_layers):
        p = tfm._index(params["dec_blocks"], i)
        x = tfm.decode_attn_residual(cfg, p, x, caches["self"]["k"][i],
                                     caches["self"]["v"][i], pos, None, mw)
        x = x + _cross_decode(cfg, p["cross"],
                              tfm.norm_apply(cfg, x, p["ln_x"]),
                              caches["cross"]["k"][i],
                              caches["cross"]["v"][i], mw)
        x = x + tfm.mlp(cfg, p["mlp"], tfm.norm_apply(cfg, x, p["ln2"]), mw)
    x = tfm.norm_apply(cfg, x, params["ln_f"])
    return tfm.unembed(cfg, params, x, mw), caches
