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

Entry points:
    init_params(cfg, generator, device)
    forward(cfg, params, tokens, enc_input) -> logits (scoring, no autograd)
    forward_train(cfg, params, tokens, enc_input, remat, return_hidden)
        -> logits, or the hidden state after ``ln_f`` (with autograd)
    prefill(cfg, params, tokens, enc_input, max_len) -> (last_logits, caches)
    decode_step(cfg, params, caches, token, pos) -> (logits, caches)

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

def _enc_embed(cfg, params, enc_input):
    """enc_input: frame embeddings (B,F,d) [audio stub] or tokens (B,F)
    [wmt] -> (B,F,d) with ``enc_pos`` added."""
    if enc_input.dim() == 2:
        x = params["src_emb"][enc_input]
    else:
        x = enc_input.to(tfm.torch_dtype(cfg))
    return x + params["enc_pos"][:x.shape[1]]


def encode(cfg, params, enc_input, attention=cm.blocked_attention,
           remat: bool = False):
    """The encoder's output (B,F,d) after ``ln_enc``: non-causal layers
    with RoPE.  ``attention`` is K3's route or the differentiable one;
    ``remat`` recomputes each layer in the backward."""
    x = _enc_embed(cfg, params, enc_input)
    positions = tfm._positions(x)
    enc_cfg = cfg.variant(causal=False)

    def layer(x, p):
        return tfm._attn_block(enc_cfg, p, x, positions, None, False,
                               attention=attention)[0]

    for i in range(cfg.encoder_layers):
        p = tfm._index(params["enc_blocks"], i)
        x = (checkpoint(layer, x, p, use_reentrant=False) if remat
             else layer(x, p))
    return tfm.norm_apply(cfg, x, params["ln_enc"])


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def _enc_kv(cfg, p, enc_out):
    b, f, _ = enc_out.shape
    ek = (enc_out @ p["wk"]).reshape(b, f, cfg.n_kv_heads, cfg.hd)
    ev = (enc_out @ p["wv"]).reshape(b, f, cfg.n_kv_heads, cfg.hd)
    return ek, ev


def _cross_attn(cfg, p, x, enc_kv, attention=cm.blocked_attention):
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, cfg.n_heads, cfg.hd)
    ek, ev = enc_kv
    out = attention(q, ek, ev, causal=False, block_q=cfg.attn_block_q,
                    block_k=cfg.attn_block_k)
    return out.reshape(b, s, -1) @ p["wo"]


def _dec_block(cfg, p, x, positions, enc_out, attention):
    """One decoder layer over a whole sequence; returns (x, k, v, ek, ev):
    the self-attention K/V after rope and the cross K/V, as the caches hold
    them."""
    b, s, _ = x.shape
    h = tfm.norm_apply(cfg, x, p["ln1"])
    q, k, v = tfm._qkv(cfg, p["attn"], h)
    q = cm.apply_rope(q, positions, cfg.rope_theta)
    k = cm.apply_rope(k, positions, cfg.rope_theta)
    out = attention(q, k, v, causal=True, block_q=cfg.attn_block_q,
                    block_k=cfg.attn_block_k)
    x = x + out.reshape(b, s, -1) @ p["attn"]["wo"]
    hx = tfm.norm_apply(cfg, x, p["ln_x"])
    ek, ev = _enc_kv(cfg, p["cross"], enc_out)
    x = x + _cross_attn(cfg, p["cross"], hx, (ek, ev), attention)
    x = x + tfm.mlp(cfg, p["mlp"], tfm.norm_apply(cfg, x, p["ln2"]))
    return x, k, v, ek, ev


def dec_layer(cfg, p, x, positions, enc_out):
    return _dec_block(cfg, p, x, positions, enc_out, cm.blocked_attention)[0]


@torch.no_grad()
def forward(cfg, params, tokens, enc_input):
    """(enc_input, decoder tokens (B,S)) -> decoder logits (B,S,V)."""
    enc_out = encode(cfg, params, enc_input)
    x = tfm.embed(cfg, params, tokens)
    positions = tfm._positions(x)
    for i in range(cfg.n_layers):
        x = dec_layer(cfg, tfm._index(params["dec_blocks"], i), x, positions,
                      enc_out)
    x = tfm.norm_apply(cfg, x, params["ln_f"])
    return tfm.unembed(cfg, params, x)


def forward_train(cfg, params, tokens, enc_input, remat: bool = True,
                  return_hidden: bool = False):
    """:func:`forward` with autograd: the JAX ``forward`` that the training
    loss differentiates.  Attention is ``cm.differentiable_blocked_attention``
    (non-causal in the encoder and the cross-attention, causal in the
    decoder's self-attention); ``remat`` recomputes every encoder and
    decoder layer in the backward (``torch.utils.checkpoint``), as
    ``jax.remat`` wraps both scans' bodies.  With ``return_hidden`` the
    hidden state after ``ln_f`` instead of the logits."""
    attention = cm.differentiable_blocked_attention
    enc_out = encode(cfg, params, enc_input, attention=attention, remat=remat)
    x = tfm.embed(cfg, params, tokens)
    positions = tfm._positions(x)

    def layer(x, p, enc_out):
        return _dec_block(cfg, p, x, positions, enc_out, attention)[0]

    for i in range(cfg.n_layers):
        p = tfm._index(params["dec_blocks"], i)
        x = (checkpoint(layer, x, p, enc_out, use_reentrant=False) if remat
             else layer(x, p, enc_out))
    x = tfm.norm_apply(cfg, x, params["ln_f"])
    return x if return_hidden else tfm.unembed(cfg, params, x)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_caches(cfg, batch: int, max_len: int, device="cuda"):
    """Self-attention caches of ``max_len`` and cross caches of the encoder
    length (``encoder_frames``, or 128 for a token encoder)."""
    dtype = tfm.torch_dtype(cfg)
    f = cfg.encoder_frames or CROSS_CACHE_DEFAULT
    return {"self": cm.init_kv_cache(cfg.n_layers, batch, max_len,
                                     cfg.n_kv_heads, cfg.hd, dtype, device),
            "cross": cm.init_kv_cache(cfg.n_layers, batch, f,
                                      cfg.n_kv_heads, cfg.hd, dtype, device)}


@torch.no_grad()
def prefill(cfg, params, tokens, enc_input, max_len: Optional[int] = None):
    """Encode the source, compute every layer's cross K/V, consume the
    prompt tokens (B,S); returns (last-token logits, caches).  The self
    caches are padded to ``max_len`` after attention; the cross caches hold
    the source's real length."""
    enc_out = encode(cfg, params, enc_input)
    x = tfm.embed(cfg, params, tokens)
    b, s, _ = x.shape
    max_len = max_len or s
    positions = tfm._positions(x)
    ks, vs, eks, evs = [], [], [], []
    for i in range(cfg.n_layers):
        x, k, v, ek, ev = _dec_block(cfg, tfm._index(params["dec_blocks"], i),
                                     x, positions, enc_out,
                                     cm.blocked_attention)
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
    return tfm.unembed(cfg, params, x[:, -1:]), caches


@torch.no_grad()
def decode_step(cfg, params, caches, token, pos):
    """token (B,1) int; pos an int or a (B,) int tensor -> (logits (B,1,V),
    caches).  The self caches are updated in place and returned; the cross
    caches are read whole."""
    x = tfm.embed(cfg, params, token)
    b = x.shape[0]
    pos = torch.as_tensor(pos, device=x.device).to(torch.int64)
    posv = pos.reshape(-1, 1).expand(b, 1)
    for i in range(cfg.n_layers):
        p = tfm._index(params["dec_blocks"], i)
        ck, cv = caches["self"]["k"][i], caches["self"]["v"][i]
        xk, xv = caches["cross"]["k"][i], caches["cross"]["v"][i]
        h = tfm.norm_apply(cfg, x, p["ln1"])
        q, k, v = tfm._qkv(cfg, p["attn"], h)
        q = cm.apply_rope(q, posv, cfg.rope_theta)
        k = cm.apply_rope(k, posv, cfg.rope_theta)
        cm.cache_update(ck, cv, k, v, pos)
        out = cm.decode_attention(q, ck, cv, length=pos + 1)
        x = x + out.reshape(b, 1, -1) @ p["attn"]["wo"]
        hx = tfm.norm_apply(cfg, x, p["ln_x"])
        qx = (hx @ p["cross"]["wq"]).reshape(b, 1, cfg.n_heads, cfg.hd)
        xo = cm.decode_attention(qx, xk, xv, length=xk.shape[1])
        x = x + xo.reshape(b, 1, -1) @ p["cross"]["wo"]
        x = x + tfm.mlp(cfg, p["mlp"], tfm.norm_apply(cfg, x, p["ln2"]))
    x = tfm.norm_apply(cfg, x, params["ln_f"])
    return tfm.unembed(cfg, params, x), caches
