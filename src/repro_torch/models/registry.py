"""Uniform model API: build_model(cfg, device) -> ModelAPI.

Counterpart of ``repro/models/registry.py`` for the dense family, the
hybrid family (recurrentgemma), the encoder-decoder ``audio`` family
(transformer_wmt, whisper-medium), the ``vlm`` family (internvl2-2b: the
dense transformer after a patch-embedding prefix), the ``ssm`` family
(xlstm-350m) and the ``moe`` family (llama4-maverick, kimi-k2).  Batches
by family:

    dense, hybrid, ssm, moe : {tokens, labels}
    audio              : {frames (B,F,d) or src (B,F), tokens, labels}
    vlm                : {patches (B,Np,d), tokens, labels}

A vlm's ``forward`` returns logits over all Np+S positions and its loss is
taken over the text positions only; its ``decode_step`` takes the absolute
position, prefix included.  A moe model's ``forward`` returns its router
aux (``load_balance``, ``router_z``, ``dropped``) beside the logits, and
its loss adds ``router_aux_coef`` times the two router losses to the
cross-entropy, as the JAX loss does.

``build_model(cfg, device, model_world)`` gives every family the model
axis (``common.ModelWorld``, the model ranks of one replica): ``init``
returns the rank's slices by ``common.placement`` (the ssm and moe
families draw the whole init's numbers and keep only their slices; the
others cut the whole tree), the entry points compute the rank's part
(``models/transformer.py``, ``models/rglru.py``, ``models/encdec.py``,
``models/vlm.py``, ``models/xlstm.py``, ``models/moe.py``: a moe rank
holds its share of the experts), the logits are the rank's vocab columns
and the loss the vocab-parallel cross-entropy (chunked at vocab >=
65536).

``layered`` is the dense family's per-layer decomposition for the
layer-streamed FSDP engine (``core/streaming.py``): stem -> superblock
spans -> head, its ``head_loss`` the tail of ``loss``, with a model
world on the rank's slices (the vocab-parallel lookup and
cross-entropy).  Other families have none (``None``), and streamed FSDP
refuses them.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import common as cm
from repro_torch.models import encdec, moe, rglru, vlm, xlstm
from repro_torch.models import transformer as tfm


class ModelAPI(NamedTuple):
    cfg: Any
    device: Any
    init: Callable                  # Generator -> params (a rank's slices)
    forward: Callable               # (params, batch) -> (logits, aux)
    loss: Callable                  # (params, batch, remat=True) -> (loss, metrics)
    init_caches: Callable           # (batch, max_len) -> caches
    prefill: Callable               # (params, batch, max_len) -> (logits, caches)
    decode_step: Callable           # (params, caches, token, pos) -> (logits, caches)
    # per-layer apply decomposition for the layer-streamed FSDP engine
    # (DESIGN.md §11); None for families without one
    layered: Optional[cm.LayeredModel] = None
    # the model ranks of one replica (None: the whole model on this rank)
    model_world: Optional[cm.ModelWorld] = None


CHUNKED_CE_VOCAB = 65536
# the families whose init keeps only a rank's slices of each leaf it draws
SLICED_INIT_FAMILIES = ("ssm", "moe")


def _chunked_ce(cfg, params, hidden, labels, mask, mw=None):
    """The JAX package's big-vocab cross-entropy: the (B,S,V) float32
    logits never exist, forward or backward.  The sequence runs in 8 chunks
    (one fewer until the count divides S), in order from 0; each chunk's
    unembed, logsumexp, label gather and masked NLL sum recompute in the
    backward (``checkpoint``), as ``jax.remat`` wraps the JAX scan body.
    Returns the NLL sum over the mask's sum (at least 1).  With a
    vocab-split model world each chunk's logits are the rank's vocab
    columns and its NLL the vocab-parallel one."""
    b, s = labels.shape
    chunks = 8
    while s % chunks:
        chunks -= 1
    sc = s // chunks
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=hidden.device)

    def body(xc, lc, mc):
        logits = (tfm.unembed(cfg, params, xc) if mw is None
                  else tfm.unembed(cfg, params, xc, mw)).float()
        if mw is not None:
            nll = cm.vocab_parallel_nll(logits, lc, mw)
        else:
            lse = torch.logsumexp(logits, dim=-1)
            lab = torch.gather(logits, -1, lc.long()[..., None])[..., 0]
            nll = lse - lab
        return (nll * mc).sum(), mc.sum()

    tot = cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(chunks):
        cols = slice(c * sc, (c + 1) * sc)
        nll, n = checkpoint(body, hidden[:, cols], labels[:, cols],
                            mask[:, cols], use_reentrant=False)
        tot, cnt = tot + nll, cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def _loss(cfg, forward_train, chunked: bool, text_slice: int = 0,
          mw=None):
    """``ModelAPI.loss``, the JAX loss's two branches: with ``chunked`` the
    chunked cross-entropy of the training forward's hidden state, else the
    cross-entropy of its logits; either over the positions from
    ``text_slice`` on (a vlm's text).  A moe model's router losses join
    the total times ``router_aux_coef``, and its metrics carry them and
    ``moe_dropped``.  ``forward_train(params, batch, remat,
    return_hidden) -> (out, aux)``.  With a model world the cross-entropy
    is vocab-parallel where the placement splits the vocab (the padded
    columns count in the logsumexp, as in the reference's loss and at
    model 1)."""
    def loss_fn(params, batch, remat=True):
        out, aux = forward_train(params, batch, remat, chunked)
        out = out[:, text_slice:]
        vmw = mw if tfm.vocab_split(cfg, params, mw) else None
        if chunked:
            ce = _chunked_ce(cfg, params, out, batch["labels"],
                             batch.get("mask"), vmw)
        else:
            ce = cm.softmax_cross_entropy(out, batch["labels"],
                                          batch.get("mask"), vmw)
        total, metrics = ce, {"ce": ce}
        for name in ("load_balance", "router_z"):
            if name in aux:
                total = total + cfg.router_aux_coef * aux[name]
                metrics[name] = aux[name]
        if "dropped" in aux:
            metrics["moe_dropped"] = aux["dropped"]
        metrics["loss"] = total
        return total, metrics

    return loss_fn


def _dense_layered(cfg, chunked: bool, mw=None) -> cm.LayeredModel:
    """Layered decomposition of the dense family (one span a superblock),
    on a model rank's slices with a model world ``mw``.

    ``head_loss`` is the tail of :func:`_loss` for a dense model: the final
    norm, the (chunked) unembed and cross-entropy (vocab-parallel where
    the placement splits the vocab), ``{"ce", "loss"}`` as the metrics
    (dense has no aux losses)."""
    n_sb, _, _ = tfm.superblock_layout(cfg)

    def stem(stem_tree, batch):
        return tfm.stem_apply(cfg, stem_tree, batch["tokens"], mw=mw)

    def span(k, span_tree, x, positions, remat=True):
        return tfm.span_apply(cfg, span_tree, x, positions, remat=remat,
                              mw=mw)

    def head_loss(head_tree, stem_tree, x, positions, batch):
        x = tfm.norm_apply(cfg, x, head_tree["ln_f"])
        up = tfm.head_params_for_unembed(stem_tree, head_tree)
        vmw = mw if tfm.vocab_split(cfg, up, mw) else None
        if chunked:
            ce = _chunked_ce(cfg, up, x, batch["labels"], batch.get("mask"),
                             vmw)
        else:
            ce = cm.softmax_cross_entropy(tfm.unembed(cfg, up, x, mw),
                                          batch["labels"], batch.get("mask"),
                                          vmw)
        return ce, {"ce": ce, "loss": ce}

    return cm.LayeredModel(
        n_spans=n_sb,
        split=lambda params, lead=0: tfm.split_layered(cfg, params, lead),
        merge=lambda layered, lead=0: tfm.merge_layered(cfg, layered, lead),
        stem=stem, span=span, head_loss=head_loss)


def _enc_input(batch):
    """The encoder's input of an ``audio`` batch: whisper's frames, or
    transformer_wmt's source tokens."""
    return batch.get("frames", batch.get("src"))


# families whose forward and forward_train return (out, aux); the others'
# return out, and their aux is empty
AUX_FAMILIES = ("moe",)


def _no_aux(fn):
    """``fn``'s result and an empty aux dict."""
    return lambda *args: (fn(*args), {})


def build_model(cfg, device="cuda", model_world=None) -> ModelAPI:
    """The dense, moe, hybrid, ssm, audio or vlm family's API; entry points
    run on ``device`` (CUDA unless the caller asks for the CPU).  With a
    ``model_world`` of more than one rank ``init`` returns this rank's
    slices (``common.take_slices`` of the whole init, bit for bit) and the
    entry points take and compute them."""
    mw = model_world if model_world is not None and model_world.size > 1 \
        else None
    if mw is not None and cfg.family == "ssm":
        xlstm.heads_held(cfg, mw)          # raises where a head would split
    # the model world, for the entry points of the families that take it
    tp = {} if mw is None else {"mw": mw}
    text_slice = 0
    if cfg.family in ("dense", "moe", "hybrid", "ssm"):
        mod = {"dense": tfm, "moe": moe, "hybrid": rglru,
               "ssm": xlstm}[cfg.family]
        forward = lambda params, batch: mod.forward(cfg, params,
                                                    batch["tokens"], **tp)
        forward_train = lambda params, batch, remat, hidden: \
            mod.forward_train(cfg, params, batch["tokens"], remat=remat,
                              return_hidden=hidden, **tp)
        prefill = lambda params, batch, max_len: mod.prefill(
            cfg, params, batch["tokens"], max_len=max_len, **tp)
        # the big-vocab loss of the JAX package's chunked families
        chunked = (cfg.family != "ssm"
                   and cfg.vocab_padded >= CHUNKED_CE_VOCAB)
    elif cfg.family == "vlm":
        mod = vlm
        forward = lambda params, batch: vlm.forward(
            cfg, params, batch["tokens"], batch["patches"], **tp)[0]
        forward_train = lambda params, batch, remat, hidden: \
            vlm.forward_train(cfg, params, batch["tokens"], batch["patches"],
                              remat=remat, return_hidden=hidden, **tp)
        prefill = lambda params, batch, max_len: vlm.prefill(
            cfg, params, batch["tokens"], max_len=max_len,
            prefix_embeds=batch["patches"], **tp)
        chunked = cfg.vocab_padded >= CHUNKED_CE_VOCAB
        text_slice = cfg.n_patches
    elif cfg.family == "audio":
        mod = encdec
        forward = lambda params, batch: encdec.forward(
            cfg, params, batch["tokens"], _enc_input(batch), **tp)
        forward_train = lambda params, batch, remat, hidden: \
            encdec.forward_train(cfg, params, batch["tokens"],
                                 _enc_input(batch), remat=remat,
                                 return_hidden=hidden, **tp)
        prefill = lambda params, batch, max_len: encdec.prefill(
            cfg, params, batch["tokens"], _enc_input(batch),
            max_len=max_len, **tp)
        chunked = False
    else:
        raise ValueError(f"unknown family {cfg.family!r}")
    if cfg.family not in AUX_FAMILIES:
        forward, forward_train = _no_aux(forward), _no_aux(forward_train)

    def init(generator):
        if cfg.family in SLICED_INIT_FAMILIES:
            return mod.init_params(cfg, generator, device, **tp)
        params = mod.init_params(cfg, generator, device)
        if mw is None:
            return params
        return cm.take_slices(params, cm.placement(cfg, params, mw.size), mw)

    return ModelAPI(
        cfg=cfg,
        device=device,
        init=init,
        forward=forward,
        loss=_loss(cfg, forward_train, chunked, text_slice, mw),
        init_caches=lambda batch, max_len: mod.init_caches(
            cfg, batch, max_len, device, **tp),
        prefill=prefill,
        decode_step=lambda params, caches, token, pos: mod.decode_step(
            cfg, params, caches, token, pos, **tp),
        layered=(_dense_layered(cfg, chunked, mw)
                 if cfg.family == "dense" else None),
        model_world=mw,
    )

