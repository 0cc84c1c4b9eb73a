"""Mixture-of-Experts decoder (llama4-maverick 128e top-1, kimi-k2 384e
top-8), counterpart of ``repro/models/moe.py``.

Token dispatch is capacity-based (Switch-style) and chunked: the tokens
run in ``cfg.moe_chunks`` sequential chunks (fewer until the count divides
T) with a per-expert slot counter carried across them, so slots go first
come, first served in flat (token, choice) order and an assignment past
the capacity C is dropped.  Each chunk runs the expert products over all
E x C slots: ``torch.bmm`` of the (E, C, d) buffer with the (E, d, ff)
expert weights, as the JAX package's ``einsum("ecd,edf->ecf")`` (outside
any Pallas kernel there too).

Layer layout:
  llama4: moe_every=2  -> superblock = (dense layer, moe layer)
  kimi:   first_dense=1 -> 1 dense layer (``first``), then moe layers
Both add a shared expert (always on) to the routed output.  The attention
half of every layer is the dense family's (``transformer.attn_residual``,
whose prefill attention is K3 on CUDA tensors).

Parameters are a dict with the JAX package's tree and layouts:
``blocks/dense`` and ``blocks/moe`` stacked over superblocks, ``first``
stacked over the leading dense layers, ``emb``, ``ln_f`` and, untied,
``lm_head``.  A moe layer holds ``moe/router`` (d, E) float32 whatever
``cfg.dtype`` is, ``moe/we1``/``we3`` (E, d, ff), ``moe/we2`` (E, ff, d)
and ``moe/shared/{w1,w3,w2}``.

Entry points: ``init_params``, ``forward`` (scoring, no autograd; returns
``(logits, aux)``), ``forward_train`` (autograd; what the loss runs),
``init_caches``, ``prefill``, ``decode_step`` (caches written in place).
``aux`` holds ``load_balance``, ``router_z`` and ``dropped`` (the share of
assignments past capacity), each averaged over the moe layers.

**The model axis.**  Every entry point takes ``mw``, the model world of
one replica (``common.ModelWorld``), or ``None``.  Where the placement
splits the experts over the model ranks (``mw.size`` divides
``n_experts``) ``moe_ffn`` is expert-parallel, the reference's
``moe_ffn_shardmap``: each rank holds ``E / mw.size`` experts and the
router's columns of them, routes every token replicated over all E
experts (the logits gathered), and computes and combines only its own
experts' slots, whose float32 combine a chunk ends in one all-reduce of
(Tc, d).  The shared expert is column/row parallel, the attention half
and the dense layers the dense family's over the rank's heads, the
embedding and ``lm_head`` split by vocab.  A rank routes the rows it is
given: over several data ranks each routes its own, with a capacity from
its own tokens, as the reference's ``shardmap`` path routes each data
shard (``serve.decode`` refuses the configurations where the reference
routes the whole batch).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.tree import Spec
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm

ROUTER = "router"     # init of the router: float32, N(0, 0.02^2)
ROUTER_STD = 0.02
DECODE_CAPACITY = 8   # a decode step's capacity is max(B, this)
IMPLS = ("shardmap", "slotmap", "onehot_scatter")
_dropped_log: Optional[list] = None   # set by ``recording_dropped``


def layout(cfg):
    """(superblocks, layers per superblock): (dense, moe) pairs when
    ``moe_every`` is 2, else one moe layer each, after ``first_dense``."""
    per = 2 if cfg.moe_every == 2 else 1
    return (cfg.n_layers - cfg.first_dense) // per, per


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def _moe_ffn_tree(cfg, lead, leaf):
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": leaf(lead + (d, E), ROUTER),
         "we1": leaf(lead + (E, d, ff), 1.0 / math.sqrt(d)),
         "we3": leaf(lead + (E, d, ff), 1.0 / math.sqrt(d)),
         "we2": leaf(lead + (E, ff, d), 1.0 / math.sqrt(ff))}
    if cfg.shared_expert:
        p["shared"] = {"w1": leaf(lead + (d, ff), 1.0 / math.sqrt(d)),
                       "w3": leaf(lead + (d, ff), 1.0 / math.sqrt(d)),
                       "w2": leaf(lead + (ff, d), 1.0 / math.sqrt(ff))}
    return p


def _moe_layer_tree(cfg, lead, leaf):
    """Attention block + MoE FFN: the dense layer's tree without ``mlp``."""
    p = tfm.layer_tree(cfg, lead, leaf)
    del p["mlp"]
    p["moe"] = _moe_ffn_tree(cfg, lead, leaf)
    return p


def _param_tree(cfg, leaf):
    """The param tree with each leaf made by ``leaf(shape, init)``: init is
    the std of a normal init, None for a zero leaf, or ``ROUTER``."""
    n_sb, per = layout(cfg)
    d = cfg.d_model
    blocks = {"moe": _moe_layer_tree(cfg, (n_sb,), leaf)}
    if per == 2:
        blocks["dense"] = tfm.layer_tree(cfg, (n_sb,), leaf)
    params = {"emb": leaf((cfg.vocab_padded, d), 0.02), "blocks": blocks,
              "ln_f": {"scale": leaf((d,), None)}}
    if cfg.first_dense:
        params["first"] = tfm.layer_tree(cfg, (cfg.first_dense,), leaf)
    if not cfg.tie_embeddings:
        params["lm_head"] = leaf((cfg.vocab_padded, d), 0.02)
    return params


def param_shapes(cfg):
    """The param tree with each leaf's shape tuple in place of a tensor."""
    return _param_tree(cfg, lambda shape, init: tuple(shape))


def param_specs(cfg):
    """The param tree with each leaf's shape and dtype (``router``
    float32)."""
    dtype = tfm.torch_dtype(cfg)
    return _param_tree(cfg, lambda shape, init: Spec(
        tuple(shape), torch.float32 if init == ROUTER else dtype))


def init_params(cfg, generator: torch.Generator, device="cuda", mw=None):
    """Random weights with the JAX init's distributions: N(0, 1/d_in) dense
    and expert kernels, N(0, 0.02^2) embeddings and router (float32), zero
    norm scales.  Numbers are drawn on the generator's device one matrix at
    a time (each expert of a stacked leaf on its own), in float32, and cast
    into the leaf: at published width one expert leaf is 11-21 GB in
    float32, so a whole-leaf draw would not fit beside the others.  With a
    model world every matrix is drawn as without one, and a rank keeps only
    its slice of each leaf (``common.dims_in_order``): of an expert leaf
    only its experts' matrices, so it never holds another rank's."""
    dtype = tfm.torch_dtype(cfg)
    dims = iter(cm.dims_in_order(cfg, _param_tree, mw.size)
                if mw is not None else ())

    def leaf(shape, init):
        dim = next(dims, None)
        n = shape[dim] // mw.size if dim is not None else 0
        lo = mw.rank * n if dim is not None else 0
        kept = tuple(n if i == dim else w for i, w in enumerate(shape))
        if init is None:
            return torch.zeros(kept, dtype=dtype, device=device)
        std = ROUTER_STD if init == ROUTER else init
        out = torch.empty(kept, dtype=torch.float32 if init == ROUTER
                          else dtype, device=device)
        lead = len(shape) - 2
        for idx in np.ndindex(*shape[:-2]):
            x = torch.randn(shape[-2:], generator=generator,
                            dtype=torch.float32, device=generator.device)
            if dim is not None and dim < lead:
                if not lo <= idx[dim] < lo + n:
                    continue                 # another rank's matrix
                idx = idx[:dim] + (idx[dim] - lo,) + idx[dim + 1:]
            elif dim is not None:
                x = x.narrow(dim - lead, lo, n)
            out[idx] = (x * std).to(device=device, dtype=out.dtype)
        return out

    return _param_tree(cfg, leaf)


# ---------------------------------------------------------------------------
# Routing + dispatch
# ---------------------------------------------------------------------------

def router_topk(cfg, logits):
    """logits (T,E) fp32 -> (idx (T,k), gate (T,k) fp32, aux losses dict).

    The k largest probabilities come from a stable descending sort, so
    that among equal values the lower expert index comes first, as
    ``jax.lax.top_k`` orders them (``torch.topk`` does not promise an
    order); a row of equal logits picks experts 0..k-1."""
    E, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :k], idx[:, :k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance loss + router z-loss
    ones = torch.ones(idx.numel(), dtype=torch.float32, device=logits.device)
    f = torch.zeros(E, dtype=torch.float32, device=logits.device).index_add(
        0, idx.reshape(-1), ones) / (logits.shape[0] * k)
    aux = {"load_balance": E * torch.sum(f * probs.mean(0)),
           "router_z": torch.mean(torch.square(torch.logsumexp(logits, -1)))}
    return idx, gate.float(), aux


def _chunking(cfg, T: int, capacity: Optional[int]):
    """(n_chunks, capacity): ``moe_chunks`` chunks, one fewer until the
    count divides T (one chunk below ``moe_chunks`` tokens), and the
    capacity ``max(int(T k / E * capacity_factor), 8)`` unless given."""
    n_chunks = min(cfg.moe_chunks, T) if T >= cfg.moe_chunks else 1
    while T % n_chunks:
        n_chunks -= 1
    if capacity is None:
        capacity = max(int(T * cfg.top_k / cfg.n_experts
                           * cfg.capacity_factor), 8)
    return n_chunks, capacity


def _slot_positions(cfg, ei, counts):
    """First come, first served in flat (token, choice) order: the slot
    each assignment of a chunk's ``ei`` (Tc,k) takes in its expert, after
    the ``counts`` (E,) of the chunks before; returns (pos (Tc,k), the
    chunk's count per expert)."""
    experts = torch.arange(cfg.n_experts, device=ei.device)
    oh = (ei.reshape(-1, 1) == experts).long()              # (Tc*k, E)
    within = torch.cumsum(oh, dim=0) - oh
    pos = (within * oh).sum(-1).reshape(ei.shape) + counts[ei]
    return pos, oh.sum(0)


def _experts(cfg, p, buf):
    """The routed experts on their slots: buf (E,C,d) -> (E,C,d)."""
    act = cm.act_fn(cfg.act)
    hbuf = act(torch.bmm(buf, p["we1"])) * torch.bmm(buf, p["we3"])
    return torch.bmm(hbuf, p["we2"])


def shared_split(cfg, p, mw) -> bool:
    """Whether the rank holds a slice of the shared expert's ``d_ff``."""
    return (mw is not None and cfg.shared_expert
            and p["shared"]["w1"].shape[-1] < cfg.d_ff)


def _shared(cfg, p, x, out, mw=None):
    """``out`` plus the shared expert of x (T,d), where the config has
    one; out (B,S,d).  With ``mw`` (where the rank holds a slice of its
    ``d_ff``) the rank's w1/w3 columns and w2 rows, summed over the ranks;
    the caller puts ``x`` under ``copy_to_model``."""
    if not cfg.shared_expert:
        return out
    sp = p["shared"]
    act = cm.act_fn(cfg.act)
    return out + cm.reduce_from_model(
        (act(x @ sp["w1"]) * (x @ sp["w3"])) @ sp["w2"], mw).reshape(
        out.shape)


def experts_split(cfg, p, mw) -> bool:
    """Whether the rank holds a slice of the experts (the placement splits
    them where ``mw.size`` divides ``n_experts``): then the slot map is
    expert-parallel."""
    return mw is not None and p["we1"].shape[-3] < cfg.n_experts


def expert_offset(cfg, mw) -> int:
    """The first of the rank's experts: its first row of the slot map."""
    return mw.rank * (cfg.n_experts // mw.size)


def moe_ffn_slotmap(cfg, p, h, capacity: Optional[int] = None, mw=None):
    """Slot-map dispatch and combine: per chunk a (E, C) map of the token
    feeding each slot (0 where empty) and its gate (0 where empty); the
    buffer gathers ``x[slot_tok]`` (empty slots zeroed), the experts run
    on every slot, and the combine adds ``obuf * gate`` into the tokens in
    float32 (``index_add``; an empty slot adds an exact 0 to token 0).
    No step waits for the device: a dropped
    assignment is written to a spare slot C that is cut off, where JAX
    writes it out of bounds under ``mode="drop"``.

    Where the rank holds a slice of the experts (:func:`experts_split`)
    this is the reference's ``moe_ffn_shardmap`` over the model ranks:
    the rank holds experts ``[expert_offset, + E/M)``, their router
    columns and weights; its logits (T, E/M) are gathered to (T, E) and
    every rank routes all T tokens over all E experts alike (top-k, the
    slot bookkeeping, ``dropped``, the aux losses; capacity from the
    rank's own T); each chunk it runs its experts on its rows of the slot
    map, an (E/M, C, d) buffer, and the ranks' float32 (Tc, d) combines
    are summed by one all-reduce (``tp_stats`` counts it as ``routed``).
    The gradient: the input goes through one ``copy_to_model`` (router,
    dispatch and, where split, the shared expert all read the rank's
    part), the gates through another (a rank's combine reaches only its
    experts' gates), and the gathered logits give each rank its slice of
    the whole gradient (``gather_replicated_from_model``).  Otherwise the
    routed part runs whole on each rank; the shared expert runs over its
    ``d_ff`` split in either case."""
    b, s, d = h.shape
    T, E, k = b * s, cfg.n_experts, cfg.top_k
    ep = mw if experts_split(cfg, p, mw) else None
    lo, n_loc = (expert_offset(cfg, ep), E // ep.size) if ep else (0, E)
    x = h.reshape(T, d)
    xf = cm.copy_to_model(x, ep)
    n_chunks, capacity = _chunking(cfg, T, capacity)
    Tc = T // n_chunks

    logits = cm.gather_replicated_from_model(xf.float() @ p["router"], ep)
    idx, gate, aux = router_topk(cfg, logits)
    gate = cm.copy_to_model(gate, ep)
    counts = torch.zeros(E, dtype=torch.int64, device=h.device)
    flat_tok = torch.arange(Tc * k, device=h.device) // k
    mine = (slice(lo, lo + n_loc), slice(0, capacity))
    ys, drops = [], []
    for c in range(n_chunks):
        rows = slice(c * Tc, (c + 1) * Tc)
        xi, ei, gi = xf[rows], idx[rows], gate[rows]
        pos, n_new = _slot_positions(cfg, ei, counts)
        keep = (pos < capacity).reshape(-1)
        slot = (ei.reshape(-1), torch.where(keep, pos.reshape(-1), capacity))
        slot_tok = torch.zeros((E, capacity + 1), dtype=torch.int64,
                               device=h.device).index_put(
                                   slot, flat_tok)[mine]
        slot_val = torch.zeros((E, capacity + 1), dtype=torch.float32,
                               device=h.device).index_put(
                                   slot, gi.reshape(-1))[mine]
        obuf = _experts(cfg, p, xi[slot_tok]
                        * (slot_val > 0)[..., None].to(xi.dtype))
        # bf16 x fp32 promotes to fp32: obuf.float() * gate, without the
        # (E, C, d) fp32 copy of obuf
        contrib = obuf * slot_val[..., None]
        del obuf
        y = torch.zeros((Tc, d), dtype=torch.float32,
                        device=h.device).index_add(0, slot_tok.reshape(-1),
                                                   contrib.reshape(-1, d))
        del contrib
        ys.append(cm.reduce_from_model(y, ep, kind="routed"))
        counts = counts + n_new
        drops.append(1.0 - keep.float().mean())
    out = torch.cat(ys).reshape(b, s, d).to(h.dtype)
    smw = mw if shared_split(cfg, p, mw) else None
    xs = x if smw is None else xf if ep else cm.copy_to_model(x, smw)
    return _shared(cfg, p, xs, out, smw), dict(
        aux, dropped=torch.stack(drops).mean())


def moe_ffn(cfg, p, h, capacity: Optional[int] = None, mw=None):
    """h (B,S,d) -> (out (B,S,d), aux) through the slot map, expert-parallel
    where the rank holds a slice of the experts (the reference's
    ``shardmap`` path).  Every ``cfg.moe_impl`` name (``shardmap``,
    ``slotmap``, ``onehot_scatter``) runs it: over a replica's own tokens
    the JAX package's three paths compute the same function, with the
    same first-come-first-served capacity and the same drops
    (``shardmap`` falls back to the slot map without a ``model`` mesh
    axis; ``onehot_scatter`` is the GSPMD baseline).  Inside
    :func:`recording_dropped` each call's ``dropped`` share is
    recorded."""
    if cfg.moe_impl not in IMPLS:
        raise ValueError(f"unknown moe_impl {cfg.moe_impl!r}; options: "
                         f"{' | '.join(IMPLS)}")
    out, aux = moe_ffn_slotmap(cfg, p, h, capacity, mw)
    if _dropped_log is not None:
        _dropped_log.append(aux["dropped"])
    return out, aux


@contextlib.contextmanager
def recording_dropped():
    """Yield a list that collects the ``dropped`` share (a 0-dim tensor,
    so no step waits for the device) of every ``moe_ffn`` call made
    inside the block, in call order: a serving run's moe layers of the
    prefill, then of each decode step."""
    global _dropped_log
    outer, _dropped_log = _dropped_log, []
    try:
        yield _dropped_log
    finally:
        _dropped_log = outer


# ---------------------------------------------------------------------------
# Layers / forward
# ---------------------------------------------------------------------------

def _moe_layer(cfg, p, x, positions, attention=cm.blocked_attention,
               mw=None):
    """Attention, then the MoE FFN; returns (x, aux, k, v)."""
    x, k, v = tfm.attn_residual(cfg, p, x, positions, cfg.sliding_window,
                                True, attention, mw)
    y, aux = moe_ffn(cfg, p["moe"], tfm.norm_apply(cfg, x, p["ln2"]),
                     mw=mw)
    return x + y, aux, k, v


def _mean_aux(auxs):
    return {name: torch.stack([a[name] for a in auxs]).mean()
            for name in auxs[0]}


def _run(cfg, params, tokens, attention, remat: bool, mw=None):
    """The hidden state after ``ln_f`` and the aux averaged over the moe
    layers; each layer under ``checkpoint`` with ``remat``, as
    ``jax.remat`` wraps the JAX package's dense and moe bodies."""
    x = tfm.embed(cfg, params, tokens, mw)
    positions = tfm._positions(x)
    n_sb, per = layout(cfg)

    def dense(p, x):
        return tfm._attn_block(cfg, p, x, positions, cfg.sliding_window,
                               True, attention, mw)[0]

    def moe(p, x):
        return _moe_layer(cfg, p, x, positions, attention, mw)[:2]

    def run(fn, p, x):
        return (checkpoint(fn, p, x, use_reentrant=False) if remat
                else fn(p, x))

    for i in range(cfg.first_dense):
        x = run(dense, tfm._index(params["first"], i), x)
    auxs = []
    for i in range(n_sb):
        bp = tfm._index(params["blocks"], i)
        if per == 2:
            x = run(dense, bp["dense"], x)
        x, aux = run(moe, bp["moe"], x)
        auxs.append(aux)
    return tfm.norm_apply(cfg, x, params["ln_f"]), _mean_aux(auxs)


@torch.no_grad()
def forward(cfg, params, tokens, mw=None):
    """tokens (B,S) -> (logits (B,S,V), aux); prefill attention through
    ``cm.blocked_attention`` (K3 on CUDA tensors).  With a vocab-split
    model world the logits are the rank's vocab columns."""
    x, aux = _run(cfg, params, tokens, cm.blocked_attention, remat=False,
                  mw=mw)
    return tfm.unembed(cfg, params, x, mw), aux


def forward_train(cfg, params, tokens, remat: bool = True,
                  return_hidden: bool = False, mw=None):
    """tokens (B,S) -> (logits (B,S,V), aux) with autograd: the JAX
    ``forward``.  With ``return_hidden`` the hidden state after ``ln_f``
    in place of the logits (the chunked cross-entropy's input).
    Attention is ``cm.differentiable_blocked_attention`` (no kernel, as in
    the JAX training loss); ``remat`` recomputes each layer in the
    backward."""
    x, aux = _run(cfg, params, tokens, cm.differentiable_blocked_attention,
                  remat, mw)
    return (x if return_hidden else tfm.unembed(cfg, params, x, mw)), aux


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def _cache_len(cfg, max_len: int) -> int:
    return min(cfg.sliding_window, max_len) if cfg.sliding_window \
        else max_len


def init_caches(cfg, batch: int, max_len: int, device="cuda", mw=None):
    """``first``: (first_dense, B, S, KH, hd) K/V; ``blocks``: (n_sb, per,
    B, S, KH, hd), S the window's ring under a sliding window; KH the KV
    heads the rank holds (``transformer.kv_heads_held``)."""
    dtype = tfm.torch_dtype(cfg)
    w = _cache_len(cfg, max_len)
    n_sb, per = layout(cfg)
    kh = tfm.kv_heads_held(cfg, mw)
    caches = {}
    if cfg.first_dense:
        caches["first"] = cm.init_kv_cache(cfg.first_dense, batch, w, kh,
                                           cfg.hd, dtype, device)
    c = cm.init_kv_cache(n_sb * per, batch, w, kh, cfg.hd, dtype, device)
    caches["blocks"] = {n: a.reshape((n_sb, per) + a.shape[1:])
                        for n, a in c.items()}
    return caches


@torch.no_grad()
def prefill(cfg, params, tokens, max_len: Optional[int] = None, mw=None):
    """Fill the caches for tokens (B,S); returns (last-token logits,
    caches): each layer's K/V after rope, padded to ``max_len`` (or the
    trailing window in ring order); the rank's KV heads and vocab columns
    with a model world."""
    x = tfm.embed(cfg, params, tokens, mw)
    max_len = max_len or x.shape[1]
    positions = tfm._positions(x)
    n_sb, per = layout(cfg)

    def entry(a):
        if cfg.sliding_window:
            return tfm.window_ring(a, cfg.sliding_window, max_len)
        return tfm.pad_cache(a, max_len)

    def dense(p, x):
        x, k, v = tfm._attn_block(cfg, p, x, positions, cfg.sliding_window,
                                  True, mw=mw)
        return x, entry(k), entry(v)

    caches = {}
    if cfg.first_dense:
        ks, vs = [], []
        for i in range(cfg.first_dense):
            x, k, v = dense(tfm._index(params["first"], i), x)
            ks.append(k)
            vs.append(v)
        caches["first"] = {"k": torch.stack(ks), "v": torch.stack(vs)}
    bk, bv = [], []
    for i in range(n_sb):
        bp = tfm._index(params["blocks"], i)
        ks, vs = [], []
        if per == 2:
            x, k, v = dense(bp["dense"], x)
            ks.append(k)
            vs.append(v)
        x, _, k, v = _moe_layer(cfg, bp["moe"], x, positions, mw=mw)
        ks.append(entry(k))
        vs.append(entry(v))
        bk.append(torch.stack(ks))
        bv.append(torch.stack(vs))
    caches["blocks"] = {"k": torch.stack(bk), "v": torch.stack(bv)}
    x = tfm.norm_apply(cfg, x, params["ln_f"])
    return tfm.unembed(cfg, params, x[:, -1:], mw), caches


def _decode_moe(cfg, p, x, ck, cv, pos, mw=None):
    """One moe decode layer; capacity max(B, 8)."""
    x = tfm.decode_attn_residual(cfg, p, x, ck, cv, pos, cfg.sliding_window,
                                 mw)
    y, _ = moe_ffn(cfg, p["moe"], tfm.norm_apply(cfg, x, p["ln2"]),
                   capacity=max(x.shape[0], DECODE_CAPACITY), mw=mw)
    return x + y


@torch.no_grad()
def decode_step(cfg, params, caches, token, pos, mw=None):
    """token (B,1) int; pos an int or a (B,) int tensor -> (logits (B,1,V),
    caches).  The caches are updated in place and returned."""
    x = tfm.embed(cfg, params, token, mw)
    pos = torch.as_tensor(pos, device=x.device).to(torch.int64)
    n_sb, per = layout(cfg)
    for i in range(cfg.first_dense):
        x = tfm._decode_layer(cfg, tfm._index(params["first"], i), x,
                              caches["first"]["k"][i],
                              caches["first"]["v"][i], pos,
                              cfg.sliding_window, mw)
    ck, cv = caches["blocks"]["k"], caches["blocks"]["v"]
    for i in range(n_sb):
        bp = tfm._index(params["blocks"], i)
        if per == 2:
            x = tfm._decode_layer(cfg, bp["dense"], x, ck[i, 0], cv[i, 0],
                                  pos, cfg.sliding_window, mw)
        x = _decode_moe(cfg, bp["moe"], x, ck[i, per - 1], cv[i, per - 1],
                        pos, mw)
    x = tfm.norm_apply(cfg, x, params["ln_f"])
    return tfm.unembed(cfg, params, x, mw), caches
