"""Shared building blocks of the dense decoder: norms, RoPE, attention for
prefill (through the flash-attention kernel), for training (differentiable
torch) and for one-token decode against a cache, the KV cache helpers and
the cross-entropy loss.

Counterpart of ``repro/models/common.py``, with the model axis made
explicit.  The spec tables (``_PARAM_RULES``, ``spec_for_param``,
``tree_specs``) are the reference's, over the port's nested-dict trees,
with a spec a tuple of axis names or ``None``.  Where the reference
constrains shardings (``wsc``) and leaves GSPMD to insert the collectives,
the port holds each leaf with a ``model`` entry as this rank's slice of
that dim (:func:`model_slice`, :func:`placement`) and inserts them itself:
Megatron's *f* (:func:`copy_to_model`) and *g* (:func:`reduce_from_model`)
over the ranks of one replica (:class:`ModelWorld`), the gather of a
channel-split operand that a matmul reads whole (:func:`gather_from_model`,
the RG-LRU's gates and the mLSTM's up-projection), and the gather of a
column-split result that every rank then uses whole alike
(:func:`gather_replicated_from_model`, the MoE router's logits).  With no
model world every helper is the identity.  :func:`dims_in_order` lets a
family's init draw the whole tree's numbers and keep only a rank's
slices.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.core.tree import Spec
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
# Sharding-spec rules (model axis; dp handled by the step builder)
# ---------------------------------------------------------------------------

def shard_rules(path_leaf_shapes, model_axis: str = "model"):
    """The reference's name for the spec table, which it never built:
    raises, as the reference's does (use :func:`spec_for_param`)."""
    raise NotImplementedError("use spec_for_param per-model instead")


# base (unstacked) rank and model-axis placement per param name; spec entries
# apply to the TRAILING dims, leading stack dims get None automatically
_PARAM_RULES = {
    # name: (base_rank, spec_on_base_dims)
    "emb": (2, ("model", None)),          # vocab-sharded (logits matmul)
    "lm_head": (2, ("model", None)),
    "src_emb": (2, ("model", None)),
    "enc_pos": (2, (None, None)),
    "wq": (2, (None, "model")),
    "wk": (2, (None, "model")),
    "wv": (2, (None, "model")),
    "wo": (2, ("model", None)),
    "w1": (2, (None, "model")),
    "w3": (2, (None, "model")),
    "w2": (2, ("model", None)),
    "w_up": (2, (None, "model")),
    "w_down": (2, ("model", None)),
    "wg": (2, (None, "model")),
    "wif": (2, (None, None)),
    "w_x": (2, (None, "model")),
    "w_gate": (2, (None, "model")),
    "w_r": (2, (None, None)),             # lru gates: square (w,w); keep rep
    "w_i": (2, (None, None)),
    "w_out": (2, ("model", None)),
    "conv_w": (2, (None, "model")),
    "router": (2, (None, "model")),
    "we1": (3, ("model", None, None)),    # experts (E, d, ff): expert-parallel
    "we2": (3, ("model", None, None)),
    "we3": (3, ("model", None, None)),
    "r": (3, (None, None, None)),         # slstm per-head recurrent
}


def spec_for_param(path: str, shape: Tuple[int, ...],
                   model_axis: str = "model") -> tuple:
    """Model-axis placement by param name; leading stack dims -> None."""
    name = path.split("/")[-1]
    rule = _PARAM_RULES.get(name)
    if rule is None:
        return (None,) * len(shape)
    base_rank, spec = rule
    lead = len(shape) - base_rank
    if lead < 0:
        return (None,) * len(shape)
    return (None,) * lead + tuple(model_axis if s == "model" else None
                                  for s in spec)


def shape_of(leaf) -> Optional[Tuple[int, ...]]:
    """A leaf's shape: a tensor's or a ``Spec``'s, or a tuple of ints."""
    if hasattr(leaf, "shape"):
        return tuple(leaf.shape)
    if isinstance(leaf, tuple) and all(isinstance(d, int) for d in leaf):
        return leaf
    return None


def map_with_path(fn, tree, path=()):
    """``fn("a/b/c", leaf)`` over a tree of dicts, lists and tuples, keyed
    and ordered as ``jax.tree_util`` keys and flattens it (sorted dict keys,
    sequence indices)."""
    if shape_of(tree) is not None:
        return fn("/".join(path), tree)
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], path + (str(k),))
                for k in sorted(tree)}
    return type(tree)(map_with_path(fn, v, path + (str(i),))
                      for i, v in enumerate(tree))


def tree_specs(params_or_shapes, model_axis: str = "model"):
    """The spec tree matching a params tree (rank-aware stacking)."""
    return map_with_path(
        lambda path, leaf: spec_for_param(path, shape_of(leaf), model_axis),
        params_or_shapes)


# ---------------------------------------------------------------------------
# The model world: placement of the slices and the two collectives
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelWorld:
    """The model ranks of one replica: ``size`` ranks, this one at
    ``rank``, joined by ``group`` (a ``torch.distributed`` process group).
    ``staged``: the backend takes host tensors (gloo on a card), so each
    collective goes through host memory."""
    size: int
    rank: int
    group: object = field(default=None, compare=False, repr=False)
    staged: bool = False


def model_slice(spec, shape, n_model: int, heads: Optional[int] = None
                ) -> Optional[int]:
    """The dim a leaf of ``shape`` and ``spec`` is split on over
    ``n_model`` ranks, or ``None`` where it is held whole.  A dim with a
    ``model`` entry is split only into whole heads (``heads``, for the
    attention projections) or evenly: otherwise its use is computed
    replicated, as ``wsc`` drops the entry (4 KV heads on a 16-way model
    axis)."""
    if n_model <= 1 or "model" not in spec:
        return None
    dim = list(spec).index("model")
    n = shape[dim] if heads is None else heads
    return dim if n % n_model == 0 and n >= n_model else None


def _heads_of(cfg, name: str) -> Optional[int]:
    """The heads along the model-split dim of an attention projection."""
    return {"wq": cfg.n_heads, "wo": cfg.n_heads, "wk": cfg.n_kv_heads,
            "wv": cfg.n_kv_heads}.get(name)


def placement(cfg, tree, n_model: int):
    """The split dim of every leaf of a params tree (whole, stacked or a
    Spec tree) over ``n_model`` ranks, or ``None`` for a leaf held whole
    (:func:`model_slice` of its :func:`spec_for_param`)."""
    def dim(path, leaf):
        shape = shape_of(leaf)
        return model_slice(spec_for_param(path, shape), shape, n_model,
                           _heads_of(cfg, path.split("/")[-1]))
    return map_with_path(dim, tree)


def _zip_map(fn, tree, dims):
    """``fn(leaf, dim)`` over a tree and its placement tree."""
    if isinstance(dims, dict):
        return {k: _zip_map(fn, tree[k], d) for k, d in dims.items()}
    if isinstance(dims, (list, tuple)):
        return type(dims)(_zip_map(fn, tree[i], d)
                          for i, d in enumerate(dims))
    return fn(tree, dims)


def take_slices(tree, dims, mw: Optional[ModelWorld]):
    """This rank's slice of each split leaf (a new tensor, so that the
    whole one can go; a ``Spec`` of the slice's shape); leaves held whole
    pass through."""
    if mw is None:
        return tree

    def take(a, d):
        if d is None:
            return a
        n = a.shape[d] // mw.size
        if isinstance(a, Spec):
            return Spec(a.shape[:d] + (n,) + a.shape[d + 1:], a.dtype)
        return a.narrow(d, mw.rank * n, n).clone()
    return _zip_map(take, tree, dims)


class _Made(NamedTuple):
    """A leaf an init's tree function was asked to make: its shape."""
    shape: tuple


def dims_in_order(cfg, tree_fn, n_model: int) -> list:
    """The split dim (:func:`placement` over ``n_model`` ranks) of each
    leaf that ``tree_fn(cfg, leaf)`` makes, in the order it makes them,
    which is the order an init draws them from its generator.  A family's
    init then draws every leaf as the whole init does and keeps the
    rank's slice of it, so the rank's tree is :func:`take_slices` of the
    whole init bit for bit, and the whole tree never exists."""
    made = []

    def leaf(shape, init):
        made.append(_Made(tuple(shape)))
        return made[-1]
    tree = tree_fn(cfg, leaf)
    seq = {id(m): i for i, m in enumerate(made)}
    out = [None] * len(made)
    _zip_map(lambda m, d: out.__setitem__(seq[id(m)], d), tree,
             placement(cfg, tree, n_model))
    return out


def held_whole(tree, dims) -> list:
    """The leaves of ``tree`` that its placement ``dims`` holds whole, in
    sorted-key order."""
    if isinstance(dims, dict):
        return [a for k in sorted(dims) for a in held_whole(tree[k], dims[k])]
    if isinstance(dims, (list, tuple)):
        return [a for i, d in enumerate(dims) for a in held_whole(tree[i], d)]
    return [tree] if dims is None else []


def join_slices(trees, dims):
    """The whole tree from every model rank's slices (a list in rank
    order): split leaves concatenated on their dim, whole ones rank 0's."""
    if isinstance(dims, dict):
        return {k: join_slices([t[k] for t in trees], d)
                for k, d in dims.items()}
    if isinstance(dims, (list, tuple)):
        return type(dims)(join_slices([t[i] for t in trees], d)
                          for i, d in enumerate(dims))
    return trees[0] if dims is None else torch.cat(trees, dim=dims)


# Host seconds, bytes and count of the model-axis collectives so far, and
# the count of those of each ``kind`` (the MoE's routed combines)
_TP_STATS = {"s": 0.0, "bytes": 0, "ops": 0, "routed": 0}
_HOST: dict = {}


def tp_stats() -> dict:
    return dict(_TP_STATS)


def _host_buffer(like: torch.Tensor, numel: Optional[int] = None
                 ) -> torch.Tensor:
    """A host buffer of ``numel`` elements (``like``'s count by default) of
    ``like``'s dtype, pinned where a card is present: a view of the first
    ``numel`` elements of one buffer kept per (capacity, dtype), the
    capacity ``numel`` rounded up to a power of two.  So a dtype holds at
    most about log2 of the largest count's buffers, however many shapes
    pass through (a prefill at every prompt length)."""
    n = numel if numel is not None else like.numel()
    cap = 1 << max(n - 1, 0).bit_length()
    key = (cap, like.dtype)
    buf = _HOST.get(key)
    if buf is None:
        buf = _HOST[key] = torch.empty(
            cap, dtype=like.dtype, pin_memory=torch.cuda.is_available())
    return buf[:n]


def model_all_reduce(x: torch.Tensor, mw: ModelWorld,
                     op=dist.ReduceOp.SUM, kind: Optional[str] = None
                     ) -> torch.Tensor:
    """``x`` reduced over the model group by ``op``, in a new tensor
    (through a pinned host buffer when ``mw.staged``); counted by
    :func:`tp_stats`, also under ``kind`` where given."""
    t = time.perf_counter()
    if mw.staged:
        host = _host_buffer(x)
        host.copy_(x.detach().reshape(-1))
        dist.all_reduce(host, op=op, group=mw.group)
        out = torch.empty_like(x)
        out.copy_(host.view(x.shape))
    else:
        out = x.detach().clone()
        dist.all_reduce(out, op=op, group=mw.group)
    _TP_STATS["s"] += time.perf_counter() - t
    _TP_STATS["bytes"] += x.numel() * x.element_size()
    _TP_STATS["ops"] += 1
    if kind is not None:
        _TP_STATS[kind] += 1
    return out


def model_all_gather(x: torch.Tensor, mw: ModelWorld) -> torch.Tensor:
    """Every model rank's ``x`` (one shape on every rank) concatenated in
    rank order along the last dim, in a new tensor (through pinned host
    buffers when ``mw.staged``); counted by :func:`tp_stats` with the
    gathered tensor's bytes."""
    t = time.perf_counter()
    n, m = x.numel(), mw.size
    parts = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if mw.staged:
        src, dst = _host_buffer(x), _host_buffer(x, m * n).view(m, n)
        src.copy_(x.detach().reshape(-1))
        dist.all_gather(list(dst.unbind(0)), src, group=mw.group)
        parts.copy_(dst)
    else:
        dist.all_gather(list(parts.unbind(0)),
                        x.detach().contiguous().reshape(-1), group=mw.group)
    out = parts.view((m,) + tuple(x.shape)).movedim(0, -2).reshape(
        tuple(x.shape[:-1]) + (m * x.shape[-1],))
    _TP_STATS["s"] += time.perf_counter() - t
    _TP_STATS["bytes"] += out.numel() * out.element_size()
    _TP_STATS["ops"] += 1
    return out


def _sum_over_model(x: torch.Tensor, mw: ModelWorld,
                    kind: Optional[str] = None) -> torch.Tensor:
    """The float32 sum of every model rank's ``x``, rounded once to its
    dtype."""
    return model_all_reduce(x.float(), mw, kind=kind).to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    """Megatron's *f*: identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, mw):
        ctx.mw = mw
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_over_model(g, ctx.mw), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's *g*: all-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, mw, kind):
        return _sum_over_model(x, mw, kind)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather of the channels forward; its transpose backward: the
    float32 sum of every rank's gradient of the whole, rounded once, and
    the rank's slice of it."""

    @staticmethod
    def forward(ctx, x, mw):
        ctx.mw = mw
        return model_all_gather(x, mw)

    @staticmethod
    def backward(ctx, g):
        mw = ctx.mw
        n = g.shape[-1] // mw.size
        whole = _sum_over_model(g.contiguous(), mw)
        return whole.narrow(-1, mw.rank * n, n).contiguous(), None


class _GatherReplicatedFromModel(torch.autograd.Function):
    """All-gather of the columns forward; backward the rank's slice of the
    gradient of the whole, which every rank holds alike (no sum)."""

    @staticmethod
    def forward(ctx, x, mw):
        ctx.mw = mw
        return model_all_gather(x, mw)

    @staticmethod
    def backward(ctx, g):
        mw = ctx.mw
        n = g.shape[-1] // mw.size
        return g.narrow(-1, mw.rank * n, n).contiguous(), None


def gather_replicated_from_model(x, mw: Optional[ModelWorld]):
    """The whole last dim of a column-split result ``x`` that every rank
    then uses whole and alike, so that the gradient reaching the whole is
    the same on every rank: the MoE router's logits, whose top-k, gates
    and aux losses each rank computes over all experts (the gates under
    :func:`copy_to_model`).  Its gradient is the rank's slice of that
    gradient; :func:`gather_from_model`'s sum over the ranks would be
    ``mw.size`` times too large here."""
    return x if mw is None else _GatherReplicatedFromModel.apply(x, mw)


def gather_from_model(x, mw: Optional[ModelWorld]):
    """The whole last dim of a channel-split ``x``: every model rank's
    channels in rank order, as the reference's GSPMD gathers a
    channel-sharded operand that a matmul reads whole (the RG-LRU's gates
    read all the channels of ``u``).  Its gradient is the rank's slice of
    the sum of every rank's gradient of the whole."""
    return x if mw is None else _GatherFromModel.apply(x, mw)


def copy_to_model(x, mw: Optional[ModelWorld]):
    """The input of a model-split computation: its gradient is the sum of
    every model rank's (the reference's GSPMD all-reduce of a replicated
    operand's cotangent).  Also applied to a leaf held whole whose use on
    this rank sees only its own heads or channels (``q_norm``, ``k_norm``,
    KV projections computed whole, the RG-LRU's ``w_r``, ``w_i`` and
    ``lam``), so that its gradient is whole."""
    return x if mw is None else _CopyToModel.apply(x, mw)


def reduce_from_model(x, mw: Optional[ModelWorld],
                      kind: Optional[str] = None):
    """The sum of every model rank's partial ``x`` (float32, rounded once
    to ``x``'s dtype), as the reference's row-parallel matmul sums its
    partial products; counted under ``kind`` too where given."""
    return x if mw is None else _ReduceFromModel.apply(x, mw, kind)


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

def vocab_parallel_nll(logits, labels, mw: ModelWorld):
    """Per-position NLL of logits split by vocab: ``logits`` (..., V/M)
    float32 are this rank's columns (global ``rank*V/M`` on), ``labels``
    global ids.  The logsumexp takes the max and the sum of exp over the
    model group; the target logit comes from the rank that owns it (the
    others add zero)."""
    n = logits.shape[-1]
    lo = mw.rank * n
    m = model_all_reduce(logits.detach().amax(-1), mw, op=dist.ReduceOp.MAX)
    sumexp = reduce_from_model(torch.exp(logits - m[..., None]).sum(-1), mw)
    lse = torch.log(sumexp) + m
    local = labels.long() - lo
    inside = (local >= 0) & (local < n)
    lab = torch.gather(logits, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    lab = reduce_from_model(torch.where(inside, lab, 0.0), mw)
    return lse - lab


def softmax_cross_entropy(logits, labels, mask=None, mw=None):
    """logits (B,S,V), labels (B,S) int -> mean NLL in float32 (over the
    mask's weight when given).  With a model world the logits are this
    rank's vocab columns (:func:`vocab_parallel_nll`)."""
    logits = logits.float()
    if mw is not None:
        nll = vocab_parallel_nll(logits, labels, mw)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        lab = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        nll = lse - lab
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
