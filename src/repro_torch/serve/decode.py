"""Dense serving steps: prefill and single-token greedy decode, counterpart
of ``repro/serve/decode.py``.

Every request of a batch shares one position and reserves ``max_len``
cache positions up front.  This is the uncontended reference the paged
scheduler is held against.

Over a model world (``build_model(..., model_world=)``, every family)
the steps run on each model rank of a replica: the caches hold the
rank's KV heads (an encoder-decoder's cross caches too; a recurrent
layer's state the rank's channels, an xLSTM state the rank's heads), the
logits come out of the model as the rank's vocab columns, and the steps
gather them and pick the greedy token over the ranks
(:func:`greedy_pick`, which the paged steps share).  A dp rank serves
its own rows of the batch; ``build_prefill`` passes a batch's
``frames``, ``src`` or ``patches`` through to the model.  A moe model
routes each dp rank's rows on their own: ``build_prefill`` and
``build_serve_step`` refuse ``data`` > 1 dp ranks where the reference
routes the whole batch (:func:`check_routing`).
``cache_shardings`` and ``serve_param_shardings`` are the reference's
placement tables, as tuples of axis names; the port computes with the
model entry on the KV-head dim where the KV heads divide over the model
ranks (the head-local attention reads only its own heads), and on the
head dim of an xLSTM state, where the reference's code puts it on the
last dim.
"""

from __future__ import annotations

import torch

from repro_torch.models import common as cm


def _dp(axis_names):
    dp = tuple(a for a in axis_names if a in ("pod", "data"))
    return dp if len(dp) > 1 else dp[0]


def cache_shardings(mesh_shape: dict, cache_shapes, batch: int,
                    model_axis: str = "model"):
    """Spec tree for cache trees (family-agnostic heuristics).

    ``mesh_shape`` maps the axis names to their sizes in mesh order (the
    reference's ``dict(mesh.shape)``).  KV caches are rank>=5 ``(..., B,
    S, KH, hd)``; recurrent states are rank 3-5 with B in position 1.  We
    shard B over dp when divisible, else the largest seq-like dim; KH goes
    on the model axis when divisible (recurrent states: their last,
    channel dim; an xLSTM state, under ``mlstm`` or ``slstm``: its heads,
    the dim after B).

    Raises ``ValueError`` when the dp extent divides *neither* the batch
    nor any other dim of a leaf — silently replicating a cache across a
    multi-device dp mesh is an OOM-in-production bug, not a fallback.
    """
    dp = _dp(tuple(mesh_shape))
    n_dp = 1
    for a in (dp if isinstance(dp, tuple) else (dp,)):
        n_dp *= mesh_shape[a]
    n_model = mesh_shape.get(model_axis, 1)

    def spec(path, shape):
        entries = [None] * len(shape)
        # Locate the batch dim.  Several dims can equal `batch` (a ring
        # window, seq, or head count sized exactly B), so collect every
        # candidate and tiebreak on the canonical position: caches in this
        # repo put B at dim 1 (after the layer-stack dim) for every rank>=3
        # leaf, and at dim 0 only for rank<=2 recurrent vectors.
        cands = [i for i, s in enumerate(shape)
                 if (s == batch and i >= 1)
                 or (i == 0 and len(shape) <= 2 and s == batch)]
        b_idx = 1 if len(cands) > 1 and 1 in cands else \
            (cands[0] if cands else None)
        if b_idx is not None and batch % n_dp == 0 and batch >= n_dp:
            entries[b_idx] = dp
        else:
            # shard the largest remaining dim over dp (seq for KV caches)
            cand = max(range(len(shape)), key=lambda i: shape[i])
            if shape[cand] % n_dp == 0 and (b_idx is None or cand != b_idx):
                entries[cand] = dp
            elif n_dp > 1:
                raise ValueError(
                    f"cache_shardings: no dim of cache leaf {shape} "
                    f"(batch={batch}) divides the dp extent {n_dp}; "
                    "refusing to silently replicate — resize the batch/"
                    "cache or serve on a smaller dp mesh")
        # model axis: KH of a KV cache, the channel of a recurrent state,
        # the heads of an xLSTM state
        i = len(shape) - (2 if len(shape) >= 5 else 1)
        if path.split("/")[0] in ("mlstm", "slstm"):
            i = 2
        if entries[i] is None and shape[i] % n_model == 0 \
                and shape[i] >= n_model and i != b_idx:
            entries[i] = model_axis
        return tuple(entries)

    return cm.map_with_path(lambda path, leaf: spec(path,
                                                    cm.shape_of(leaf)),
                             cache_shapes)


def serve_param_shardings(params_shapes):
    """The params' spec tree (``common.tree_specs``)."""
    return cm.tree_specs(params_shapes)


def greedy_pick(model, last):
    """The greedy token of each row of the last-position logits ``last``
    (N, V'), and those logits over the whole vocabulary, the
    vocab-padding columns (the table is padded to /256) masked to
    ``NEG_INF`` first.  Over a vocab-split model world ``last`` is the
    rank's columns: each rank takes the max and argmax of its masked
    columns and the ranks share the (value, global index) pairs; the
    largest value wins, the smallest index among equals (``torch.argmax``'s
    rule), so every rank picks the same token, and the logits come back
    gathered.  The dense and the paged serving steps both pick through
    this function.  Returns (tokens (N,) int64, logits (N, V))."""
    mw = model.model_world
    n = last.shape[-1]
    split = mw is not None and n < model.cfg.vocab_padded
    lo = mw.rank * n if split else 0
    cols = lo + torch.arange(n, device=last.device)
    last = torch.where(cols < model.cfg.vocab, last, cm.NEG_INF)
    idx = last.argmax(-1)
    if not split:
        return idx, last
    val = last.gather(-1, idx[:, None])[:, 0].float()
    pair = torch.stack([val, (idx + lo).float()], -1)           # (N, 2)
    pairs = cm.model_all_gather(pair, mw).view(
        -1, mw.size, 2).transpose(0, 1)                         # (M, N, 2)
    best = pairs[..., 0].max(0).values
    cand = torch.where(pairs[..., 0] == best, pairs[..., 1], float("inf"))
    return cand.min(0).values.long(), cm.model_all_gather(last, mw)


def check_routing(model, data: int) -> None:
    """Refuse to serve a moe model over ``data`` > 1 dp ranks where the
    reference routes the whole batch at once: the port's dp ranks each
    route their own rows, with a capacity from their own tokens, which is
    the reference's ``shardmap`` path (``moe_impl`` ``shardmap`` over a
    model axis that divides ``n_experts``), and not its ``slotmap`` or
    ``onehot_scatter`` path, nor its slot-map fallback (a model axis of 1
    or one that does not divide ``n_experts``), which route the whole
    batch through one capacity."""
    cfg, mw = model.cfg, model.model_world
    if cfg.family != "moe" or data <= 1:
        return
    n_model = mw.size if mw is not None else 1
    if cfg.moe_impl == "shardmap" and n_model > 1 \
            and cfg.n_experts % n_model == 0:
        return
    raise ValueError(
        f"serving {cfg.name} over {data} dp ranks routes each rank's rows "
        f"on their own (the reference's shardmap path), but with "
        f"moe_impl={cfg.moe_impl!r} over {n_model} model ranks and "
        f"{cfg.n_experts} experts the reference routes the whole batch "
        f"through one capacity; serve it on one dp rank")


def build_serve_step(model, data: int = 1):
    """``serve_step(params, caches, token (B,1), pos) -> (next_token (B,1),
    logits, caches)``; the caches are updated in place.  The token is
    :func:`greedy_pick`'s, the logits (B, 1, V) masked and, over a
    vocab-split model world, gathered.  ``data``: the dp ranks serving
    the batch, each its own rows (:func:`check_routing`)."""
    check_routing(model, data)

    def serve_step(params, caches, token, pos):
        logits, caches = model.decode_step(params, caches, token, pos)
        nxt, last = greedy_pick(model, logits[:, -1, :])
        return nxt.to(token.dtype)[:, None], last[:, None], caches

    return serve_step


def build_prefill(model, max_len: int, data: int = 1):
    """``prefill_step(params, batch) -> (last_logits, caches)`` with caches
    padded to ``max_len``; over a vocab-split model world the last logits
    are gathered.  ``data``: the dp ranks serving the batch, each its own
    rows (:func:`check_routing`)."""
    check_routing(model, data)
    mw = model.model_world

    def prefill_step(params, batch):
        logits, caches = model.prefill(params, batch, max_len)
        if mw is not None and logits.shape[-1] < model.cfg.vocab_padded:
            logits = cm.model_all_gather(logits, mw)
        return logits, caches

    return prefill_step
