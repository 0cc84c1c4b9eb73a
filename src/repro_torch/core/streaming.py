"""Layer-streamed FSDP execution engine (DESIGN.md §11).

Counterpart of ``repro/core/streaming.py``.  The gather-all FSDP step
(``core/replica.py``) unpacks the pod's whole tree before the forward and
packs one member's whole gradient tree after the backward.  The streamed
step walks the model **one layer span at a time**:

* the shard layout is **layer-aware** (``bucketing.build_layout(groups=)``)
  over the model's *layered* param tree ``{"stem", "layers", "head"}``
  (``models/common.LayeredModel``): every bucket belongs to exactly one
  ordered group (stem = 0, span k = k+1, head = n+1), so one span's
  parameters are a contiguous run of whole buckets;
* **forward**: each span runs on its own buckets with no autograd graph,
  and only its input carry is kept (detached);
* **backward**: the head's VJP runs first, then each span is re-run under
  autograd in reverse (span-level rematerialisation) and differentiated
  against the incoming carry cotangent; each group's gradients are packed
  into the pod's float32 buffers (``plan.stream_grad_shards``) as soon as
  its VJP completes, and are freed with the span.  The stem's VJP comes
  last.

``stream_schedule`` is the declarative event order the engine walks;
``validate_stream_schedule`` pins its invariants (gather before compute,
span k+1's gather before span k's compute, at most two span gathers live)
and ``max_in_flight_gathered_bytes`` walks its liveness to bound the peak
gathered memory.

**The one-device realisation.**  The JAX engine runs inside ``shard_map``
on every device of a pod at once: each device gathers a group's buckets,
runs its own member's batch, and a ``psum_scatter`` sums the members'
gradients.  Here the pod's members are walked in rank order at every
event: a gather is a view of the pod's row (``plan.stream_unshard``),
every member runs each forward span, and a group's VJP yields one member's
gradients at a time into ``plan.stream_grad_shards``, which packs the
first in float32, adds the next ones in rank order and scales the sum by
``1/pod_size``: per element the gather-all path's arithmetic, so the
streamed gradients equal it bit for bit.  The per-span VJPs are the ops
``model.loss`` runs on the gathered tree, composed across the saved
carries.

**Over a rank world** each rank is one member of its pod holding its
column slice of the grouped buckets, and the engine walks its own batch
alone: a GATHER posts the group's tiled all-gathers over the pod's ranks
(``plan.stream_unshard`` returns their receipt) and the group's COMPUTE
or VJP resolves it right before it reads the tree (:func:`take_gathered`),
so span k+1's buckets are on the wire while span k computes; a SCATTER
posts the group's reduce-scatters (``plan.stream_grad_shards``, this
member's gradients packed in float32) as soon as its VJP ends, and they
land, scaled by ``1/pod_size``, at the latest before the engine returns
(the step's guard reads them), with at most two groups' in flight.  The
same code on one card resolves views.  The engine's event log
(``plan.stream_log``) is held to :func:`stream_schedule` by
:func:`check_stream_event_log`.
"""

from __future__ import annotations

import time
from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.core import overlap as pipeline
from repro_torch.core import tree as tr

# Ordered stream groups of a layered tree: stem, spans 1..n, head.
STEM_GROUP = 0


def span_group(k: int) -> int:
    return k + 1


def head_group(n_spans: int) -> int:
    return n_spans + 1


def is_layered_tree(tree) -> bool:
    """Structural check for the ``{"stem", "layers", "head"}`` convention."""
    return (isinstance(tree, dict) and set(tree) == {"stem", "layers", "head"}
            and isinstance(tree["layers"], (tuple, list)))


def layered_leaf_groups(tree) -> Tuple[int, ...]:
    """Per-leaf ordered layer ids of a layered tree, in canonical (JAX)
    leaf order: ``head``, then the spans, then ``stem`` (sorted keys).

    This is the ``groups`` input of :func:`bucketing.build_layout`: stem
    leaves map to 0, span-k leaves to k+1, head leaves to n_spans+1.
    """
    if not is_layered_tree(tree):
        raise ValueError(
            "streamed sharding needs the layered param tree "
            '{"stem", "layers", "head"} (models/common.LayeredModel.split); '
            f"got a {type(tree).__name__} with "
            f"{sorted(tree) if isinstance(tree, dict) else '?'}")
    n_spans = len(tree["layers"])
    n_of = lambda t: len(tr.tree_leaves(t))
    by_key = {"stem": (STEM_GROUP,) * n_of(tree["stem"]),
              "head": (head_group(n_spans),) * n_of(tree["head"]),
              "layers": tuple(span_group(k) for k, span in
                              enumerate(tree["layers"])
                              for _ in range(n_of(span)))}
    return tuple(g for key in sorted(tree) for g in by_key[key])


# ---------------------------------------------------------------------------
# The joint compute/comm schedule
# ---------------------------------------------------------------------------

GATHER = "gather"        # issue a group's per-bucket all-gathers
COMPUTE = "compute"      # forward-apply a group (stem or a span)
GRAD = "grad"            # run a group's VJP (head's includes the loss)
SCATTER = "scatter"      # reduce-scatter a group's pod-mean fp32 grads

Event = Tuple[str, int]


@lru_cache(maxsize=None)
def stream_schedule(n_spans: int) -> Tuple[Event, ...]:
    """Event order of one streamed fwd+bwd over groups 0..n_spans+1.

    Forward: gather(g+1) is emitted before compute(g) for every span, so
    the next span's wire time hides behind the current span's arithmetic;
    the head's gather hides behind the last span.  Backward: the head VJP
    (which produces the loss) runs first with span n's re-gather already
    in flight, then spans re-gather/VJP/scatter in reverse with span k-1's
    re-gather emitted before span k's VJP.  The stem is gathered once and
    stays live to the end (tied unembeddings read it in the head).
    """
    n = int(n_spans)
    head = head_group(n)
    ev: List[Event] = [(GATHER, STEM_GROUP), (COMPUTE, STEM_GROUP)]
    if n:
        ev.append((GATHER, span_group(0)))
    for k in range(n):
        # prefetch the next group's buckets before this span computes
        ev.append((GATHER, span_group(k + 1) if k + 1 < n else head))
        ev.append((COMPUTE, span_group(k)))
    if not n:
        ev.append((GATHER, head))
    # backward: span n's re-gather overlaps the head VJP
    if n:
        ev.append((GATHER, span_group(n - 1)))
    ev += [(GRAD, head), (SCATTER, head)]
    for k in range(n - 1, -1, -1):
        if k:
            ev.append((GATHER, span_group(k - 1)))     # prefetch re-gather
        ev += [(GRAD, span_group(k)), (SCATTER, span_group(k))]
    ev += [(GRAD, STEM_GROUP), (SCATTER, STEM_GROUP)]
    return tuple(ev)


def _liveness(events: Sequence[Event], n_spans: int):
    """Yield (event, live_groups_after) walking the schedule's liveness.

    A group's gathered buffers are live from its (re)gather until its
    consuming compute/VJP is done; the stem stays live until its own VJP
    (the head may read it for tied unembeddings).
    """
    live: set = set()
    for ph, g in events:
        if ph == GATHER:
            live.add(g)
        elif ph == COMPUTE and g != STEM_GROUP:
            live.discard(g)                    # fwd span dies after compute
        elif ph == GRAD:
            live.discard(g)                    # bwd group dies after its VJP
        yield (ph, g), frozenset(live)
    assert not live, live


def validate_stream_schedule(events: Sequence[Event], n_spans: int) -> None:
    """Assert the streamed-schedule invariants (pure, used by tests)."""
    head = head_group(n_spans)
    pos: Dict[Event, List[int]] = {}
    for i, e in enumerate(events):
        pos.setdefault(e, []).append(i)
    # every span gathers twice (fwd + bwd re-gather), stem/head once
    for k in range(n_spans):
        assert len(pos[(GATHER, span_group(k))]) == 2, k
    assert len(pos[(GATHER, STEM_GROUP)]) == len(pos[(GATHER, head)]) == 1
    # gather precedes the consuming compute / VJP; scatter follows the VJP
    for k in range(n_spans):
        g = span_group(k)
        assert pos[(GATHER, g)][0] < pos[(COMPUTE, g)][0]
        assert pos[(GATHER, g)][1] < pos[(GRAD, g)][0]
        assert pos[(GRAD, g)][0] < pos[(SCATTER, g)][0]
    # span k+1's gather is issued before span k's compute (fwd), span
    # k-1's before span k's VJP (bwd)
    for k in range(n_spans - 1):
        assert pos[(GATHER, span_group(k + 1))][0] < \
            pos[(COMPUTE, span_group(k))][0], k
        assert pos[(GATHER, span_group(k))][1] < \
            pos[(GRAD, span_group(k + 1))][0], k
    # at most two *span* gathers live at any point (stem/head ride along)
    for _, live in _liveness(events, n_spans):
        spans_live = [g for g in live if 0 < g <= n_spans]
        assert len(spans_live) <= 2, (spans_live, n_spans)


def max_in_flight_gathered_bytes(group_bytes: Dict[int, int],
                                 n_spans: int) -> int:
    """Peak gathered bytes of the schedule (liveness walk, exact)."""
    peak = 0
    for _, live in _liveness(stream_schedule(n_spans), n_spans):
        peak = max(peak, sum(group_bytes.get(g, 0) for g in live))
    return peak


def expected_stream_gathers(plan) -> int:
    """Bucket gathers of ONE streamed fwd+bwd of one member.

    Every group's buckets gather once in the forward; spans re-gather in
    the backward (stem and head stay live / are still live at their VJPs).
    Zero-size buckets are never gathered.
    """
    lay = plan.shard_layout
    n_real = sum(1 for s in lay.bucket_sizes if s)
    n_span_real = sum(
        1 for s, g in zip(lay.bucket_sizes, lay.bucket_groups)
        if s and 0 < g <= plan.n_stream_spans)
    return n_real + n_span_real


def _requiring_grad(tree):
    """(``tree`` with each leaf detached and requiring grad, its leaves)."""
    leaves, treedef = tr.tree_flatten(tree)
    leaves = [l.detach().requires_grad_(True) for l in leaves]
    return tr.tree_unflatten(treedef, leaves), leaves


def _vjp(out, inputs, cotangent=None):
    """The cotangents of ``inputs`` (None where ``out`` does not read one)
    for ``out`` against ``cotangent`` (ones for a scalar loss)."""
    return torch.autograd.grad(out, inputs, grad_outputs=cotangent,
                               allow_unused=True)


def _cotangent_tree(tree, grads):
    """``grads`` in ``tree``'s structure, zeros where a leaf was unread."""
    leaves, treedef = tr.tree_flatten(tree)
    return tr.tree_unflatten(treedef, [
        torch.zeros_like(l) if g is None else g
        for l, g in zip(leaves, grads)])


# ---------------------------------------------------------------------------
# The engine's event log
# ---------------------------------------------------------------------------

# what the engine logs beside COMPUTE and GRAD (each when done)
GATHER_POST = "gather_post"          # a group's gathers posted
GATHER_RESOLVE = "gather_resolve"    # a group's gathers resolved
SCATTER_POST = "scatter_post"        # a group's reduce-scatters posted
SCATTER_RESOLVE = "scatter_resolve"  # a group's reduce-scatters resolved
# reduce-scatters in flight at once, in groups (the engine lands the
# oldest before it posts a third)
MAX_SCATTERS_IN_FLIGHT = 2


def _consumer(g: int, n_spans: int, second: bool) -> str:
    """What consumes a group's gather: a span's forward gather its
    compute, its re-gather and the head's gather a VJP, the stem's its
    compute (it stays live to its VJP)."""
    if g == STEM_GROUP or (0 < g <= n_spans and not second):
        return COMPUTE
    return GRAD


def check_stream_event_log(record: dict, plan) -> dict:
    """Hold one engine run's event log (``record``: its ``n_spans``,
    ``events``, each ``(kind, group, seconds)``, ``gathers`` and
    ``peak_gathered_bytes``) to :func:`stream_schedule`: the gathers
    issued, the computes, the VJPs and the scatters posted in the
    schedule's order; span k+1's gather issued before span k's compute
    and span k-1's re-gather before span k's VJP; every gather resolved
    after its issue and before its consumer, every scatter posted after
    its VJP and resolved after its post and before the run ends; at most
    2 span gathers live and at most :data:`MAX_SCATTERS_IN_FLIGHT` groups'
    scatters in flight; the run's bucket gathers
    :func:`expected_stream_gathers`; its live gathered bytes at most
    ``plan.stream_peak_gathered_bytes()``.  Returns the run's counts and
    bounds; raises AssertionError."""
    n = record["n_spans"]
    events = record["events"]
    sched = stream_schedule(n)

    def fail(msg):
        raise AssertionError(f"stream event log: {msg}")

    for kind, ph in ((GATHER_POST, GATHER), (COMPUTE, COMPUTE),
                     (GRAD, GRAD), (SCATTER_POST, SCATTER)):
        got = [g for k, g, _ in events if k == kind]
        want = [g for p, g in sched if p == ph]
        if got != want:
            fail(f"{kind} order {got}, the schedule's {want}")
    # positions of each kind's occurrences, by group
    pos: Dict[Tuple[str, int], List[int]] = {}
    for i, (kind, g, _) in enumerate(events):
        pos.setdefault((kind, g), []).append(i)
    at = lambda kind, g, j=0: pos[(kind, g)][j]
    for k in range(n):
        nxt = span_group(k + 1) if k + 1 < n else head_group(n)
        if not at(GATHER_POST, nxt) < at(COMPUTE, span_group(k)):
            fail(f"group {nxt}'s gather issued after span {k}'s compute")
        if k and not at(GATHER_POST, span_group(k - 1), 1) < at(GRAD,
                                                          span_group(k)):
            fail(f"span {k - 1}'s re-gather issued after span {k}'s VJP")
    for (kind, g), issues in pos.items():
        if kind != GATHER_POST:
            continue
        resolves = pos.get((GATHER_RESOLVE, g), [])
        if len(resolves) != len(issues):
            fail(f"group {g}: {len(issues)} gathers, {len(resolves)} "
                 f"resolves")
        for j, (a, b) in enumerate(zip(issues, resolves)):
            use = _consumer(g, n, j == 1)
            if not a < b < at(use, g):
                fail(f"group {g}'s gather {j} resolved out of order")
    for g in {g for k, g, _ in events if k == SCATTER_POST}:
        posts = pos[(SCATTER_POST, g)]
        lands = pos.get((SCATTER_RESOLVE, g), [])
        if len(lands) != 1 or not at(GRAD, g) < posts[0] < lands[0]:
            fail(f"group {g}'s scatter out of order or never resolved")
    scatters = most_spans = most_scatters = 0
    live: set = set()
    for kind, g, _ in events:
        if kind == GATHER_POST:
            live.add(g)
        elif (kind == COMPUTE and g != STEM_GROUP) or kind == GRAD:
            live.discard(g)
        scatters += {SCATTER_POST: 1, SCATTER_RESOLVE: -1}.get(kind, 0)
        most_spans = max(most_spans, sum(1 for x in live if 0 < x <= n))
        most_scatters = max(most_scatters, scatters)
    if most_spans > 2:
        fail(f"{most_spans} span gathers live at once")
    if most_scatters > MAX_SCATTERS_IN_FLIGHT:
        fail(f"{most_scatters} groups' scatters in flight at once")
    want_gathers = expected_stream_gathers(plan)
    if record["gathers"] != want_gathers:
        fail(f"{record['gathers']} bucket gathers, expected {want_gathers}")
    bound = plan.stream_peak_gathered_bytes()
    if record["peak_gathered_bytes"] > bound:
        fail(f"{record['peak_gathered_bytes']} gathered bytes live at "
             f"once, the schedule's peak {bound}")
    return {"events": len(events), "gathers": record["gathers"],
            "span_gathers_live_max": most_spans,
            "scatters_in_flight_max": most_scatters,
            "peak_gathered_bytes": record["peak_gathered_bytes"],
            "peak_bound": bound}


def take_gathered(gathered: Dict[int, object], g: int):
    """Group ``g``'s gathered sub-tree, resolved; its receipt leaves
    ``gathered`` (which holds every group's gather not yet consumed)."""
    return pipeline.resolve(gathered.pop(g))


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

def streamed_loss_and_grad_shards(plan, layered, shards, batches, *,
                                  pod: int, overlap: bool = True):
    """One streamed fwd+bwd of pod ``pod``'s members.

    ``plan``     a streamed-policy :class:`~repro_torch.core.plan.
                 AveragingPlan` compiled over the layered param tree;
    ``layered``  the model's :class:`~repro_torch.models.common.LayeredModel`;
    ``shards``   the ``(P_eff, n_b)`` shard buffers (the full tuple); over
                 ranks this rank's ``(1, n_b / pod_size)`` slices;
    ``batches``  each member's batch, in rank order; over ranks this
                 member's alone.

    A GATHER posts the group's gathers (over ranks, all-gathers whose
    receipts the engine keeps; on one card views) and the group's COMPUTE
    or VJP resolves them right before it reads them; a SCATTER posts the
    group's reduce-scatters (over ranks) as soon as its VJP ends, and the
    engine resolves them at the latest before it returns, with at most
    :data:`MAX_SCATTERS_IN_FLIGHT` groups' in flight.  ``overlap=False``
    resolves every receipt as soon as it is posted (the same arithmetic).
    Where ``plan.stream_log`` is a list, the run's event log is appended
    to it (:func:`check_stream_event_log`).

    A span's re-run under autograd in the backward is its
    rematerialisation, so it runs without ``checkpoint``: each span's
    forward runs twice, as under the gather-all path's ``checkpoint``
    (the JAX engine's ``remat`` flag pins XLA's fusions; eager PyTorch
    runs the same ops either way, so the bits do not depend on it).

    Returns ``(losses, metrics, grad_shards)``: each member's loss and
    metrics, and the pod's float32 pod-mean gradient buffers ``(n_b,)`` in
    global bucket order (over ranks this rank's slices of them), the
    object ``plan.grad_shards`` makes of the members' whole gradient trees
    on the gather-all path, made without one member's whole gradient tree
    ever existing.
    """
    n = layered.n_spans
    head = head_group(n)
    if plan.n_stream_spans != n:
        raise ValueError(f"plan has {plan.n_stream_spans} spans, "
                         f"model decomposes into {n}")
    if plan.world is not None and len(batches) != 1:
        raise ValueError(f"over ranks the engine runs this member's batch "
                         f"alone, got {len(batches)}")
    members = range(len(batches))
    gathered: Dict[int, object] = {}
    unresolved: set = set()               # gathers posted, not resolved
    regathered: set = set()
    boundary: List[Dict[int, torch.Tensor]] = [{} for _ in members]
    pending: Dict[int, object] = {}       # group -> member grads to pack
    scatters: List[Tuple[int, tuple]] = []    # posted, not yet resolved
    grad_list = [None] * plan.shard_layout.n_buckets
    carry = [None for _ in members]
    aux = [None for _ in members]
    d_carry = [None for _ in members]
    d_stem_head = [None for _ in members]
    losses = [None for _ in members]
    metrics = [None for _ in members]
    stem_tree = None
    events = None if plan.stream_log is None else []
    group_bytes = plan.stream_group_bytes()
    live_bytes = [0, 0]                   # live gathered bytes, their peak
    gathers0 = plan.stream_gathers

    def note(kind, g):
        if events is not None:
            events.append((kind, g, time.perf_counter()))

    def hold(g, sign):
        live_bytes[0] += sign * group_bytes.get(g, 0)
        live_bytes[1] = max(live_bytes[1], live_bytes[0])

    def take(g):
        """Group ``g``'s gathered tree, resolved right before its use."""
        tree = take_gathered(gathered, g)
        if g in unresolved:
            unresolved.discard(g)
            note(GATHER_RESOLVE, g)
        return tree

    def done(kind, g):
        note(kind, g)
        hold(g, -1)

    def land():
        g, bufs = scatters.pop(0)
        for bi, buf in zip(plan.stream_bucket_indices(g),
                           pipeline.resolve(bufs)):
            grad_list[bi] = buf
        note(SCATTER_RESOLVE, g)

    def head_vjps(head_tree):
        for m in members:
            h, h_leaves = _requiring_grad(head_tree)
            s, s_leaves = _requiring_grad(stem_tree)
            c = carry[m].detach().requires_grad_(True)
            with torch.enable_grad():
                loss, met = layered.head_loss(h, s, c, aux[m], batches[m])
            grads = _vjp(loss, h_leaves + s_leaves + [c])
            nh = len(h_leaves)
            d_head = _cotangent_tree(head_tree, grads[:nh])
            d_stem_head[m] = list(grads[nh:-1])
            d_carry[m] = grads[-1]
            losses[m] = loss.detach()
            metrics[m] = {k: v.detach().float() for k, v in met.items()}
            carry[m] = None
            del h, s, c, loss, met, grads
            yield d_head
            del d_head
        done(GRAD, head)

    def span_vjps(g, span_tree):
        for m in members:
            p, p_leaves = _requiring_grad(span_tree)
            c = boundary[m].pop(g).requires_grad_(True)
            with torch.enable_grad():
                out = layered.span(g - 1, p, c, aux[m], remat=False)
            grads = _vjp(out, p_leaves + [c], d_carry[m])
            d_carry[m] = grads[-1]
            d_span = _cotangent_tree(span_tree, grads[:-1])
            del p, c, out, grads
            yield d_span
            del d_span
        done(GRAD, g)

    def stem_vjps():
        nonlocal stem_tree
        for m in members:
            s, s_leaves = _requiring_grad(stem_tree)
            with torch.enable_grad():
                x, _ = layered.stem(s, batches[m])
            d_stem = list(_vjp(x, s_leaves, d_carry[m]))
            d_carry[m] = None
            # a tied unembedding reads the stem in the head too: its two
            # cotangents add once, as autograd adds them on the gather-all
            # path; an untied head does not read the stem (no add)
            d_stem = [a if b is None else a + b
                      for a, b in zip(d_stem, d_stem_head[m])]
            d_stem_head[m] = None
            del s, x
            yield _cotangent_tree(stem_tree, d_stem)
            del d_stem
        stem_tree = None
        done(GRAD, STEM_GROUP)

    for ph, g in stream_schedule(n):
        if ph == GATHER:
            gathered[g] = plan.stream_unshard(shards, g, pod=pod,
                                              barrier=g in regathered)
            regathered.add(g)
            note(GATHER_POST, g)
            hold(g, +1)
            if overlap:
                unresolved.add(g)
            else:
                gathered[g] = pipeline.resolve(gathered[g])
                note(GATHER_RESOLVE, g)
        elif ph == COMPUTE:
            with torch.no_grad():
                if g == STEM_GROUP:
                    stem_tree = take(STEM_GROUP)       # live to its VJP
                    for m in members:
                        carry[m], aux[m] = layered.stem(stem_tree,
                                                        batches[m])
                    note(COMPUTE, g)
                else:
                    # forward primal only: no residuals are kept (the
                    # backward re-runs the span inside its VJP)
                    span_tree = take(g)
                    for m in members:
                        boundary[m][g] = carry[m]
                        carry[m] = layered.span(g - 1, span_tree, carry[m],
                                                aux[m], remat=False)
                    del span_tree
                    done(COMPUTE, g)
        elif ph == GRAD:
            if g == head:
                pending[g] = head_vjps(take(head))
            elif g == STEM_GROUP:
                pending[g] = stem_vjps()
            else:
                pending[g] = span_vjps(g, take(g))
        else:  # SCATTER: the members' float32 pod mean, bucket order
            if len(scatters) >= MAX_SCATTERS_IN_FLIGHT:
                land()
            scatters.append((g, plan.stream_grad_shards(pending.pop(g), g)))
            note(SCATTER_POST, g)
            if not overlap:
                land()
    while scatters:
        land()
    if events is not None:
        plan.stream_log.append({
            "n_spans": n, "events": events,
            "gathers": plan.stream_gathers - gathers0,
            "peak_gathered_bytes": live_bytes[1]})
    assert all(b is not None for b in grad_list)
    return losses, metrics, tuple(grad_list)
