"""Software-pipelined bucket scheduler — hide the combine behind the wire.

The port's own copy of ``repro/core/overlap.py``: the schedule functions
are pure Python and identical to the JAX package's (pinned by tests); the
drivers run on torch buffers (``numel()`` where JAX reads ``size``).

The serial bucketed path walks buckets one at a time: bucket k's exchange
must land, then its combine runs, then bucket k+1's exchange is issued, so
combine time adds directly to wire time.  This module restructures the
butterfly into a **wavefront over the (bucket, stage) grid** (DESIGN.md
§8): within a stage, bucket k+1's exchange is issued before bucket k's
combine runs, and across stages there is no global barrier.

Only inter-bucket interleaving changes.  Each bucket still sees exactly the
serial per-bucket program — ``log2(S)`` exchange+add stages in order, scale
on the last — and buckets never read each other's data, so the overlapped
path is bit-compatible with the serial bucketed path and the per-leaf
reference.

Cell ``(k, s)`` (bucket k, butterfly stage s) issues its exchange at tick
``k + 2s`` and combines at tick ``k + 2s + 1``; within a tick all
exchanges are emitted before any combine.  Combines that fall between two
exchange runs are mutually independent and are handed to the caller *as a
batch*, which the fused path feeds to the multi-pair kernel K2 (one launch
per batch and scale) instead of one launch per bucket.

Over ranks (``plan.RankWire``) the reference's asynchronous
collective-permute (start/done) is made explicit: an exchange returns a
:class:`Receipt` at its tick, and the wavefront waits on it
(:func:`resolve`) only right before its combine batch, so bucket k+1's
payload is on the wire while bucket k combines.  The combines and their
K1/K2 batches are the stacked path's.  Asked for a log, the wavefront
records each cell's issue, resolve and combine (:func:`check_event_log`
holds a log to the schedule).

``overlapped_stage_seconds`` models the throughput claim: the per-stage
alpha-beta cost becomes ``launch + max(wire, combine) + fill/drain``.
"""

from __future__ import annotations

import time
from functools import lru_cache
from typing import Callable, Dict, List, Optional, Sequence, Tuple

EXCHANGE = "exchange"
COMBINE = "combine"
# the event log's kinds beside COMBINE
ISSUE = "issue"
RESOLVE = "resolve"

# (phase, bucket, stage): phase is EXCHANGE or COMBINE
Event = Tuple[str, int, int]


@lru_cache(maxsize=None)
def pipeline_schedule(n_buckets: int, n_stages: int) -> Tuple[Event, ...]:
    """Wavefront emission order over the (bucket, stage) grid.

    Cell (k, s) exchanges at tick ``k + 2s`` and combines at tick
    ``k + 2s + 1``; per tick, exchanges are emitted before combines.  The
    schedule therefore satisfies, in emission order:

    * per-bucket stage chain: exchange(k, s) < combine(k, s)
      < exchange(k, s+1)   (correctness — stage order unchanged);
    * overlap: exchange(k+1, s) < combine(k, s)   (bucket k+1's payload is
      on the wire before bucket k's arithmetic runs);
    * no stage barrier: exchange(k, s+1) < combine(k', s) for all
      k' >= k + 2 (bucket k advances while later buckets still combine
      the previous stage).
    """
    if n_buckets <= 0 or n_stages <= 0:
        return ()
    events: List[Event] = []
    last_tick = (n_buckets - 1) + 2 * (n_stages - 1) + 1
    for tick in range(last_tick + 1):
        for k in range(min(n_buckets - 1, tick), -1, -1):
            rem = tick - k
            if rem % 2 == 0 and rem // 2 < n_stages:
                events.append((EXCHANGE, k, rem // 2))
        for k in range(min(n_buckets - 1, tick - 1), -1, -1):
            rem = tick - 1 - k
            if rem % 2 == 0 and rem // 2 < n_stages:
                events.append((COMBINE, k, rem // 2))
    return tuple(events)


def validate_schedule(events: Sequence[Event], n_buckets: int,
                      n_stages: int) -> None:
    """Assert the three schedule invariants (used by tests; cheap, pure)."""
    pos = {(ph, k, s): i for i, (ph, k, s) in enumerate(events)}
    assert len(pos) == len(events) == 2 * n_buckets * n_stages, \
        "every cell must exchange exactly once and combine exactly once"
    for k in range(n_buckets):
        for s in range(n_stages):
            assert pos[(EXCHANGE, k, s)] < pos[(COMBINE, k, s)], (k, s)
            if s + 1 < n_stages:
                assert pos[(COMBINE, k, s)] < pos[(EXCHANGE, k, s + 1)], (k, s)
            if k + 1 < n_buckets:
                # the tentpole property: next bucket's wire before my combine
                assert pos[(EXCHANGE, k + 1, s)] < pos[(COMBINE, k, s)], (k, s)


def combine_batches(events: Sequence[Event]) -> List[List[Tuple[int, int]]]:
    """Group consecutive combine events into batches of independent cells.

    Each batch is every combine emitted between two exchange runs; cells in
    a batch touch distinct buckets, so the fused path hands a whole batch to
    one multi-bucket kernel launch instead of one launch per bucket.
    """
    batches: List[List[Tuple[int, int]]] = []
    cur: List[Tuple[int, int]] = []
    for ph, k, s in events:
        if ph == COMBINE:
            cur.append((k, s))
        elif cur:
            batches.append(cur)
            cur = []
    if cur:
        batches.append(cur)
    return batches


@lru_cache(maxsize=None)
def max_in_flight(n_buckets: int, n_stages: int) -> int:
    """The most exchanges :func:`overlapped_butterfly` has issued and not
    yet resolved at once: an exchange adds one, and the combine batch
    flushed before the next exchange (or at the end) resolves its cells.
    2 wherever there are 2 or more buckets and one stage."""
    most = cur = pending = 0
    for ph, _, _ in pipeline_schedule(n_buckets, n_stages):
        if ph == EXCHANGE:
            cur += 1 - pending
            pending = 0
            most = max(most, cur)
        else:
            pending += 1
    return most


class Receipt:
    """A delivery a wire has issued and not yet waited for (the reference's
    collective-permute *start*).  ``wait()`` blocks until it has landed
    and returns the tensor, the same one on every later call (the
    *done*)."""

    def wait(self):
        raise NotImplementedError


class Mapped(Receipt):
    """``fn`` of what ``parts`` deliver (a receipt, or a tuple of them and
    tensors), made at the first wait: a group's gathered buckets unpacked
    into its tree, a reduce-scattered slice scaled."""

    def __init__(self, parts, fn: Callable):
        self.parts, self.fn, self.out = parts, fn, None

    def wait(self):
        if self.out is None:
            self.out = self.fn(resolve(self.parts))
            self.parts = None
        return self.out


def resolve(recv):
    """What a wire delivered, made tensors: a :class:`Receipt` waited for,
    a tuple element by element, anything else as it is (the stacked
    wire's tensors)."""
    if isinstance(recv, tuple):
        return tuple(resolve(r) for r in recv)
    return recv.wait() if isinstance(recv, Receipt) else recv


def take_receipt(inflight: Dict[int, object], k: int):
    """Bucket ``k``'s delivery, resolved; its receipt leaves ``inflight``
    (which holds the receipt of every bucket's exchange in flight)."""
    return resolve(inflight.pop(k))


def _note(events: Optional[list], kind: str, cells) -> None:
    if events is not None:
        t = time.perf_counter()
        events.extend((kind, k, s, t) for k, s in cells)


def check_event_log(record: dict) -> dict:
    """Hold one :func:`overlapped_butterfly` run's event log (``record``:
    its ``buckets``, ``stages`` and ``events``, each ``(kind, k, s,
    seconds)``) to :func:`pipeline_schedule`: every cell issued, resolved
    and combined once, in that order; bucket k+1's issue before bucket
    k's resolve at each stage; the most in flight at once at least 2
    where there are 2 or more buckets and at most :func:`max_in_flight`.
    Returns the run's ``issued``, ``in_flight_max``, its bound and
    ``span_s`` (first issue to last resolve); raises AssertionError."""
    n_b, n_s, events = record["buckets"], record["stages"], record["events"]
    pos = {(kind, k, s): i for i, (kind, k, s, _) in enumerate(events)}
    if not (len(pos) == len(events) == 3 * n_b * n_s):
        raise AssertionError(f"{len(events)} events for {n_b} buckets x "
                             f"{n_s} stages: a cell issued, resolved or "
                             f"combined other than once")
    for k in range(n_b):
        for s in range(n_s):
            if not (pos[(ISSUE, k, s)] < pos[(RESOLVE, k, s)]
                    < pos[(COMBINE, k, s)]):
                raise AssertionError(f"cell {(k, s)}: issue, resolve and "
                                     f"combine out of order")
            if k + 1 < n_b and pos[(ISSUE, k + 1, s)] > pos[(RESOLVE, k, s)]:
                raise AssertionError(f"bucket {k + 1}'s issue at stage {s} "
                                     f"after bucket {k}'s resolve")
    most = cur = 0
    for kind, _, _, _ in events:
        cur += {ISSUE: 1, RESOLVE: -1}.get(kind, 0)
        most = max(most, cur)
    bound = max_in_flight(n_b, n_s)
    if most > bound or (n_b >= 2 and most < 2):
        raise AssertionError(f"{most} exchanges in flight at once; the "
                             f"schedule has {bound}")
    times = [t for kind, _, _, t in events if kind in (ISSUE, RESOLVE)]
    return {"issued": n_b * n_s, "in_flight_max": most, "bound": bound,
            "span_s": (max(times) - min(times)) if times else 0.0}


def overlapped_butterfly(bufs: Sequence, bits: Sequence[int], inv_s: float,
                         exchange: Callable, combine_many: Callable,
                         log: Optional[list] = None) -> list:
    """Run the butterfly over flat buckets in wavefront order.

    ``bufs``          per-bucket buffers (``(P, n_b)`` on the stacked
                      path; zero-size buffers pass through untouched).
    ``bits``          the log2(S) XOR mask bits, in per-bucket stage order.
    ``inv_s``         final scale, applied inside the *last* combine only —
                      exactly the serial path's arithmetic.
    ``exchange(buf, bit) -> recv``
                      one butterfly wire step (the XOR partner's buffer,
                      or a :class:`Receipt` for it).
    ``combine_many(accs, recvs, scale) -> list``
                      combine a batch of independent (acc, recv) pairs —
                      the fused path maps this to ONE multi-pair kernel
                      launch; the reference path does per-pair torch math.
    ``log``           where given, gets one record of this run: its live
                      ``buckets``, ``stages`` and ``events``, each cell's
                      issue, resolve (right before its batch's combine)
                      and combine as ``(kind, k, s, seconds)``.
    """
    state = list(bufs)
    if not bits:
        return state
    live = [i for i, b in enumerate(state) if b.numel()]
    n_stages = len(bits)
    inflight: Dict[int, object] = {}
    pending: List[Tuple[int, int]] = []   # current combine batch
    events = None
    if log is not None:
        events = []
        log.append({"buckets": len(live), "stages": n_stages,
                    "events": events})

    def flush():
        if not pending:
            return
        by_scale: Dict[float, List[Tuple[int, int]]] = {}
        for k, s in pending:
            scale = inv_s if s == n_stages - 1 else 1.0
            by_scale.setdefault(scale, []).append((k, s))
        for scale, cells in by_scale.items():
            ks = [k for k, _ in cells]
            recvs = [take_receipt(inflight, k) for k in ks]
            _note(events, RESOLVE, cells)
            outs = combine_many([state[live[k]] for k in ks], recvs, scale)
            _note(events, COMBINE, cells)
            for k, out in zip(ks, outs):
                state[live[k]] = out
        pending.clear()

    for ph, k, s in pipeline_schedule(len(live), n_stages):
        if ph == EXCHANGE:
            flush()
            inflight[k] = exchange(state[live[k]], bits[s])
            _note(events, ISSUE, ((k, s),))
        else:
            pending.append((k, s))
    flush()
    return state


def overlapped_mix(bufs: Sequence, issue: Callable,
                   combine: Callable) -> list:
    """Single-stage pipeline for gossip/psum-style mixes.

    Issues every bucket's collective(s) before running any bucket's combine
    arithmetic, so the wire of bucket k+1 overlaps the combine of bucket k.
    ``issue(buf)`` returns whatever the collective(s) deliver (a buffer, a
    :class:`Receipt`, or a tuple of them), resolved right before its
    bucket's ``combine(buf, recv)``, the local arithmetic.
    """
    recvs = [issue(b) if b.numel() else None for b in bufs]
    return [combine(b, resolve(r)) if b.numel() else b
            for b, r in zip(bufs, recvs)]


# ---------------------------------------------------------------------------
# Analytic model of the schedule (used by group_allreduce and plan)
# ---------------------------------------------------------------------------

def overlapped_stage_seconds(wire_s: float, combine_s: float,
                             n_buckets: int, alpha: float) -> float:
    """Seconds for ONE butterfly stage under the wavefront schedule.

    With B equal buckets, per-bucket wire w = wire_s/B and combine
    c = combine_s/B, the stage is a two-resource pipeline: fill (first
    bucket's wire), B-1 overlapped slots at max(w, c), drain (last bucket's
    combine).  Launch latency alpha is paid per bucket regardless — issuing
    a collective is serial on the core.  Serial reference for the same
    inputs: ``n_buckets * alpha + wire_s + combine_s``.
    """
    b = max(n_buckets, 1)
    w, c = wire_s / b, combine_s / b
    return b * alpha + w + (b - 1) * max(w, c) + c
