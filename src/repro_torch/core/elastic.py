"""Elastic topology: membership epochs, Topology diffing, state handoff.

Counterpart of ``repro/core/elastic.py``.  The host-side half of
surviving churn without a restart:

* :func:`diff_topology` — structural diff between two dp topologies.  A
  membership change is a *resize* of one or more dp axes (axis names and
  link classes must survive the change); anything resized means the
  compiled :class:`~repro_torch.core.plan.AveragingPlan` must be
  recompiled (the plan cache keys on topology, so recompilation is a
  ``compile_plan`` call on the new topology, and
  :func:`repro_torch.core.plan.evict_topology` drops the dead entries).
* :class:`MembershipController` — epoch-stamped worker membership.  The
  butterfly needs power-of-two worlds (``grouping.ilog2`` is enforced at
  ``Topology`` construction), so the controller quantises the healthy
  worker set down to the largest power of two; surplus healthy workers
  wait as *spares*.  Leaves shrink the world immediately (a dead worker
  blocks every collective); joins, and spare promotions, are deferred to
  the next tau-sync barrier, where every surviving replica holds the
  identical post-sync consensus model, so a joiner can adopt it with
  zero staleness.  That is the restart discipline Parallel Restarted SGD
  (PAPERS.md, arxiv 1807.06629) shows preserves convergence, and it keeps
  the simulator's invariant: buffer age never exceeds
  ``staleness.max_staleness_bound(tau)``.
* :func:`handoff_state` / :func:`select_replica_rows` /
  :func:`regrow_replica_state` — checkpoint-free state movement between
  worlds.  A replicated state's rows are selected where they lie: params
  and moments by ``index_select`` on their own device, the per-replica
  optimiser ``count`` on the host, where the ``Trainer`` keeps it.  No
  file is written.  A sharded (FSDP) state unpacks its pod rows through
  the old plan's shard layout, selects them and repacks them through the
  new plan's (both gather-all or both layer-streamed).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

from repro_torch.core import tree as tr
from repro_torch.core.replica import (ReplicaState, _pack_rows, _unpack_rows,
                                      map_opt_state)


def largest_pow2(n: int) -> int:
    """Largest power of two <= n (0 for n <= 0)."""
    if n <= 0:
        return 0
    return 1 << (int(n).bit_length() - 1)


# ---------------------------------------------------------------------------
# Topology diffing
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TopologyDiff:
    """Structural diff between two dp topologies (old -> new).

    ``resized`` lists ``(axis_name, old_size, new_size)`` for every axis
    whose size changed.  Any resize invalidates the compiled plan: stage
    classification, per-class budgets, and the bucket layouts all depend
    on the axis sizes.
    """
    old: object
    new: object
    resized: Tuple[Tuple[str, int, int], ...]

    @property
    def requires_recompile(self) -> bool:
        return bool(self.resized)

    def describe(self) -> str:
        if not self.resized:
            return "topology unchanged"
        parts = [f"{name}: {o} -> {n}" for name, o, n in self.resized]
        return f"resized {', '.join(parts)} (P {self.old.P} -> {self.new.P})"


def diff_topology(old, new) -> TopologyDiff:
    """Diff two topologies of the same axis/link-class structure.

    Membership changes resize dp axes; they never rename axes or change
    which link class an axis rides (the physical interconnect does not
    change when a pod leaves), so anything but a size change is an error.
    """
    if old.axis_names != new.axis_names:
        raise ValueError(f"axis names changed {old.axis_names} -> "
                         f"{new.axis_names}; membership changes only "
                         "resize axes")
    if old.axis_class != new.axis_class or \
            old.link_classes != new.link_classes:
        raise ValueError("link-class structure changed; membership changes "
                         "only resize axes")
    resized = tuple((name, o, n) for name, o, n
                    in zip(old.axis_names, old.axis_sizes, new.axis_sizes)
                    if o != n)
    return TopologyDiff(old, new, resized)


def resize_topology(topology, axis: str, new_size: int):
    """The same topology with one dp axis resized (same link classes).

    ``new_size`` must be a power of two (Topology enforces it); this is
    how a membership change turns into a topology for recompilation.
    """
    if axis not in topology.axis_names:
        raise ValueError(f"no axis {axis!r} in {topology.axis_names}")
    sizes = tuple(int(new_size) if name == axis else s
                  for name, s in zip(topology.axis_names,
                                     topology.axis_sizes))
    return dataclasses.replace(topology, axis_sizes=sizes)


# ---------------------------------------------------------------------------
# Epoch-stamped membership
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Membership:
    """One epoch's worker membership snapshot.

    ``active`` is the power-of-two collective world in rank order;
    ``spares`` are healthy workers holding no current state (demoted by a
    shrink, or joiners promoted-in-waiting); ``pending`` are announced
    joins not yet at a sync barrier.
    """
    epoch: int
    active: Tuple[int, ...]
    spares: Tuple[int, ...]
    pending: Tuple[int, ...]

    @property
    def world_size(self) -> int:
        return len(self.active)


@dataclass(frozen=True)
class MembershipEvent:
    """What one membership transition did.

    ``kind``: ``"shrink"`` (immediate, on a leave), ``"regrow"`` (at a
    tau-sync barrier), ``"defer"`` (join queued to the next barrier),
    ``"rejected-stale-epoch"`` (a detector verdict from a retired
    topology, refused — see :meth:`MembershipController.apply_verdict`)
    or ``"noop"``.  For shrinks, ``keep_rows`` are the OLD world's row
    indices that survive, in NEW world rank order — exactly the argument
    :func:`handoff_state` takes.  For regrows, ``n_joined`` counts the
    appended rows.
    """
    kind: str
    epoch: int
    world: Tuple[int, ...]
    keep_rows: Tuple[int, ...] = ()
    n_joined: int = 0


class MembershipController:
    """Epoch-stamped membership over a fixed pool of worker ids.

    The controller is pure bookkeeping — it decides *who* is in the
    world and *when* the world changes; the launch layer turns its
    events into trainer rebuilds, plan recompiles, and state handoffs.

    Rules:

    * the active world is always a power of two (butterfly invariant);
      surplus healthy workers are spares;
    * ``leave`` of an active worker shrinks the world immediately to
      ``largest_pow2(survivors)`` — a dead worker blocks collectives, so
      waiting is not an option; demoted-but-healthy workers become
      spares;
    * ``join`` defers to the next tau-sync barrier
      (:meth:`at_sync_barrier`), where spares + pending joiners are
      promoted up to the next power of two and adopt the post-sync
      consensus state with zero staleness;
    * every world change bumps ``epoch`` — plans, handoffs, and logs are
      stamped with it so stale recompiles are detectable.
    """

    def __init__(self, workers: Sequence[int], *, min_world: int = 2):
        workers = [int(w) for w in workers]
        if len(set(workers)) != len(workers):
            raise ValueError("duplicate worker ids")
        n = largest_pow2(len(workers))
        if n < min_world:
            raise ValueError(f"{len(workers)} workers cannot form a world "
                             f"of at least {min_world}")
        self.min_world = int(min_world)
        self.epoch = 0
        self._active: List[int] = workers[:n]
        self._spares: List[int] = workers[n:]
        self._pending: List[int] = []
        self._history: List[Membership] = [self.membership]

    @property
    def membership(self) -> Membership:
        return Membership(self.epoch, tuple(self._active),
                          tuple(self._spares), tuple(self._pending))

    @property
    def history(self) -> Tuple[Membership, ...]:
        """Every epoch's snapshot, oldest first (epoch audit trail)."""
        return tuple(self._history)

    def _bump(self) -> None:
        self.epoch += 1
        self._history.append(self.membership)

    def leave(self, worker: int) -> MembershipEvent:
        """Worker died / was preempted.  Shrinks the world if it was active."""
        worker = int(worker)
        if worker in self._pending:
            self._pending.remove(worker)
            return MembershipEvent("noop", self.epoch, tuple(self._active))
        if worker in self._spares:
            self._spares.remove(worker)
            return MembershipEvent("noop", self.epoch, tuple(self._active))
        if worker not in self._active:
            raise ValueError(f"unknown worker {worker}")
        old_active = list(self._active)
        survivors = [w for w in old_active if w != worker]
        n = largest_pow2(len(survivors))
        if n < self.min_world:
            raise RuntimeError(
                f"worker {worker} left; {len(survivors)} survivors cannot "
                f"form a world of at least {self.min_world}")
        self._active = survivors[:n]
        # demoted-but-healthy workers rejoin at the next sync barrier
        self._spares.extend(survivors[n:])
        self._bump()
        keep = tuple(old_active.index(w) for w in self._active)
        return MembershipEvent("shrink", self.epoch, tuple(self._active),
                               keep_rows=keep)

    def join(self, worker: int) -> MembershipEvent:
        """Worker announced itself; promotion waits for the sync barrier."""
        worker = int(worker)
        if worker in self._active or worker in self._spares \
                or worker in self._pending:
            return MembershipEvent("noop", self.epoch, tuple(self._active))
        self._pending.append(worker)
        return MembershipEvent("defer", self.epoch, tuple(self._active))

    def apply_verdict(self, verdict) -> MembershipEvent:
        """Detection -> membership: act on a `core.health.Verdict`.

        This is the autonomous twin of the scripted :meth:`leave`: a
        SUSPECT verdict shrinks the world (a hung partner must not block
        the butterfly), a DEAD verdict removes whatever trace of the
        worker remains (usually a noop — the suspect shrink already ran).

        A verdict stamped with a **stale epoch** is rejected outright:
        it was raised against a topology that has since been retired
        (its plan-cache entries evicted via ``plan.evict_topology``),
        and its worker/row indictment means nothing in the current
        world.  Acting on it would shrink the *current* world for a
        failure observed in a dead one.
        """
        if verdict.epoch != self.epoch:
            return MembershipEvent("rejected-stale-epoch", self.epoch,
                                   tuple(self._active))
        from repro_torch.core import health as _health
        if verdict.state == _health.RECOVERED:
            return self.join(verdict.worker)
        if verdict.state not in (_health.SUSPECT, _health.DEAD):
            raise ValueError(f"unactionable verdict state {verdict.state!r}")
        w = int(verdict.worker)
        if w not in self._active and w not in self._spares \
                and w not in self._pending:
            return MembershipEvent("noop", self.epoch, tuple(self._active))
        return self.leave(w)

    def at_sync_barrier(self) -> MembershipEvent:
        """Called right after a tau-sync step: promote waiting workers.

        All surviving replicas hold the identical post-sync consensus
        model here, so promoted workers adopt it bit-exactly with zero
        staleness (:func:`regrow_replica_state`).  The world grows to the
        largest power of two the healthy set supports.
        """
        candidates = self._spares + self._pending
        n = largest_pow2(len(self._active) + len(candidates))
        if n <= len(self._active):
            return MembershipEvent("noop", self.epoch, tuple(self._active))
        n_joined = n - len(self._active)
        promoted = candidates[:n_joined]
        self._active = self._active + promoted
        self._spares = [w for w in self._spares if w not in promoted]
        self._pending = [w for w in self._pending if w not in promoted]
        self._bump()
        return MembershipEvent("regrow", self.epoch, tuple(self._active),
                               n_joined=n_joined)


# ---------------------------------------------------------------------------
# Checkpoint-free state handoff
# ---------------------------------------------------------------------------

def select_replica_rows(state: ReplicaState, rows: Sequence[int]
                        ) -> ReplicaState:
    """Row selection on any stacked ReplicaState layout.

    Every leaf (the replicated ``(P, ...)`` params and moments, the FSDP
    ``(P_eff, n_b)`` shard buffers, the per-replica optimiser ``count``)
    carries the replica dimension first; each is
    selected by ``index_select`` where it lies, so a state on the card
    never crosses to the host.  ``rows`` may repeat (that is how
    :func:`regrow_replica_state` clones the consensus row for joiners).
    Returns new tensors; ``state`` is not modified.
    """
    rows = [int(r) for r in rows]
    index = {}

    def take(a):
        idx = index.get(a.device)
        if idx is None:
            idx = index[a.device] = torch.tensor(rows, dtype=torch.long,
                                                 device=a.device)
        return a.index_select(0, idx)

    sel = lambda tree: tr.tree_map(take, tree)
    return ReplicaState(sel(state.params),
                        map_opt_state(state.opt_state, sel, sel),
                        state.step, state.phase)


def handoff_state(state: ReplicaState, keep_rows: Sequence[int], *,
                  old_plan=None, new_plan=None) -> ReplicaState:
    """Re-seat a ReplicaState onto a resized world, checkpoint-free.

    ``keep_rows`` indexes the old world's *effective* replica rows (pods,
    under FSDP) that survive, in new-world rank order (a shrink event's
    ``keep_rows``).  A replicated state is a plain row selection.  A
    sharded state unpacks its shard buffers through ``old_plan``'s layout
    into pod rows, selects them, and repacks them through ``new_plan``'s
    layout: the new topology may pick other bucket budgets, so the layouts
    need not match.  Both plans must share the policy and be on the same
    streamed-ness (a shrink never changes the execution engine; cross
    that seam through ``checkpoint.load_replica_state``).
    """
    old_sharded = old_plan is not None and old_plan.sharding.is_sharded
    new_sharded = new_plan is not None and new_plan.sharding.is_sharded
    if old_sharded != new_sharded:
        raise ValueError("handoff_state does not cross sharding policies; "
                         "both worlds must be replicated or both fsdp")
    if old_sharded and \
            old_plan.sharding.streamed != new_plan.sharding.streamed:
        raise ValueError("handoff_state does not cross streamed <-> "
                         "gather-all; restore through "
                         "checkpoint.load_replica_state instead")
    if not old_sharded:
        return select_replica_rows(state, keep_rows)

    unstack = lambda t: _unpack_rows(t, old_plan.shard_layout, cast=False)
    pod_state = ReplicaState(
        _unpack_rows(state.params, old_plan.shard_layout),
        map_opt_state(state.opt_state, unstack, lambda c: c),
        state.step, state.phase)
    pod_state = select_replica_rows(pod_state, keep_rows)

    n = new_plan.P_eff
    if len(tuple(keep_rows)) != n:
        raise ValueError(f"{len(tuple(keep_rows))} surviving rows but the "
                         f"new plan has P_eff={n}")
    restack = lambda t: _pack_rows(t, new_plan.shard_layout, n,
                                   dtype=torch.float32)
    return ReplicaState(
        _pack_rows(pod_state.params, new_plan.shard_layout, n),
        map_opt_state(pod_state.opt_state, restack, lambda c: c),
        pod_state.step, pod_state.phase)


def regrow_replica_state(state: ReplicaState, n_total: int, *,
                         source_row: int = 0) -> ReplicaState:
    """Append joiner rows that adopt the post-sync consensus state.

    MUST be called at a tau-sync barrier: the sync collective hands every
    survivor the identical averaged model, so cloning ``source_row``
    seats the joiner on the global consensus bit-exactly — params,
    optimiser moments, and step/phase bookkeeping — with zero staleness,
    exactly the restart point ``max_staleness_bound(tau)`` assumes.
    """
    leaves = tr.tree_leaves(state.params)
    n_now = int(leaves[0].shape[0]) if leaves else 0
    if n_total < n_now:
        raise ValueError(f"regrow to {n_total} < current {n_now} rows")
    rows = list(range(n_now)) + [int(source_row)] * (n_total - n_now)
    return select_replica_rows(state, rows)
