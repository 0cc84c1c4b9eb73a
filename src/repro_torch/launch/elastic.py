"""Elastic membership: survive worker churn without a restart.

Counterpart of ``repro/launch/elastic.py``.  Composes the host-side
membership machinery (``core/elastic.py``) with the port's stacked
``Trainer``.  A worker is one replica row of the state on one device
(the reference gives each worker a device of a mesh):

* a **leave** (preemption, dead host) shrinks the world immediately —
  the survivors' replica rows are selected on the device
  (checkpoint-free), a ``Trainer`` over just those rows is built on them,
  and the averaging plan recompiles for the new topology (the plan cache
  keys on topology; the dead topology's entries are evicted);
* a **join** waits for the next tau-sync barrier: right after the sync
  every survivor holds the identical consensus model, so the joiner
  clones it bit-exactly with zero staleness (Parallel Restarted SGD's
  restart discipline — the same barrier that bounds simulator buffer age
  by ``max_staleness_bound(tau)``);
* every world change is **epoch-stamped** and logged with the topology
  diff and the number of evicted plan-cache entries.

The power-of-two butterfly invariant is kept by quantising the healthy
set (surplus workers wait as spares and rejoin at the barrier too).  The
old world's state is released before the new world's first step, so a
transition holds both worlds' rows only while the new ones are selected.

:func:`kill_rejoin_demo` scripts the whole protocol
(``python -m repro_torch.launch.elastic``).

**Chaos mode**: :meth:`ElasticTrainer.run_under_faults` drives the same
machinery *autonomously* — no scripted leaves.  A seeded
`core.faults.FaultSchedule` silences workers on a virtual clock, the
`core.health.FailureDetector` turns silence past the per-round
collective deadline into suspect/confirm verdicts, a suspect downgrades
the round to the survivors' quantised world through
``MembershipController.apply_verdict`` (same handoff + plan eviction as
a scripted leave), every skipped contribution is charged to a
`core.staleness.SkipLedger` (hard abort past ``max_staleness_bound``),
and recovered workers rejoin bit-identically at the tau-sync barrier.
Time is virtual (``step * step_time_s``), so the same schedule replays
bit-identically (:func:`chaos_demo`,
``python -m repro_torch.launch.elastic --chaos``).

Both demos run on the CUDA card; ``REPRO_TORCH_DEVICE=cpu`` asks for the
CPU.  Scope, as in the reference: the replicated policy (every worker is
one dp replica).  Sharded (FSDP-within-pod) worlds hand off through
``core.elastic.handoff_state`` at pod granularity, but pod-granular
membership in the driver is future work in the reference, and elasticity
of a rank world is not in the reference.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from repro_torch.core import faults as faults_mod
from repro_torch.core import health as health_mod
from repro_torch.core import plan as plan_mod
from repro_torch.core import tree as tr
from repro_torch.core.elastic import (MembershipController, diff_topology,
                                      handoff_state, largest_pow2,
                                      regrow_replica_state)
from repro_torch.core.faults import FaultSchedule
from repro_torch.core.health import DetectorConfig, FailureDetector
from repro_torch.core.staleness import SkipLedger
from repro_torch.launch.train import Trainer

# the schedule chaos_demo plays: a hang at t=2 that wakes 3 steps later,
# a crash at t=8 that rejoins 3 steps later
CHAOS_SCHEDULE = FaultSchedule.of(
    faults_mod.hang(1, 2, recover_after=3),
    faults_mod.crash(3, 8, rejoin_after=3),
)

# bytes of a leaf that one worker of state_digest hashes at once
DIGEST_CHUNK = 1 << 28


def _rows_identical(params) -> bool:
    """True iff every stacked leaf's replica rows are bitwise identical,
    compared on the leaves' own device."""
    for leaf in tr.tree_leaves(params):
        rest = leaf[1:]
        if rest.shape[0] and not torch.equal(rest, leaf[:1].expand_as(rest)):
            return False
    return True


def _require(ok: bool, message: str) -> None:
    """A protocol check: raises AssertionError (kept under ``python -O``)."""
    if not ok:
        raise AssertionError(message)


def _chunk_digest(chunk: torch.Tensor) -> bytes:
    return hashlib.sha256(chunk.cpu().numpy()).digest()


def state_digest(state) -> str:
    """SHA-256 over the SHA-256 of every ``DIGEST_CHUNK``-byte chunk of
    every replica-state leaf (params, optimiser leaves, then step and
    phase), in leaf order.  The chunks cross to the host and are hashed
    on a thread pool (``hashlib`` releases the interpreter lock), so the
    ~19 GB of an 8-row state hash in parallel; two bit-identical states
    give equal digests, and any flipped bit a different one."""
    leaves = tr.tree_leaves((state.params, state.opt_state)) + [
        torch.tensor([state.step, state.phase], dtype=torch.int64)]
    chunks = []
    for leaf in leaves:
        flat = leaf.detach().contiguous().reshape(-1).view(torch.uint8)
        chunks += [flat[i:i + DIGEST_CHUNK]
                   for i in range(0, flat.numel(), DIGEST_CHUNK)] or [flat]
    with ThreadPoolExecutor(max_workers=os.cpu_count() or 1) as pool:
        parts = list(pool.map(_chunk_digest, chunks))
    return hashlib.sha256(b"".join(parts)).hexdigest()


class ElasticTrainer:
    """Drive WAGMA training across membership changes, restart-free.

    ``pool`` is the number of workers; controller worker ``w`` is a
    replica row, and the active world's workers are the rows of one
    stacked ``Trainer`` on ``device``, in world rank order.
    ``group_size`` is clamped to the current world (a shrink below S
    would otherwise make the butterfly impossible).  ``init_state`` (a
    ``ReplicaState`` of the first world's rows, e.g. converted from a
    JAX run) seats the first world; later worlds are seated from their
    predecessor's rows.
    """

    def __init__(self, cfg, pool: int, *, device=None, tau: int = 4,
                 group_size=None, min_world: int = 2, seed: int = 0,
                 init_state=None, **trainer_kw):
        if trainer_kw.get("sharding") not in (None, "replicated"):
            raise NotImplementedError(
                "ElasticTrainer drives the replicated policy; sharded "
                "worlds convert through core.elastic.handoff_state at pod "
                "granularity, but pod-granular membership in the driver "
                "is not in the reference either (future work there, and "
                "no part of slice 7c)")
        world = trainer_kw.get("world")
        if world is not None:
            raise NotImplementedError(
                "ElasticTrainer drives the replicas of one process; "
                "elasticity of a rank world"
                + (" with a model axis" if world.model > 1 else "")
                + " is not in the reference")
        if trainer_kw.pop("averager", "wagma") != "wagma":
            raise NotImplementedError("elastic membership needs the "
                                      "tau-sync barrier (wagma averager)")
        self.cfg = cfg
        self.pool = int(pool)
        self.device = torch.device(device or "cuda")
        self.tau = int(tau)
        self.group_size = group_size
        self.seed = seed
        self.trainer_kw = trainer_kw
        self.controller = MembershipController(range(self.pool),
                                               min_world=min_world)
        self.epoch_log: list = []
        self.trainer: Trainer = None
        self._build(init_state)

    # -- world (re)construction ------------------------------------------

    def _S(self, world_size: int):
        if self.group_size is None:
            return None
        return max(2, min(int(self.group_size), world_size))

    def _build(self, init_state) -> None:
        world = self.controller.membership.active
        self.trainer = Trainer(self.cfg, len(world), device=self.device,
                               averager="wagma",
                               group_size=self._S(len(world)), tau=self.tau,
                               seed=self.seed, init_state=init_state,
                               **self.trainer_kw)

    def _transition(self, ev) -> None:
        """Re-seat state on the new world and recompile the plan: a shrink
        hands the kept rows over (:func:`handoff_state`), a regrow seats
        the joiners on row 0, the post-sync consensus
        (:func:`regrow_replica_state`)."""
        old_topo = self.trainer.averager.topology
        consensus = _rows_identical(self.trainer.state.params)
        if ev.kind == "regrow":
            if not consensus:
                raise AssertionError(
                    "regrow outside the tau-sync barrier: survivor rows are "
                    "not the post-sync consensus")
            state = regrow_replica_state(self.trainer.state, len(ev.world))
        else:
            state = handoff_state(self.trainer.state, ev.keep_rows,
                                  old_plan=self.trainer.plan())
        # the old world's rows go before the new world's first step, even
        # if something still holds the old Trainer
        old, self.trainer = self.trainer, None
        old.state = None
        del old
        self._build(state)
        diff = diff_topology(old_topo, self.trainer.averager.topology)
        evicted = plan_mod.evict_topology(old_topo)
        self.epoch_log.append({
            "epoch": ev.epoch, "kind": ev.kind, "world": list(ev.world),
            "topology_diff": diff.describe(), "plans_evicted": evicted,
            "consensus_at_transition": consensus,
        })

    # -- membership events -----------------------------------------------

    def leave(self, worker: int):
        """Worker died; shrink the world now (it blocks every collective)."""
        ev = self.controller.leave(worker)
        if ev.kind == "shrink":
            self._transition(ev)
        return ev

    def join(self, worker: int):
        """Announce a (re)joining worker; promoted at the next tau-sync."""
        return self.controller.join(worker)

    def _maybe_regrow(self):
        """The tau-sync barrier: promote spares/joiners onto the consensus."""
        ev = self.controller.at_sync_barrier()
        if ev.kind == "regrow":
            self._transition(ev)
        return ev

    # -- driving ---------------------------------------------------------

    @property
    def world_size(self) -> int:
        return self.controller.membership.world_size

    def run(self, steps: int, events=None, log_every: int = 0, step=None):
        """Train ``steps`` global steps, applying scheduled churn.

        ``events`` maps global step t -> iterable of ``("leave", w)`` /
        ``("join", w)`` applied *before* step t runs.  ``step(trainer,
        t)``, if given, runs step t in place of ``trainer.step_once(t)``
        and returns its loss (a probe that reads each step's launches and
        time).  Returns one record per step: ``{"t", "loss", "world",
        "epoch"}``.
        """
        events = events or {}
        records = []
        for t in range(steps):
            for kind, w in events.get(t, ()):
                if kind == "leave":
                    self.leave(w)
                elif kind == "join":
                    self.join(w)
                else:
                    raise ValueError(f"unknown event {kind!r}")
            sync = self.trainer.averager.sync_due(t)
            loss = (self.trainer.step_once(t) if step is None
                    else step(self.trainer, t))
            records.append({"t": t, "loss": loss,
                            "world": self.world_size,
                            "epoch": self.controller.epoch})
            if log_every and (t % log_every == 0 or t == steps - 1):
                print(f"step {t:4d} loss {loss:.4f} world "
                      f"{self.world_size} epoch {self.controller.epoch}"
                      + (" [sync]" if sync else ""), flush=True)
            if sync:
                self._maybe_regrow()
        return records

    # -- chaos mode ------------------------------------------------------

    def state_digest(self) -> str:
        """:func:`state_digest` of the current world's state: two runs
        with bit-identical state produce equal digests."""
        return state_digest(self.trainer.state)

    def run_under_faults(self, steps: int, schedule: FaultSchedule, *,
                         detector: DetectorConfig = None,
                         step_time_s: float = 0.1,
                         collective_deadline_s: float = 0.05,
                         log_every: int = 0, step=None) -> dict:
        """Train under a fault schedule with detector-driven membership.

        Unlike :meth:`run`, nothing here is scripted: the schedule only
        controls *when workers fall silent* on the virtual clock
        (``now = t * step_time_s``).  Each round, live workers heartbeat,
        the detector is polled at the round's collective deadline
        (``now + collective_deadline_s``), and its verdicts drive the
        membership — suspect -> immediate shrink to the survivors'
        quantised world, recovery -> join promoted at the tau-sync
        barrier, confirm -> permanent death.  Every round a shrunk-away
        worker misses is charged to the `SkipLedger`, which raises
        `StalenessBoundExceeded` past ``max_staleness_bound(tau)``.

        ``step`` is :meth:`run`'s.  Because no wall time is ever read,
        replaying the same schedule is bit-identical.  Returns ``{"records", "events", "staleness",
        "schedule_fingerprint", "state_digest"}``; the structured event
        log (kinds: hang/crash/delay onset, wake, recover, suspect,
        confirm-dead, shrink, regrow, stale-verdict-rejected) also stays
        on ``self.event_log``.
        """
        det = FailureDetector(range(self.pool), detector,
                              epoch=self.controller.epoch)
        ledger = SkipLedger(tau=self.tau)
        self.event_log: list = []
        down = {}           # worker -> FaultEvent currently silencing it
        busy_until = {}     # worker -> virtual time its delayed round ends
        pending_beats = []  # (deliver_time, worker) — delayed heartbeats
        out_since = {}      # worker -> step it was shrunk away at
        records = []

        def log(kind, worker, t, now, **extra):
            e = {"kind": kind, "worker": worker, "step": t,
                 "wall": round(now, 6), "epoch": self.controller.epoch}
            e.update(extra)
            self.event_log.append(e)

        def on_beat(verdict, t, now):
            # a recovered worker announces a (re)join; the barrier promotes
            if verdict is None or verdict.state != health_mod.RECOVERED:
                return
            log("recover", verdict.worker, t, now,
                silent_s=round(verdict.silent_s, 6))
            if verdict.worker not in self.controller.membership.active:
                self.join(verdict.worker)

        for t in range(steps):
            now = t * step_time_s
            # 1. faults scheduled at t take effect before the round
            for fev in schedule.at(t):
                if fev.kind == faults_mod.DELAY:
                    done = now + fev.ms / 1e3
                    busy_until[fev.worker] = max(
                        busy_until.get(fev.worker, 0.0), done)
                    pending_beats.append((done, fev.worker))
                    log("delay", fev.worker, t, now, ms=fev.ms)
                else:  # hang / crash: silence until `until` (maybe forever)
                    down[fev.worker] = fev
                    log(fev.kind, fev.worker, t, now, until=fev.until)
            # 2. hangs/crashes whose recovery step arrived wake up
            for w, fev in list(down.items()):
                if fev.until is not None and t >= fev.until:
                    del down[w]
                    log("wake", w, t, now)
            # 3. heartbeats: matured delayed beats, then on-time beats
            for bt, w in sorted(pending_beats):
                if bt <= now and w not in down:
                    on_beat(det.heartbeat(w, bt), t, now)
            pending_beats = [(bt, w) for bt, w in pending_beats
                             if bt > now and w not in down]
            for w in range(self.pool):
                if w in down or busy_until.get(w, 0.0) > now:
                    continue
                on_beat(det.heartbeat(w, now), t, now)
            # 4. the round's collective deadline turns silence into verdicts
            for v in det.poll(now + collective_deadline_s):
                if v.epoch != self.controller.epoch:
                    # a verdict raised earlier in this same poll batch,
                    # just before a shrink bumped the epoch: the detector
                    # state is still current, so re-stamp rather than
                    # reject (the stale-epoch guard is for verdicts held
                    # across topologies, not batch-mates)
                    v = dataclasses.replace(v, epoch=self.controller.epoch)
                if v.state == health_mod.SUSPECT:
                    log("suspect", v.worker, t, now,
                        silent_s=round(v.silent_s, 6),
                        timeout_s=round(det.suspect_timeout(v.worker), 6))
                elif v.state == health_mod.DEAD:
                    log("confirm-dead", v.worker, t, now,
                        silent_s=round(v.silent_s, 6))
                ev = self.controller.apply_verdict(v)
                if ev.kind == "shrink":
                    self._transition(ev)
                    det.set_epoch(self.controller.epoch)
                    out_since[v.worker] = t
                    log("shrink", v.worker, t, now, world=list(ev.world))
                elif ev.kind == "rejected-stale-epoch":
                    log("stale-verdict-rejected", v.worker, t, now,
                        verdict_epoch=v.epoch)
                if v.state == health_mod.DEAD:
                    # permanent: no future contribution to age
                    ledger.drop(v.worker)
                    out_since.pop(v.worker, None)
            # 5. staleness: every shrunk-away survivor misses this round
            for w in sorted(out_since):
                ledger.charge(w, t)
            # 6. run the round on the (possibly downgraded) world
            sync = self.trainer.averager.sync_due(t)
            loss = (self.trainer.step_once(t) if step is None
                    else step(self.trainer, t))
            records.append({"t": t, "loss": loss, "world": self.world_size,
                            "epoch": self.controller.epoch,
                            "max_skip_age": ledger.max_age()})
            if log_every and (t % log_every == 0 or t == steps - 1):
                print(f"step {t:4d} loss {loss:.4f} world "
                      f"{self.world_size} epoch {self.controller.epoch} "
                      f"skip-age {ledger.max_age()}"
                      + (" [sync]" if sync else ""), flush=True)
            # 7. tau-sync barrier: promote recovered workers onto consensus
            if sync:
                prev = set(self.controller.membership.active)
                ev = self._maybe_regrow()
                if ev.kind == "regrow":
                    det.set_epoch(self.controller.epoch)
                    for w in ev.world:
                        if w not in prev:
                            ledger.reset(w)
                            out_since.pop(w, None)
                            log("regrow", w, t, now, world=list(ev.world))
        return {"records": records, "events": list(self.event_log),
                "staleness": ledger.snapshot(),
                "schedule_fingerprint": schedule.fingerprint(),
                "state_digest": self.state_digest()}


def kill_rejoin_events(leave_step: int = 2, leave_worker: int = 2) -> dict:
    """:func:`kill_rejoin_demo`'s script: at ``leave_step`` the worker
    leaves and at once announces its rejoin."""
    return {leave_step: [("leave", leave_worker), ("join", leave_worker)]}


def check_kill_rejoin(et: ElasticTrainer, records, *, steps: int,
                      leave_step: int) -> dict:
    """The kill/rejoin protocol's acceptance rules on a finished run of
    :func:`kill_rejoin_events` (raises AssertionError on a violation);
    returns the report."""
    tau, world = et.tau, et.pool
    losses = [r["loss"] for r in records]
    _require(len(records) == steps and np.isfinite(losses).all(),
             "training did not continue across the membership changes")
    shrunk = max(2, largest_pow2(world - 1))
    mid = [r["world"] for r in records
           if leave_step <= r["t"] < ((leave_step // tau) + 1) * tau]
    _require(bool(mid) and all(w == shrunk for w in mid),
             f"expected the shrunken world {shrunk} between leave and "
             f"barrier, got {mid}")
    m = et.controller.membership
    _require(m.world_size == world and not m.spares and not m.pending,
             f"world did not regrow: {m}")
    _require(m.epoch == 2, f"expected epochs shrink+regrow, got {m.epoch}")
    kinds = [e["kind"] for e in et.epoch_log]
    _require(kinds == ["shrink", "regrow"], str(kinds))
    _require(all(e["plans_evicted"] >= 1 for e in et.epoch_log),
             "dropped topologies left plan-cache entries behind")
    _require(et.epoch_log[1]["consensus_at_transition"],
             "rejoin barrier was not a consensus point")
    # THE acceptance criterion: at the first post-rejoin tau-sync (the
    # final step), the rejoined worker's replica row is bit-identical to
    # every survivor's
    bit_identical = _rows_identical(et.trainer.state.params)
    _require(bit_identical, "post-rejoin tau-sync left replica rows "
                            "divergent")
    return {"arch": et.cfg.name, "steps": steps, "tau": tau, "world": world,
            "leave_step": leave_step, "history": records,
            "epoch_log": et.epoch_log, "rejoin_bit_identical": bit_identical,
            "final_loss": losses[-1]}


def check_chaos(et: ElasticTrainer, rep: dict, *, steps: int) -> dict:
    """:func:`chaos_demo`'s acceptance rules on a finished
    ``run_under_faults`` of :data:`CHAOS_SCHEDULE` (raises AssertionError
    on a violation); returns the report, completed."""
    losses = [r["loss"] for r in rep["records"]]
    _require(len(losses) == steps and np.isfinite(losses).all(),
             "survivor world did not keep training through the faults")
    kinds = [e["kind"] for e in rep["events"]]
    for needed in ("hang", "crash", "suspect", "shrink", "recover",
                   "wake", "regrow"):
        _require(needed in kinds, f"missing {needed!r} events: {kinds}")
    m = et.controller.membership
    _require(m.world_size == et.pool and not m.spares and not m.pending,
             f"world did not regrow after the faults: {m}")
    _require([e["kind"] for e in et.epoch_log]
             == ["shrink", "regrow", "shrink", "regrow"], str(et.epoch_log))
    stale = rep["staleness"]
    _require(bool(stale["total_skipped"]) and not stale["ages"],
             f"skipped contributions not visible / not settled: {stale}")
    _require(1 <= stale["peak_age"] <= et.tau, str(stale))
    _require(_rows_identical(et.trainer.state.params),
             "rejoiners not bit-identical to survivors at the tau-sync")
    rep.update(arch=et.cfg.name, steps=steps, tau=et.tau, world=et.pool,
               final_loss=losses[-1], epoch_log=et.epoch_log)
    return rep


def kill_rejoin_demo(*, arch: str = "qwen3-0.6b", steps: int = 8,
                     tau: int = 4, group_size: int = 2, world: int = 4,
                     leave_step: int = 2, leave_worker: int = 2,
                     learning_rate: float = 0.05, seed: int = 0,
                     log_every: int = 1, device=None) -> dict:
    """Scripted kill/rejoin scenario on the smoke config; asserts the
    protocol.

    Timeline (defaults, tau=4): steps 0..1 on the full world; at t=2
    worker ``leave_worker`` is killed and immediately announces its
    rejoin -> the world shrinks to ``largest_pow2(world-1)`` (one healthy
    survivor is demoted to spare) and training continues; the t=3
    tau-sync is the rejoin barrier -> the spare and the returned worker
    adopt the post-sync consensus and the world regrows; the final step
    (``steps-1``, a tau-sync) pins the acceptance criterion: every
    replica row — the rejoiner's included — is **bit-identical** to the
    survivors'.

    Raises AssertionError on any protocol violation; returns the report
    dict otherwise.
    """
    from repro_torch.configs import get_config

    _require(steps % tau == 0, "the last step must be a tau-sync")
    _require(leave_step < steps and leave_step % tau != tau - 1,
             "the leave must fall before the last step, off a sync")
    cfg = get_config(arch, smoke=True)
    et = ElasticTrainer(cfg, world, device=device, tau=tau,
                        group_size=group_size, seed=seed,
                        learning_rate=learning_rate)
    records = et.run(steps, events=kill_rejoin_events(leave_step,
                                                      leave_worker),
                     log_every=log_every)
    rep = check_kill_rejoin(et, records, steps=steps, leave_step=leave_step)
    rep["leave_worker"] = leave_worker
    return rep


def chaos_demo(*, arch: str = "qwen3-0.6b", steps: int = 12, tau: int = 4,
               group_size: int = 2, world: int = 8,
               learning_rate: float = 0.05, seed: int = 0,
               log_every: int = 1, device=None) -> dict:
    """Chaos smoke: one hang + one crash/rejoin over a pool of 8 rows.

    Nothing is scripted — :data:`CHAOS_SCHEDULE` only silences workers;
    the failure detector does the rest.  Expected timeline with the
    default timeouts (suspect 0.25 s, confirm 0.30 s, 0.1 s virtual
    rounds): the hung worker is suspected ~2.5 silent rounds in -> world
    8 -> 4 without a restart; its recovery heartbeat announces a rejoin
    promoted at the t=7 tau-sync (8 again, skipped rounds charged up to
    exactly ``max_staleness_bound(tau)``); the crashed worker repeats the
    cycle through the t=11 barrier.  Asserts survivor convergence,
    detector-driven epochs, staleness accounting, and the bit-identical
    rejoin; raises AssertionError otherwise.
    """
    from repro_torch.configs import get_config

    cfg = get_config(arch, smoke=True)
    et = ElasticTrainer(cfg, world, device=device, tau=tau,
                        group_size=group_size, seed=seed,
                        learning_rate=learning_rate)
    rep = et.run_under_faults(steps, CHAOS_SCHEDULE, log_every=log_every)
    return check_chaos(et, rep, steps=steps)


def main() -> int:
    ap = argparse.ArgumentParser(
        description="elastic kill/rejoin smoke over replica rows of one "
                    "device (REPRO_TORCH_DEVICE=cpu for the CPU)")
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--tau", type=int, default=4)
    ap.add_argument("--group-size", type=int, default=2)
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--leave-step", type=int, default=2)
    ap.add_argument("--leave-worker", type=int, default=2)
    ap.add_argument("--chaos", action="store_true",
                    help="run the detector-driven chaos smoke instead of "
                         "the scripted kill/rejoin scenario")
    args = ap.parse_args()
    device = os.environ.get("REPRO_TORCH_DEVICE", "cuda")
    if args.chaos:
        try:
            rep = chaos_demo(arch=args.arch, tau=args.tau,
                             group_size=args.group_size, device=device)
        except (AssertionError, RuntimeError) as e:
            print(f"CHAOS-DEMO FAIL {e}")
            return 1
        for e in rep["events"]:
            print(f"  t={e['step']:3d} wall={e['wall']:.2f}s epoch "
                  f"{e['epoch']} {e['kind']:22s} worker {e['worker']}")
        skipped = sum(rep["staleness"]["total_skipped"].values())
        print(f"CHAOS-DEMO PASS schedule {rep['schedule_fingerprint']}: "
              f"hang + crash/rejoin detected (no scripts), world "
              f"{rep['world']} -> {min(r['world'] for r in rep['records'])}"
              f" -> {rep['world']}, {skipped} skipped contributions "
              f"(peak staleness {rep['staleness']['peak_age']} <= tau="
              f"{rep['tau']}), rejoiners bit-identical, final loss "
              f"{rep['final_loss']:.4f}")
        return 0
    try:
        rep = kill_rejoin_demo(arch=args.arch, steps=args.steps,
                               tau=args.tau, group_size=args.group_size,
                               world=args.world, leave_step=args.leave_step,
                               leave_worker=args.leave_worker, device=device)
    except (AssertionError, RuntimeError) as e:
        print(f"ELASTIC-DEMO FAIL {e}")
        return 1
    for e in rep["epoch_log"]:
        print(f"epoch {e['epoch']} {e['kind']:6s} world {e['world']} "
              f"({e['topology_diff']}; {e['plans_evicted']} plans evicted)")
    print(f"ELASTIC-DEMO PASS world {rep['world']} -> "
          f"{min(r['world'] for r in rep['history'])} -> {rep['world']}, "
          f"rejoiner bit-identical at the post-rejoin tau-sync, final "
          f"loss {rep['final_loss']:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
