"""Heartbeat failure detection for elastic training (``launch/elastic.py``).

Counterpart of ``repro/core/health.py`` (host-side, no tensor).  Each
worker is expected to heartbeat once per averaging round, and a
deadline-based detector turns silence into membership verdicts:

    ALIVE --silent past suspect timeout--> SUSPECT --still silent past
    confirm timeout--> DEAD

A SUSPECT verdict downgrades the round to the survivors' quantised
world (``ElasticTrainer`` feeds it to
``MembershipController.apply_verdict``);
a DEAD verdict makes the departure permanent (the worker's staleness
ledger entry is dropped, a later rejoin is treated as a fresh join).
A heartbeat from a SUSPECT/DEAD worker yields a RECOVERED verdict and
counts as a *flap*: the worker's suspect timeout backs off
multiplicatively so a flapping worker stops churning the membership.

Verdicts are **epoch-stamped**: every verdict carries the membership
epoch it was raised under, and ``MembershipController.apply_verdict``
rejects verdicts from a dead epoch: by the time a stale verdict lands,
the topology it indicts has been evicted from the plan cache and its row
assignment means nothing in the current world.

The detector is driven entirely by an explicit clock (``now`` floats in
seconds), never ``time.time()``: under ``run_under_faults`` the clock is
virtual (step * step_time_s), which is what makes a replayed
`FaultSchedule` bit-identical.  The arithmetic on that clock is the JAX
package's expression for expression, so both packages raise the same
verdicts at the same rounds.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

ALIVE = "alive"
SUSPECT = "suspect"
DEAD = "dead"
RECOVERED = "recovered"


@dataclass(frozen=True)
class DetectorConfig:
    """Timeouts (seconds of detector clock) and the flap backoff."""
    suspect_timeout_s: float = 0.25   # silence before ALIVE -> SUSPECT
    confirm_timeout_s: float = 0.30   # further silence before SUSPECT -> DEAD
    backoff: float = 2.0              # suspect timeout multiplier per flap
    max_backoff: float = 8.0          # cap on the accumulated multiplier

    def __post_init__(self):
        if self.suspect_timeout_s <= 0 or self.confirm_timeout_s <= 0:
            raise ValueError("timeouts must be positive")
        if self.backoff < 1.0:
            raise ValueError("backoff must be >= 1")


@dataclass(frozen=True)
class Verdict:
    """A detector state transition, stamped with the membership epoch."""
    worker: int
    state: str        # SUSPECT | DEAD | RECOVERED
    epoch: int        # membership epoch the verdict was raised under
    at: float         # detector clock when the transition fired
    silent_s: float   # observed silence at that moment


@dataclass
class HeartbeatRecord:
    last_beat: float
    state: str = ALIVE
    suspected_at: Optional[float] = None
    flaps: int = 0    # SUSPECT/DEAD -> RECOVERED cycles; drives the backoff


class FailureDetector:
    """Deadline-based failure detector over an explicit clock.

    ``heartbeat(worker, now)`` records liveness (and reports recovery);
    ``poll(deadline)`` is called once per averaging round with the
    round's collective deadline and returns every state transition the
    silence implies at that instant.
    """

    def __init__(self, workers: Sequence[int],
                 config: Optional[DetectorConfig] = None, *,
                 epoch: int = 0, now: float = 0.0):
        self.config = config or DetectorConfig()
        self.epoch = int(epoch)
        self.records: Dict[int, HeartbeatRecord] = {
            int(w): HeartbeatRecord(last_beat=float(now)) for w in workers}

    # -- bookkeeping ------------------------------------------------------
    def set_epoch(self, epoch: int) -> None:
        """Re-stamp after a membership transition; later verdicts carry it."""
        self.epoch = int(epoch)

    def state(self, worker: int) -> str:
        return self.records[worker].state

    def suspect_timeout(self, worker: int) -> float:
        """Per-worker suspect deadline: base timeout x capped flap backoff."""
        rec = self.records[worker]
        mult = min(self.config.backoff ** rec.flaps, self.config.max_backoff)
        return self.config.suspect_timeout_s * mult

    # -- events -----------------------------------------------------------
    def heartbeat(self, worker: int, now: float) -> Optional[Verdict]:
        """Record a beat; returns a RECOVERED verdict if the worker was out.

        Recovery from SUSPECT (or DEAD, i.e. a rejoin announce) counts as
        a flap and raises this worker's future suspect timeout.
        """
        rec = self.records.get(worker)
        if rec is None:  # unseen worker announcing itself
            rec = self.records[worker] = HeartbeatRecord(last_beat=float(now))
            return None
        silent = float(now) - rec.last_beat
        rec.last_beat = max(rec.last_beat, float(now))
        if rec.state == ALIVE:
            return None
        rec.state = ALIVE
        rec.suspected_at = None
        rec.flaps += 1
        return Verdict(worker, RECOVERED, self.epoch, float(now), silent)

    def poll(self, deadline: float) -> List[Verdict]:
        """Evaluate every worker's silence at the round's deadline."""
        out: List[Verdict] = []
        for w in sorted(self.records):
            rec = self.records[w]
            if rec.state == DEAD:
                continue
            silent = float(deadline) - rec.last_beat
            if rec.state == ALIVE and silent > self.suspect_timeout(w):
                rec.state = SUSPECT
                rec.suspected_at = float(deadline)
                out.append(Verdict(w, SUSPECT, self.epoch, float(deadline),
                                   silent))
            elif (rec.state == SUSPECT
                  and float(deadline) - rec.suspected_at
                  > self.config.confirm_timeout_s):
                rec.state = DEAD
                out.append(Verdict(w, DEAD, self.epoch, float(deadline),
                                   silent))
        return out
