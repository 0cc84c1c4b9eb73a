"""Deterministic, seeded fault injection.

Counterpart of ``repro/core/faults.py`` (host-side, numpy only).  A
`FaultSchedule` is a frozen, sorted list of `FaultEvent`s (delay / hang /
crash entries keyed on (step, worker)), so the *same* schedule replays
bit-identically.  Schedules are shared with the JAX package: the same
events give the same ``fingerprint`` (crc32 over the same text) and the
same ``straggler_trace`` (numpy's seeded generator).  Two runtimes
consume a schedule:

* `ElasticTrainer.run_under_faults` (``launch/elastic.py``) plays the
  schedule against a **virtual** clock: faulty workers stop
  heartbeating, the `core.health` detector turns the silence into
  verdicts, and membership reacts.  No wall time is read, so replay
  determinism is exact.
* `FaultInjector` hooks a plain `Trainer.step_once` with **real**
  effects for one designated worker identity: delays sleep wall-clock
  (the paper's §V-B straggler experiment), crashes raise `InjectedCrash`
  mid-run (what the atomic-checkpoint tests use to die between write
  and rename).

`FaultSchedule.straggler_trace` reproduces the paper's §V-B trace:
every step, a seeded choice of `n_stragglers` workers is delayed by
320 ms.
"""
from __future__ import annotations

import time
import zlib
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

DELAY = "delay"
HANG = "hang"
CRASH = "crash"
_KINDS = (DELAY, HANG, CRASH)


class InjectedFault(RuntimeError):
    """Base class for faults raised by the wall-clock injector."""


class InjectedCrash(InjectedFault):
    """The scheduled crash of this worker process."""


class InjectedHang(InjectedFault):
    """A scheduled hang, surfaced as an exception once the watchdog gives
    up (a single process cannot usefully block forever)."""


@dataclass(frozen=True, order=True)
class FaultEvent:
    """One scheduled fault.

    ``until`` is the step at which a hang recovers / a crash rejoins
    (None = never); ``ms`` is the delay duration for DELAY events.
    """
    step: int
    worker: int
    kind: str
    ms: float = 0.0
    until: Optional[int] = None

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.kind == DELAY and self.ms <= 0:
            raise ValueError("delay needs ms > 0")
        if self.until is not None and self.until <= self.step:
            raise ValueError("recovery must be strictly after the fault")


def delay(worker: int, step: int, ms: float) -> FaultEvent:
    """Worker finishes its round ``ms`` late (a §V-B straggler)."""
    return FaultEvent(int(step), int(worker), DELAY, ms=float(ms))


def hang(worker: int, step: int, recover_after: Optional[int] = None
         ) -> FaultEvent:
    """Worker goes silent at ``step``; optionally wakes, state intact,
    ``recover_after`` steps later."""
    until = None if recover_after is None else int(step) + int(recover_after)
    return FaultEvent(int(step), int(worker), HANG, until=until)


def crash(worker: int, step: int, rejoin_after: Optional[int] = None
          ) -> FaultEvent:
    """Worker dies at ``step``, losing state; optionally rejoins (as a
    fresh joiner adopting consensus) ``rejoin_after`` steps later."""
    until = None if rejoin_after is None else int(step) + int(rejoin_after)
    return FaultEvent(int(step), int(worker), CRASH, until=until)


class FaultSchedule:
    """An immutable, deterministically ordered set of fault events."""

    def __init__(self, events: Iterable[FaultEvent] = ()):
        self.events: Tuple[FaultEvent, ...] = tuple(sorted(events))
        self._by_step: Dict[int, List[FaultEvent]] = {}
        for ev in self.events:
            self._by_step.setdefault(ev.step, []).append(ev)

    @classmethod
    def of(cls, *events: FaultEvent) -> "FaultSchedule":
        return cls(events)

    @classmethod
    def straggler_trace(cls, P: int, steps: int, *, ms: float = 320.0,
                        n_stragglers: int = 2, seed: int = 0
                        ) -> "FaultSchedule":
        """The paper's §V-B trace: each step, ``n_stragglers`` distinct
        seeded workers run ``ms`` late.  Same (P, steps, seed) ->
        bit-identical schedule."""
        rng = np.random.default_rng(seed)
        evs = []
        for t in range(steps):
            for w in rng.choice(P, size=min(n_stragglers, P), replace=False):
                evs.append(delay(int(w), t, ms))
        return cls(evs)

    def at(self, step: int) -> Tuple[FaultEvent, ...]:
        return tuple(self._by_step.get(step, ()))

    def delays_at(self, step: int) -> Dict[int, float]:
        """worker -> delay seconds taking effect at ``step``."""
        return {ev.worker: ev.ms / 1e3 for ev in self.at(step)
                if ev.kind == DELAY}

    @property
    def max_step(self) -> int:
        return max((ev.step for ev in self.events), default=-1)

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    def fingerprint(self) -> str:
        """Stable content hash — equal schedules replay identically, so
        equal fingerprints promise bit-identical chaos runs."""
        text = ";".join(f"{e.step}:{e.worker}:{e.kind}:{e.ms}:{e.until}"
                        for e in self.events)
        return f"{zlib.crc32(text.encode()):08x}"

    def __repr__(self) -> str:
        return (f"FaultSchedule({len(self.events)} events, "
                f"fingerprint={self.fingerprint()})")


class FaultInjector:
    """Wall-clock runtime for one worker identity, hooked into
    ``Trainer.step_once`` (``Trainer(..., fault_injector=...)``).

    ``before_step(t)`` applies the schedule's entries for this worker:
    DELAY sleeps, CRASH raises `InjectedCrash`, HANG sleeps
    ``hang_grace_s`` then raises `InjectedHang` (the single-process
    stand-in for "the watchdog deadline expired on a hung worker").
    """

    def __init__(self, schedule: FaultSchedule, worker: int = 0, *,
                 time_scale: float = 1.0, hang_grace_s: float = 0.05,
                 sleep=time.sleep):
        self.schedule = schedule
        self.worker = int(worker)
        self.time_scale = float(time_scale)
        self.hang_grace_s = float(hang_grace_s)
        self._sleep = sleep
        self.delayed_ms = 0.0   # total injected delay, for logs

    def before_step(self, t: int) -> None:
        for ev in self.schedule.at(t):
            if ev.worker != self.worker:
                continue
            if ev.kind == DELAY:
                self.delayed_ms += ev.ms
                self._sleep(ev.ms / 1e3 * self.time_scale)
            elif ev.kind == CRASH:
                raise InjectedCrash(
                    f"worker {self.worker} crashed at step {t}")
            elif ev.kind == HANG:
                self._sleep(self.hang_grace_s * self.time_scale)
                raise InjectedHang(
                    f"worker {self.worker} hung at step {t}")
