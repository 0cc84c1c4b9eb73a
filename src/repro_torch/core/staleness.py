"""Functional simulator of WAGMA-SGD's wait-avoidance semantics (Alg. 2
lines 8-17), counterpart of ``repro/core/staleness.py``.

Replicas that run in lock-step, as the rows of one state do, never wait
for one another, so the *activation/staleness* half of the paper cannot
occur on the training path.  This module simulates it on stacked
``(P, ...)`` trees so that the paper's accuracy claim under injected
stragglers (paper §V-B, Fig. 5) can be reproduced:

* every worker keeps a *send buffer* holding the last local model it
  completed (paper Fig. 3);
* when the group allreduce of iteration t triggers, on-time workers
  contribute the fresh ``W'_t`` while stragglers passively contribute their
  (stale) buffer;
* a straggler that finishes during iteration t merges late:
  ``W_{t+1} = (W_sum + W'_t) / (S+1)``  (Alg. 2 line 13);
* a worker so slow it does not finish at all keeps computing — its buffer
  ages by one iteration (bounded-staleness growth, theory Assumption 3);
* every tau iterations a global synchronous allreduce forces consistency
  (Alg. 2 line 16), resetting all staleness to zero.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import group_allreduce
from repro_torch.core import tree as tr


class SimState(NamedTuple):
    """Stacked per-worker state. All tree leaves have leading dim P."""
    models: object        # W_t^i        — current working model
    buffers: object       # send buffer  — last *completed* local model W'
    age: torch.Tensor     # (P,) int32   — staleness of each buffer, iterations
    step: torch.Tensor    # ()  int32    — global iteration t


def _copy(tree):
    return tr.tree_map(lambda a: a.clone(), tree)


def init_state(stacked_params) -> SimState:
    leaf = tr.tree_leaves(stacked_params)[0]
    return SimState(
        models=stacked_params,
        buffers=_copy(stacked_params),
        age=torch.zeros((leaf.shape[0],), dtype=torch.int32,
                        device=leaf.device),
        step=torch.zeros((), dtype=torch.int32, device=leaf.device),
    )


def _where_workers(mask, a, b):
    """Select per-worker between two stacked trees with a (P,) bool mask."""
    def sel(x, y):
        m = mask.to(x.device).reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.where(m, x, y)
    return tr.tree_map(sel, a, b)


def wagma_sim_step(state: SimState, local_update: Callable, *, P: int, S: int,
                   tau: int, ready: torch.Tensor, completes: torch.Tensor,
                   t: int) -> SimState:
    """One simulated WAGMA-SGD iteration.

    Args:
      local_update: stacked-models -> stacked proposed W' (applies the local
        SGD/optimiser step per worker on its own shard of data).
      ready:     (P,) bool — finished *before* the group collective triggered;
                 contributes fresh W' (Alg. 2 line 10-11).
      completes: (P,) bool — finishes its local step within iteration t at all.
                 ready implies completes. Late-but-completing workers merge via
                 line 13; non-completing workers keep computing (buffer ages).
      t: python int iteration (selects the dynamic group pattern).
    """
    ready = torch.logical_and(ready, completes)
    Wprime = local_update(state.models)

    sync_now = (t + 1) % tau == 0
    if sync_now:
        # Global barrier: everyone is forced to finish and contribute (line 16).
        avg = group_allreduce.global_average_stacked(Wprime, P=P)
        return SimState(models=avg, buffers=_copy(Wprime),
                        age=torch.zeros_like(state.age),
                        step=state.step + 1)

    # Contribution: fresh if ready, else the stale send buffer.
    contrib = _where_workers(ready, Wprime, state.buffers)

    # Group sums via the iteration-t averaging matrix (A @ contrib == Wsum/S).
    group_mean = group_allreduce.group_average_stacked(contrib, P=P, S=S, t=t)

    # line 11: ready worker adopts the group mean (== Wsum / S).
    # line 13: late-but-completing worker merges its late W':
    #          (Wsum + W') / (S+1) == (S * group_mean + W') / (S+1)
    # (XLA compiles the division into a product with the float32
    # reciprocal; the same product here)
    def late_merge(gm, wp):
        return ((S * gm.float() + wp.float()) * (1.0 / (S + 1.0))).to(gm.dtype)

    merged = tr.tree_map(late_merge, group_mean, Wprime)
    next_completing = _where_workers(ready, group_mean, merged)
    # Non-completing workers are still mid-computation: model unchanged.
    models = _where_workers(completes, next_completing, state.models)

    # Send buffer: updated with W' whenever the local step completed.
    buffers = _where_workers(completes, Wprime, state.buffers)
    r, c = ready.to(state.age.device), completes.to(state.age.device)
    age = torch.where(r, 0, torch.where(c, 1, state.age + 1))

    return SimState(models=models, buffers=buffers,
                    age=age.to(torch.int32), step=state.step + 1)


@dataclass
class StragglerModel:
    """Samples per-iteration readiness, mimicking paper §V-B's injected delay.

    Each iteration, ``n_stragglers`` distinct workers are drawn; a straggler is
    late to the collective, and with probability ``p_stall`` it does not even
    complete its local step within the iteration (multi-step staleness).
    The draws are numpy's, so a seed gives the JAX package's masks.
    """
    P: int
    n_stragglers: int = 2
    p_stall: float = 0.0
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def sample(self):
        ready = np.ones((self.P,), bool)
        completes = np.ones((self.P,), bool)
        if self.n_stragglers > 0:
            idx = self._rng.choice(self.P, size=self.n_stragglers, replace=False)
            ready[idx] = False
            stall = self._rng.random(self.n_stragglers) < self.p_stall
            completes[idx[stall]] = False
        return torch.from_numpy(ready), torch.from_numpy(completes)


def max_staleness_bound(tau: int) -> int:
    """Theory Assumption 3: staleness is bounded by the sync period."""
    return tau


class StalenessBoundExceeded(RuntimeError):
    """A worker's skipped contributions aged past max_staleness_bound(tau).

    Theory Assumption 3 no longer holds for this run — the degraded-mode
    driver hard-aborts rather than silently averaging arbitrarily stale
    state (DESIGN.md §13)."""


@dataclass
class SkipLedger:
    """Host-side staleness accounting for skipped contributions.

    The enforced twin of the simulator's per-worker buffer ``age``
    (`wagma_sim_step`): when the degraded-mode driver runs a round
    without a suspected partner, it charges that worker one round of
    staleness here.  The charge raises `StalenessBoundExceeded` the
    moment the age would pass `max_staleness_bound(tau)` — a hang the
    detector tolerates too long must abort, not corrupt.  Rejoining at
    a tau-sync barrier resets the age to zero (the joiner adopts the
    post-sync consensus); a confirmed-dead worker is dropped (its state
    will never be averaged in again, so it carries no staleness debt).
    """
    tau: int

    def __post_init__(self):
        self.ages: dict = {}
        self.total_skipped: dict = {}
        self.peak_age: int = 0

    def charge(self, worker: int, step: int) -> int:
        """One skipped group round for ``worker`` at ``step``."""
        age = self.ages.get(worker, 0) + 1
        self.ages[worker] = age
        self.total_skipped[worker] = self.total_skipped.get(worker, 0) + 1
        self.peak_age = max(self.peak_age, age)
        if age > max_staleness_bound(self.tau):
            raise StalenessBoundExceeded(
                f"worker {worker} skipped {age} rounds at step {step}, "
                f"exceeding max_staleness_bound(tau={self.tau})="
                f"{max_staleness_bound(self.tau)}")
        return age

    def reset(self, worker: int) -> None:
        """Worker contributed again (rejoined at a sync barrier)."""
        self.ages.pop(worker, None)

    def drop(self, worker: int) -> None:
        """Worker confirmed dead: no future contribution to age."""
        self.ages.pop(worker, None)

    def max_age(self) -> int:
        return max(self.ages.values(), default=0)

    def snapshot(self) -> dict:
        return {"ages": dict(self.ages),
                "total_skipped": dict(self.total_skipped),
                "peak_age": self.peak_age}
