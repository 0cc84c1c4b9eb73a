"""Replica state and sharding policy: the object the train step operates on.

Counterpart of ``repro/core/replica.py``, replicated realisation only.
WAGMA needs *divergent* per-replica weights: under
``ShardingPolicy.replicated()`` params and optimiser state carry a leading
replica axis of size P, every leaf ``(P, ...)`` (the JAX global layout).
On one card the replicas are the rows of those tensors; over a rank world
(``launch/mesh.py``) each rank holds its own ``(1, ...)`` row and a
``(1,)`` count, the block JAX's ``shard_map`` hands one device.

``ShardingPolicy.fsdp_within_pod`` (replicas inside a pod sharing sharded
weights, DESIGN.md §10) belongs to the FSDP slice and raises here.
:func:`consolidate_state` averages the replica axis into the one model a
server loads (``serve/handoff.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

REPLICATED_KIND = "replicated"
FSDP_KIND = "fsdp_within_pod"
FSDP_SLICE = ("the FSDP slice of the port (ROADMAP.md, slice 7: sharded "
              "replicas)")


@dataclass(frozen=True)
class ShardingPolicy:
    """How divergent replicas lay out their state.  Only ``replicated``
    is ported; part of the plan cache key, as in the JAX package."""
    kind: str = REPLICATED_KIND
    shard_axis: Optional[str] = None
    streamed: bool = False

    def __post_init__(self):
        if self.kind == FSDP_KIND or self.streamed:
            raise NotImplementedError(
                f"ShardingPolicy {self.kind!r}"
                f"{' (streamed)' if self.streamed else ''} is not ported "
                f"yet; it belongs to {FSDP_SLICE}")
        if self.kind != REPLICATED_KIND:
            raise ValueError(f"unknown sharding kind {self.kind!r}")
        if self.shard_axis is not None:
            raise ValueError("replicated policy takes no shard_axis")

    @classmethod
    def replicated(cls) -> "ShardingPolicy":
        return cls(REPLICATED_KIND)

    @classmethod
    def fsdp_within_pod(cls, shard_axis: str,
                        streamed: bool = False) -> "ShardingPolicy":
        raise NotImplementedError(
            f"fsdp_within_pod({shard_axis!r}) is not ported yet; it belongs "
            f"to {FSDP_SLICE}")

    @property
    def is_sharded(self) -> bool:
        return False

    def describe(self) -> str:
        return "replicated"


REPLICATED = ShardingPolicy.replicated()


@dataclass
class ReplicaState:
    """Params + optimiser state + averager step/phase bookkeeping.

    ``params`` and the optimiser's moment trees are stacked ``(P, ...)``;
    the optimiser's ``count`` is a ``(P,)`` vector (``(1, ...)`` and
    ``(1,)`` on a rank).  ``step`` is the global
    training step; ``phase`` the butterfly phase index the last group
    averaging executed (-1 before any averaging and after a sync).
    """
    params: object
    opt_state: object
    step: int = 0
    phase: int = -1


def map_opt_state(opt_state, fn_tree, fn_count):
    """Apply a params-structure conversion to an optimiser state.

    Optimiser states are NamedTuples whose fields are params-structured
    moment trees (``momentum``/``mu``/``nu``) or the ``count``.
    """
    if not hasattr(opt_state, "_fields"):
        raise TypeError(f"unsupported optimiser state {type(opt_state)}")
    vals = {f: (fn_count(getattr(opt_state, f)) if f == "count"
                else fn_tree(getattr(opt_state, f)))
            for f in opt_state._fields}
    return type(opt_state)(**vals)


def consolidate_state(state: ReplicaState, plan=None):
    """Average the replica axis -> the single post-training consensus model
    (``checkpoint.ckpt.consolidate``: float32 mean, stored in each leaf's
    dtype).  A plan with a sharded policy raises: consolidating FSDP shard
    buffers belongs to the FSDP slice."""
    from repro_torch.checkpoint.ckpt import consolidate
    if plan is not None and plan.sharding.is_sharded:
        raise NotImplementedError(
            f"consolidating a {plan.sharding.describe()} state unpacks its "
            f"shard buffers; that belongs to {FSDP_SLICE}")
    if isinstance(state.params, tuple):
        raise ValueError(
            "consolidate_state got an FSDP (shard-buffer) state but no "
            "sharded plan to unpack it through; pass the compiled plan")
    return consolidate(state.params)
