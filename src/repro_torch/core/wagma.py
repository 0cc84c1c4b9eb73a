"""WAGMA-SGD (paper Algorithm 2) — the averager.

Counterpart of ``repro/core/wagma.py``.  The training step
(``train/train_step.py``) is, per replica:

    G     = grad(loss)(W, local_batch)          # local gradients, no dp mean
    W'    = W + U(G)                            # local optimiser step
    if (t+1) % tau != 0:
        W <- plan.average(W', phase(t))         # wait-avoiding group allreduce
    else:
        W <- plan.sync(W')                      # synchronous allreduce (line 16)

The averager owns the phase/sync bookkeeping and delegates every
collective to the :class:`~repro_torch.core.plan.AveragingPlan` its
topology compiles to for the current tree structure.  The trees it is
handed are stacked ``(P, ...)``, or, over a rank world
(``launch/mesh.py``), this rank's ``(1, ...)`` row; under
``fsdp_within_pod`` the ``(P_eff, n_b)`` shard buffers, one row a pod, the
groups formed over the ``P_eff`` pods; over a rank world this rank's
``(1, n_b / pod_size)`` slices of its pod's row, averaged pod to pod on the
plan's pod view.
"""

from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.core import grouping
from repro_torch.core import plan as plan_mod
from repro_torch.core import tree as tr
from repro_torch.core.replica import REPLICATED, ShardingPolicy

# WagmaConfig(group_size=..., tau=..., fused=...) is the plan's config.
WagmaConfig = plan_mod.AveragingConfig


class WagmaAverager:
    """The paper's contribution as a composable averaging strategy."""

    name = "wagma"
    grad_comm = False   # averages *models*, not gradients

    def __init__(self, dp_axis_names: Sequence[str], dp_axis_sizes: Sequence[int],
                 cfg: WagmaConfig = WagmaConfig(),
                 topology: Optional[plan_mod.Topology] = None,
                 sharding: ShardingPolicy = REPLICATED, world=None):
        # minor-to-major layout (see group_allreduce.dp_axis_layout)
        self.axis_names = tuple(dp_axis_names)
        self.axis_sizes = tuple(int(s) for s in dp_axis_sizes)
        if topology is None:
            topology = plan_mod.Topology.flat(self.axis_names, self.axis_sizes)
        if (topology.axis_names != self.axis_names
                or topology.axis_sizes != self.axis_sizes):
            raise ValueError(
                f"topology axes {topology.axis_names}/{topology.axis_sizes} "
                f"do not match dp axes {self.axis_names}/{self.axis_sizes}")
        self.topology = topology
        self.sharding = sharding
        self.world = world
        self.P = topology.P
        # Under fsdp_within_pod the shard axis's ranks share weights and
        # act as one logical WAGMA worker: grouping runs over the
        # effective (pod-level) replica space (DESIGN.md §10).
        if sharding.is_sharded:
            self.P_eff = topology.drop_axis(sharding.shard_axis).P
        else:
            self.P_eff = self.P
        self.S = cfg.group_size or grouping.default_group_size(self.P_eff)
        if self.S > self.P_eff:
            raise ValueError(f"group size {self.S} exceeds replica world "
                             f"{self.P_eff}")
        self.cfg = cfg
        if cfg.dynamic_groups:
            self.offsets = grouping.distinct_offsets(self.P_eff, self.S)
        else:
            self.offsets = (0,)   # ablation 2: fixed groups

    # -- step-variant bookkeeping -------------------------------------------
    @property
    def n_phases(self) -> int:
        return len(self.offsets)

    def phase_for_step(self, t: int) -> int:
        if not self.cfg.dynamic_groups:
            return 0
        return self.offsets.index(
            grouping.phase_offset(self.P_eff, self.S, t))

    def sync_due(self, t: int) -> bool:
        return (t + 1) % self.cfg.tau == 0

    # -- the compiled plan ----------------------------------------------------
    def plan_for(self, tree) -> plan_mod.AveragingPlan:
        """The compiled plan for a tree's structure (cached).  Under
        ``fsdp_within_pod`` ``tree`` may be the stacked full tree (at state
        init) or the plan's own shard buffers (inside the train step)."""
        return plan_mod.compile_plan(self.topology, tr.struct(tree, drop=1),
                                     self.cfg, self.sharding, self.world)

    # -- collective bodies ----------------------------------------------------
    def comm(self, tree, phase: int):
        """Wait-avoiding group model averaging (Alg. 2 line 9 + 11)."""
        return self.plan_for(tree).average(tree, phase)

    def sync(self, tree):
        """Synchronous global allreduce (Alg. 2 line 16)."""
        return self.plan_for(tree).sync(tree)
