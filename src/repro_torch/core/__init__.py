"""WAGMA-SGD core: the group schedule
(``grouping``), flat buckets (``bucketing``), the wavefront (``overlap``),
the compiled averaging plan and its wire (``plan``), the layer-streamed
FSDP engine (``streaming``), the averagers
(``wagma``, ``baselines``), the straggler simulator (``staleness``), and
elastic membership (``elastic``) with its failure detector (``health``)
and seeded faults (``faults``).

Counterpart of ``repro/core``, exporting the same names.  A replicated
tree is stacked, each leaf in the JAX global layout ``(P, ...)`` with one
row per replica, or, over a rank world, this rank's ``(1, ...)`` row; an
FSDP-within-pod state (``replica``) is a tuple of ``(P_eff, n_b)`` shard
buffers, one row a pod.
"""

from repro_torch.core.grouping import (default_group_size,
                                       groups_for_iteration, mask_bits,
                                       n_phases, phase_offset,
                                       propagation_latency)
from repro_torch.core.replica import ReplicaState, ShardingPolicy
from repro_torch.core.plan import (AveragingConfig, AveragingPlan, LinkClass,
                                   Topology, compile_plan)
from repro_torch.core.wagma import WagmaAverager, WagmaConfig
from repro_torch.core.baselines import make_averager

__all__ = [
    "AveragingConfig", "AveragingPlan", "LinkClass", "ReplicaState",
    "ShardingPolicy", "Topology", "compile_plan",
    "WagmaAverager", "WagmaConfig", "make_averager",
    "default_group_size", "groups_for_iteration", "mask_bits",
    "n_phases", "phase_offset", "propagation_latency",
]
