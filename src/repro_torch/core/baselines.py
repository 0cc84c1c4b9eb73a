"""Baseline data-parallel SGD variants (the paper's comparison set, Table I).

Counterpart of ``repro/core/baselines.py``.  Every averager exposes the
interface of ``WagmaAverager``:

    grad_comm : bool      — True: averages gradients (pre-optimiser);
                            False: averages models (post-optimiser)
    n_phases  : int       — number of distinct step variants
    phase_for_step(t)     — which variant iteration t uses
    sync_due(t)           — whether this step uses the global-sync variant
    comm(tree, phase)     — per-step collective on a stacked (P, ...) tree
                            (or this rank's (1, ...) row over a rank world)
    sync(tree)            — global average of the tree

Each baseline holds a compiled :class:`~repro_torch.core.plan.AveragingPlan`
and runs its collective through ``plan.mix(tree, issue, combine, bits=...)``
or ``plan.sync(tree)``: the ``issue`` half is the collective on whole
buffers through the plan's wire (a ``pmean`` is ``wire.pmean_rows``, a
ring ``ppermute`` ``wire.ring_shift``, a partner exchange
``wire.butterfly_exchange``: on stacked rows or over ranks,
``core/plan.py``), the ``combine`` half the JAX package's arithmetic in
float32, in the same order.  XLA compiles the reference's division by a
constant (``/ 3.0``) into a product with the constant's float32
reciprocal, so the combines
here write that product (:func:`_divide`), which keeps them bit for bit
the reference's.  No baseline combine runs a kernel, in either package:
only the WAGMA butterfly calls K1/K2.

Under ``fsdp_within_pod`` the trees are the ``(P_eff, n_b)`` shard
buffers (over a rank world this rank's ``(1, n_b / pod_size)`` slices) and
every collective spans the pods (``comm_axis_*``, ``P_eff``; over ranks
the plan's pod view).

Semantics (D-PSGD's ring rides the minor dp axis, so with the one
``("data",)`` axis it spans all P replicas):

* Allreduce-SGD — synchronous global gradient mean (standard data-parallel).
* Local SGD     — no per-step comm; global model average every H steps.
* D-PSGD        — synchronous ring gossip: W <- (W + W_left + W_right)/3.
* SGP           — one neighbour per step on a rotating hypercube edge (the
                  directed-exponential graph is ``mixing_matrix("sgp")``).
* AD-PSGD       — pairwise model averaging on a rotating bit (its
                  asynchrony exists only in the simulator).
* Eager-SGD     — partial/solo gradient collective; traffic equals a global
                  allreduce, staleness semantics simulator-only.

``mixing_matrix(name, P, t)`` gives each variant's P x P doubly-stochastic
gossip matrix for the convergence simulator.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.core import bucketing, grouping
from repro_torch.core import plan as plan_mod
from repro_torch.core import tree as tr
from repro_torch.core.replica import REPLICATED, ShardingPolicy


def _divide(x, d: float):
    """``x / d`` as XLA computes a division by a constant: ``x`` times the
    float32 reciprocal (a torch float32 tensor times a Python float
    multiplies by the float rounded to float32)."""
    return x * (1.0 / d)


class _AveragerBase:
    grad_comm = False
    n_phases = 1

    def __init__(self, dp_axis_names: Sequence[str], dp_axis_sizes: Sequence[int],
                 fused: bool = True,
                 bucket_bytes: int = bucketing.DEFAULT_BUCKET_BYTES,
                 overlap: bool = True,
                 topology: Optional[plan_mod.Topology] = None,
                 sharding: ShardingPolicy = REPLICATED, world=None):
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
        self.P = int(np.prod(self.axis_sizes))
        # Collectives ride the *effective* replica axes: under
        # fsdp_within_pod the shard axis carries one model's members, not
        # divergent replicas, so every mix, ring and mean spans the pods
        # (the shard buffers' rows) only (DESIGN.md §10).
        eff = (topology.drop_axis(sharding.shard_axis)
               if sharding.is_sharded else topology)
        self.comm_axis_names = eff.axis_names
        self.comm_axis_sizes = eff.axis_sizes
        self.P_eff = eff.P
        self._cfg = plan_mod.AveragingConfig(
            average_dtype="float32", fused=fused, bucket_bytes=bucket_bytes,
            overlap=overlap)

    def phase_for_step(self, t: int) -> int:
        return t % self.n_phases

    def sync_due(self, t: int) -> bool:
        return False

    def plan_for(self, tree) -> plan_mod.AveragingPlan:
        """The compiled plan for a tree's structure (cached; sharded
        plans also for their own shard buffers)."""
        return plan_mod.compile_plan(self.topology, tr.struct(tree, drop=1),
                                     self._cfg, self.sharding, self.world)

    def comm(self, tree, phase: int):
        return tree

    def sync(self, tree):
        return self.plan_for(tree).sync(tree)

    def _mix_tree(self, tree, issue, combine, bits=()):
        """Run a (collective, arithmetic) mix pair through the plan."""
        return self.plan_for(tree).mix(tree, issue, combine,
                                       bits=tuple(bits))


class AllreduceAverager(_AveragerBase):
    """Standard synchronous data-parallel SGD (global gradient averaging)."""
    name = "allreduce"
    grad_comm = True

    def comm(self, tree, phase: int):
        # the reduction IS the collective, so combine is the identity;
        # under fsdp_within_pod the tree is the pod-meaned grad shard
        # buffers, so the mean spans pods only
        wire = self.plan_for(tree).wire
        return self._mix_tree(tree, wire.pmean_rows, lambda g, r: r)


class LocalSGDAverager(_AveragerBase):
    """Local SGD: H local steps, then a global model average."""
    name = "local_sgd"

    def __init__(self, dp_axis_names, dp_axis_sizes, sync_period: int = 1,
                 **kw):
        super().__init__(dp_axis_names, dp_axis_sizes, **kw)
        self.sync_period = sync_period

    def sync_due(self, t: int) -> bool:
        return (t + 1) % self.sync_period == 0


class DPSGDAverager(_AveragerBase):
    """D-PSGD: synchronous ring gossip with both neighbours."""
    name = "dpsgd"

    def comm(self, tree, phase: int):
        # the ring rides the minor dp axis (bit 0's link class)
        n = self.comm_axis_sizes[0]
        shift = self.plan_for(tree).wire.ring_shift

        def issue(acc):
            return shift(acc, 1, n), shift(acc, -1, n)

        def combine(acc, recv):
            left, right = recv
            return _divide(acc + left + right, 3.0)

        return self._mix_tree(tree, issue, combine, bits=(0,))


class SGPAverager(_AveragerBase):
    """Stochastic Gradient Push — hypercube-edge variant (one peer/step)."""
    name = "sgp"

    def __init__(self, dp_axis_names, dp_axis_sizes, neighbours: int = 1,
                 **kw):
        super().__init__(dp_axis_names, dp_axis_sizes, **kw)
        self.neighbours = neighbours
        self.n_phases = grouping.ilog2(self.P_eff)

    def comm(self, tree, phase: int):
        lp = grouping.ilog2(self.P_eff)
        bits = tuple((phase + k) % lp for k in range(self.neighbours))
        exchange = self.plan_for(tree).wire.butterfly_exchange

        def issue(acc):
            return tuple(exchange(acc, b) for b in bits)

        def combine(acc, recvs):
            total = acc
            for r in recvs:
                total = total + r
            return _divide(total, self.neighbours + 1.0)

        return self._mix_tree(tree, issue, combine, bits=bits)


class ADPSGDAverager(_AveragerBase):
    """AD-PSGD: pairwise model averaging (async only in the simulator)."""
    name = "adpsgd"

    def __init__(self, dp_axis_names, dp_axis_sizes, **kw):
        super().__init__(dp_axis_names, dp_axis_sizes, **kw)
        self.n_phases = grouping.ilog2(self.P_eff)

    def comm(self, tree, phase: int):
        exchange = self.plan_for(tree).wire.butterfly_exchange
        return self._mix_tree(
            tree, lambda acc: exchange(acc, phase),
            lambda acc, other: _divide(acc + other, 2.0), bits=(phase,))


class EagerSGDAverager(AllreduceAverager):
    """Eager-SGD: partial gradient collective; SPMD traffic == allreduce."""
    name = "eager_sgd"


BASELINES = {
    "allreduce": AllreduceAverager,
    "local_sgd": LocalSGDAverager,
    "dpsgd": DPSGDAverager,
    "sgp": SGPAverager,
    "adpsgd": ADPSGDAverager,
    "eager_sgd": EagerSGDAverager,
}
AVERAGERS = ("wagma",) + tuple(BASELINES)


def make_averager(name: str, dp_axis_names, dp_axis_sizes, **kw):
    from repro_torch.core.wagma import WagmaAverager, WagmaConfig
    name = name.lower()
    if name == "wagma":
        topology = kw.pop("topology", None)
        sharding = kw.pop("sharding", REPLICATED)
        world = kw.pop("world", None)
        cfg = WagmaConfig(**kw) if kw else WagmaConfig()
        return WagmaAverager(dp_axis_names, dp_axis_sizes, cfg,
                             topology=topology, sharding=sharding,
                             world=world)
    if name not in BASELINES:
        raise ValueError(f"unknown averager {name!r}; options: "
                         f"{['wagma'] + sorted(BASELINES)}")
    return BASELINES[name](dp_axis_names, dp_axis_sizes, **kw)


# ---------------------------------------------------------------------------
# Simulator-side mixing matrices (true topologies, incl. directed-exp SGP)
# ---------------------------------------------------------------------------

def mixing_matrix(name: str, P: int, t: int, *, S: int | None = None,
                  sync_period: int = 1, neighbours: int = 1,
                  rng: np.random.Generator | None = None) -> np.ndarray:
    """P x P (doubly-)stochastic gossip matrix of variant ``name`` at step t."""
    name = name.lower()
    eye = np.eye(P, dtype=np.float32)
    if name == "wagma":
        S = S or grouping.default_group_size(P)
        return np.asarray(grouping.averaging_matrix(P, S, t), np.float32)
    if name == "allreduce" or name == "eager_sgd":
        return np.full((P, P), 1.0 / P, np.float32)
    if name == "local_sgd":
        if (t + 1) % sync_period == 0:
            return np.full((P, P), 1.0 / P, np.float32)
        return eye
    if name == "dpsgd":
        A = eye / 3.0
        for i in range(P):
            A[i, (i + 1) % P] = 1 / 3.0
            A[i, (i - 1) % P] = 1 / 3.0
        return A
    if name == "sgp":
        # directed exponential graph: peer at distance 2^(t mod log2 P)
        lp = grouping.ilog2(P)
        A = eye.copy() / (neighbours + 1.0)
        for k in range(neighbours):
            d = 1 << ((t + k) % lp)
            for i in range(P):
                A[i, (i + d) % P] = 1.0 / (neighbours + 1.0)
        return A
    if name == "adpsgd":
        # one random disjoint pairing per step
        rng = rng or np.random.default_rng(t)
        perm = rng.permutation(P)
        A = eye.copy()
        for a in range(0, P - 1, 2):
            i, j = perm[a], perm[a + 1]
            A[i, i] = A[j, j] = 0.5
            A[i, j] = A[j, i] = 0.5
        return A
    raise ValueError(name)
