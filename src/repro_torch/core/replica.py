"""Replica state and sharding policy: the object the train step operates on.

Counterpart of ``repro/core/replica.py``.  WAGMA needs *divergent*
per-replica weights:

* ``ShardingPolicy.replicated()``: params and optimiser state carry a
  leading replica axis of size P, every leaf ``(P, ...)`` (the JAX global
  layout).  On one card the replicas are the rows of those tensors; over a
  rank world (``launch/mesh.py``) each rank holds its own ``(1, ...)`` row
  and a ``(1,)`` count, the block JAX's ``shard_map`` hands one device.
* ``ShardingPolicy.fsdp_within_pod(shard_axis)`` (DESIGN.md §10): the
  replicas of one pod (the ranks that differ only on the intra-pod axis
  ``shard_axis``) share one set of weights and act as ONE logical WAGMA
  worker whose gradient is the pod mean.  The state is a tuple of
  ``(P_eff, bucket_elems)`` flat buffers laid out by the compiled plan's
  shard-aligned :class:`~repro_torch.core.bucketing.BucketLayout` (each
  bucket padded to ``pod_size x 128`` elements), one row a pod.  The JAX
  package spreads each row's columns over the pod's devices; on one card
  the port holds that global array whole, as it holds the replicated one,
  so its layouts, checkpoints and conversions are the reference's byte for
  byte.  Over a rank world (``launch/mesh.py``, the gather-all and the
  layer-streamed engines) each rank is one member and holds the
  reference's block: its column slice ``(1, n_b / pod_size)`` of its
  pod's row of every bucket and a ``(1,)`` count (:func:`rank_slices`,
  :func:`join_rank_slices`, which slice and join the flat and the
  grouped layouts alike).  Under a model axis the buckets are those of
  the rank's model coordinate: its plan is compiled over its slice tree
  (``models/common.placement``), so a rank holds ``(1, n_b / pod_size)``
  of its coordinate's buckets, the reference's ``(P_eff, n_b)`` block
  cut ``pod_size x model`` ways (the reference repeats it over
  ``model``).  :func:`model_rank_slices` and :func:`join_model_slices`
  carry a state between that layout and the model-1 one, which the
  gathered state and the checkpoint keep.

``ShardingPolicy.fsdp_within_pod(shard_axis, streamed=True)`` (DESIGN.md
§11) is the layer-streamed layout: the same ``(P_eff, n_b)`` buffers, laid
out by a layer-aware bucket layout over the model's *layered* tree
``{"stem", "layers", "head"}`` (``models/common.LayeredModel``), so the
train step walks one layer span's buckets at a time
(``core/streaming.py``).

Host-side helpers translate whole states between the policies (a
checkpoint written under one restores under the other), between the
layered and canonical structures of a replicated state, and consolidate
any layout into the one model a server loads (``serve/handoff.py``).
FSDP over a rank world runs gather-all or layer-streamed, under a model
axis too.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import bucketing
from repro_torch.core import tree as tr

REPLICATED_KIND = "replicated"
FSDP_KIND = "fsdp_within_pod"
FSDP_STREAMED_SLICE = "slice 7c-2: layer-streamed FSDP over ranks (ported)"
FSDP_MODEL_SLICE = "slice 7c-3: FSDP under a model axis (ported)"
FSDP_SLICE = ("slice 7c: FSDP over ranks, gather-all ported (7c-1); "
              f"{FSDP_STREAMED_SLICE}; {FSDP_MODEL_SLICE}")


@dataclass(frozen=True)
class ShardingPolicy:
    """How divergent replicas lay out their state.

    ``kind`` is ``"replicated"`` or ``"fsdp_within_pod"``; for the latter
    ``shard_axis`` names the dp axis the pod's members share weights over
    (an intra-pod axis of the plan's Topology, validated when the plan
    compiles).  Part of the plan cache key.  ``streamed`` (fsdp only)
    selects the layer-streamed layout over the model's layered tree.
    """
    kind: str = REPLICATED_KIND
    shard_axis: Optional[str] = None
    streamed: bool = False

    def __post_init__(self):
        if self.kind not in (REPLICATED_KIND, FSDP_KIND):
            raise ValueError(f"unknown sharding kind {self.kind!r}")
        if self.kind == FSDP_KIND and not self.shard_axis:
            raise ValueError("fsdp_within_pod needs a shard_axis")
        if self.kind == REPLICATED_KIND and self.shard_axis is not None:
            raise ValueError("replicated policy takes no shard_axis")
        if self.streamed and self.kind != FSDP_KIND:
            raise ValueError("streamed layout requires fsdp_within_pod")

    @classmethod
    def replicated(cls) -> "ShardingPolicy":
        return cls(REPLICATED_KIND)

    @classmethod
    def fsdp_within_pod(cls, shard_axis: str,
                        streamed: bool = False) -> "ShardingPolicy":
        return cls(FSDP_KIND, shard_axis, streamed)

    @property
    def is_sharded(self) -> bool:
        return self.kind == FSDP_KIND

    def describe(self) -> str:
        if self.is_sharded:
            return (f"fsdp_within_pod(shard_axis={self.shard_axis!r}"
                    + (", streamed" if self.streamed else "") + ")")
        return "replicated"


REPLICATED = ShardingPolicy.replicated()


@dataclass
class ReplicaState:
    """Params + optimiser state + averager step/phase bookkeeping.

    Replicated: ``params`` and the optimiser's moment trees are stacked
    ``(P, ...)``, the optimiser's ``count`` a ``(P,)`` vector (``(1, ...)``
    and ``(1,)`` on a rank).  FSDP: tuples of ``(P_eff, n_b)`` shard
    buffers (params in their storage dtypes, moments float32) and a
    ``(P_eff,)`` count.  ``step`` is the global training step; ``phase``
    the butterfly phase index the last group averaging executed (-1 before
    any averaging and after a sync).
    """
    params: object
    opt_state: object
    step: int = 0
    phase: int = -1


# ---------------------------------------------------------------------------
# Layout conversion (checkpoint portability, consolidation)
# ---------------------------------------------------------------------------

def effective_rank_map(axis_sizes: Tuple[int, ...],
                       shard_axis_index: int) -> np.ndarray:
    """``eff_of_rank[dp_rank] -> logical (pod) replica index``.

    ``axis_sizes`` is minor-to-major.  Dropping the shard axis's coordinate
    from a dp rank's mixed-radix decomposition gives the rank in the
    effective (pod-level) replica space, the other axes keeping their
    minor-to-major order.
    """
    sizes = [int(s) for s in axis_sizes]
    P = int(np.prod(sizes))
    eff = np.zeros((P,), np.int64)
    for rank in range(P):
        rem, coords = rank, []
        for s in sizes:
            coords.append(rem % s)
            rem //= s
        stride, e = 1, 0
        for ax, (s, c) in enumerate(zip(sizes, coords)):
            if ax == shard_axis_index:
                continue
            e += c * stride
            stride *= s
        eff[rank] = e
    return eff


def pod_members(plan, pod: int) -> Tuple[int, ...]:
    """The dp ranks of pod ``pod`` of a sharded plan, in rank order."""
    eff = effective_rank_map(plan.topology.axis_sizes, plan.shard_axis_index)
    return tuple(int(r) for r in np.nonzero(eff == pod)[0])


def rank_slices(buffers, plan, world) -> tuple:
    """This rank's block of ``(P_eff, n_b)`` global shard buffers: its
    pod's row, its column slice (``n_b / pod_size`` wide, at its shard
    coordinate), as new ``(1, n_b / pod_size)`` tensors.  Under a model
    axis the buffers are those of this rank's model coordinate."""
    axis = plan.sharding.shard_axis
    pod, s = world.pod_of(axis), world.shard_coord(axis)
    out = []
    for b in buffers:
        n = b.shape[1] // plan.shard_size
        out.append(b[pod:pod + 1, s * n:(s + 1) * n].clone())
    return tuple(out)


def join_rank_slices(stacked, plan) -> tuple:
    """Every dp rank's ``(1, n_b / pod_size)`` blocks, stacked ``(P,
    n_b / pod_size)`` in dp-rank order, -> the ``(P_eff, n_b)`` global
    buffers: each pod's members' slices joined in shard-axis order (under
    a model axis, one model coordinate's ranks and buffers)."""
    members = [pod_members(plan, e) for e in range(plan.P_eff)]
    return tuple(torch.stack([torch.cat([b[r] for r in rows])
                              for rows in members]) for b in stacked)


def _lead_dims(dims):
    """A placement of one replica's tree, for its ``(R, ...)`` rows."""
    return tr.tree_map(lambda d: d + 1, dims)


def model_rank_slices(buffers, whole_plan, plan, world, dims, *,
                      dtype=None) -> tuple:
    """A model-1 FSDP state's ``(P_eff, n_b)`` buffers, laid out by
    ``whole_plan`` (the model's whole tree) -> this rank's ``(1, n_b /
    pod_size)`` slices of ``plan``'s buffers (its model coordinate's
    slice tree): its pod's tree unpacked, its model slices taken by
    ``dims`` (``common.placement`` of one replica's whole tree), packed
    through ``plan`` and cut at its shard coordinate.  ``dtype`` packs
    every bucket in it (float32 for the moments); at ``model`` 1,
    :func:`rank_slices`."""
    if world.model == 1:
        return rank_slices(buffers, plan, world)
    from repro_torch.models import common as cm
    pod = world.pod_of(plan.sharding.shard_axis)
    tree = bucketing.unpack(tuple(b[pod:pod + 1] for b in buffers),
                            whole_plan.shard_layout, cast=dtype is None)
    tree = cm.take_slices(tree, _lead_dims(dims), world.model_world)
    packed = bucketing.pack(tree, plan.shard_layout, dtype=dtype)
    s = world.shard_coord(plan.sharding.shard_axis)
    return tuple(b[:, s * (b.shape[1] // plan.shard_size):
                   (s + 1) * (b.shape[1] // plan.shard_size)].clone()
                 for b in packed)


def join_model_slices(stacked, whole_plan, plan, model: int, dims, *,
                      dtype=None) -> tuple:
    """Every torch rank's ``(1, n_b / pod_size)`` slices, stacked ``(P x
    model, n)`` in torch-rank order (``dp_rank * model + model_rank``),
    -> the model-1 ``(P_eff, n_b)`` buffers of ``whole_plan``: each model
    coordinate's ranks joined into its ``(P_eff, n_b)`` buffers
    (:func:`join_rank_slices`), unpacked through ``plan``, the coordinates'
    slice trees joined by ``dims`` (as :func:`model_rank_slices` takes
    it) and packed through ``whole_plan`` (``dtype`` as there).  At
    ``model`` 1, :func:`join_rank_slices`."""
    if model == 1:
        return join_rank_slices(stacked, plan)
    from repro_torch.models import common as cm
    trees = [bucketing.unpack(join_rank_slices(
        tuple(b[m::model] for b in stacked), plan), plan.shard_layout,
        cast=dtype is None) for m in range(model)]
    tree = cm.join_slices(trees, _lead_dims(dims))
    return bucketing.pack(tree, whole_plan.shard_layout, dtype=dtype)


def _pack_rows(stacked_tree, layout, n_rows: int, dtype=None) -> tuple:
    """(R, ...)-stacked leaves -> tuple of new (R, bucket_elems) buffers."""
    bufs = bucketing.pack(stacked_tree, layout, dtype=dtype)
    for b in bufs:
        if b.shape[0] != n_rows:
            raise ValueError(f"{b.shape[0]} rows, expected {n_rows}")
    return bufs


def _unpack_rows(buffers, layout, cast: bool = True) -> object:
    """Tuple of (R, bucket_elems) buffers -> (R, ...)-stacked leaves (views
    into the buffers where a leaf keeps its bucket's dtype)."""
    return bucketing.unpack(tuple(buffers), layout, cast=cast)


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


def _index_rows(a, rows: np.ndarray):
    return a.index_select(0, torch.as_tensor(rows, dtype=torch.long,
                                             device=a.device))


def sharded_to_replicated_tree(buffers, plan, *, cast: bool = True):
    """FSDP buffers (P_eff, bucket) -> (P, ...)-stacked leaves.

    Every pod's model is broadcast to all its members (members of a pod
    share weights by construction), so the result is a valid replicated
    state of the same topology.
    """
    pod_tree = _unpack_rows(buffers, plan.shard_layout, cast=cast)
    eff = effective_rank_map(plan.topology.axis_sizes, plan.shard_axis_index)
    return tr.tree_map(lambda a: _index_rows(a, eff), pod_tree)


def replicated_to_sharded_tree(stacked_tree, plan, *, dtype=None):
    """(P, ...)-stacked leaves -> FSDP buffers (P_eff, bucket).

    Pod members are averaged in float32, summed in rank order and divided
    by the pod size, as the JAX package's numpy mean does: for a
    replicated checkpoint written mid-divergence this is the pod-consensus
    projection; when members are identical (right after a sync or an
    FSDP -> replicated conversion) the mean is exact and the round trip
    lossless.
    """
    eff = effective_rank_map(plan.topology.axis_sizes, plan.shard_axis_index)
    members = [np.nonzero(eff == e)[0] for e in range(plan.P_eff)]

    def pod_mean(a):
        out = []
        for rows in members:
            acc = a[int(rows[0])].float().clone()
            for r in rows[1:]:
                acc += a[int(r)].float()
            out.append((acc / len(rows)).to(a.dtype))
        return torch.stack(out)

    pod_tree = tr.tree_map(pod_mean, stacked_tree)
    return _pack_rows(pod_tree, plan.shard_layout, plan.P_eff, dtype=dtype)


def fsdp_to_replicated_state(state: ReplicaState, plan) -> ReplicaState:
    """Convert a whole FSDP ReplicaState into the replicated layout."""
    eff = effective_rank_map(plan.topology.axis_sizes, plan.shard_axis_index)
    params = sharded_to_replicated_tree(state.params, plan)
    opt = map_opt_state(
        state.opt_state,
        lambda t: sharded_to_replicated_tree(t, plan, cast=False),
        lambda c: _index_rows(c, eff))
    return ReplicaState(params, opt, state.step, state.phase)


def replicated_to_fsdp_state(state: ReplicaState, plan) -> ReplicaState:
    """Convert a whole replicated ReplicaState into the FSDP layout."""
    eff = effective_rank_map(plan.topology.axis_sizes, plan.shard_axis_index)
    first_member = np.asarray(
        [int(np.nonzero(eff == e)[0][0]) for e in range(plan.P_eff)])
    params = replicated_to_sharded_tree(state.params, plan)
    opt = map_opt_state(
        state.opt_state,
        lambda t: replicated_to_sharded_tree(t, plan, dtype=torch.float32),
        lambda c: _index_rows(c, first_member))
    return ReplicaState(params, opt, state.step, state.phase)


def merge_layered_state(state: ReplicaState, layered) -> ReplicaState:
    """Replicated state in the stacked LAYERED structure -> the canonical
    structure.

    A streamed-FSDP state converts to the replicated layout in the layered
    tree ``{"stem", "layers", "head"}`` (the streamed plan's storage
    structure); ``layered`` (the model's
    :class:`~repro_torch.models.common.LayeredModel`) merges each replica
    row back into the canonical stacked tree: pure restructuring, bit for
    bit.
    """
    merge_rows = lambda t: layered.merge(t, lead=1)
    return ReplicaState(merge_rows(state.params),
                        map_opt_state(state.opt_state, merge_rows,
                                      lambda c: c),
                        state.step, state.phase)


def split_layered_state(state: ReplicaState, layered) -> ReplicaState:
    """Canonical-structure replicated state -> the stacked LAYERED
    structure (views of the state's leaves)."""
    split_rows = lambda t: layered.split(t, lead=1)
    return ReplicaState(split_rows(state.params),
                        map_opt_state(state.opt_state, split_rows,
                                      lambda c: c),
                        state.step, state.phase)


def canonical_replicated_template(layered_template: ReplicaState,
                                  layered) -> ReplicaState:
    """The canonical-stacked twin of a layered-stacked template.

    ``replicated_state_template`` of a *streamed* plan has the layered
    structure (the plan's storage struct); replicated runs save and
    restore the canonical tree, so a cross-policy restore merges the
    template's rows (``Spec`` leaves).
    """
    return merge_layered_state(layered_template, layered)


def _count_spec(c, n: int) -> tr.Spec:
    return tr.Spec((n,), c.dtype)


def sharded_state_template(plan, opt_state_like) -> ReplicaState:
    """A ReplicaState of :class:`~repro_torch.core.tree.Spec` leaves in the
    FSDP layout of ``plan``.

    ``opt_state_like`` supplies the optimiser state *type* (any state of
    the same optimiser, either layout); only shapes and dtypes are made:
    the template a cross-policy checkpoint restore rebuilds into.
    """
    lay = plan.shard_layout
    n = plan.P_eff
    params = tuple(tr.Spec((n, s), d)
                   for s, d in zip(lay.bucket_sizes, lay.bucket_dtypes))
    moments = tuple(tr.Spec((n, s), torch.float32) for s in lay.bucket_sizes)
    opt = map_opt_state(opt_state_like, lambda _: moments,
                        lambda c: _count_spec(c, n))
    return ReplicaState(params, opt)


def replicated_state_template(plan, opt_state_like) -> ReplicaState:
    """A ReplicaState of Specs in the replicated (P, ...)-stacked layout."""
    n = plan.P
    params = tr.tree_map(lambda s: tr.Spec((n,) + tuple(s.shape), s.dtype),
                         plan.storage_struct)
    moments = tr.tree_map(
        lambda s: tr.Spec((n,) + tuple(s.shape), torch.float32),
        plan.storage_struct)
    opt = map_opt_state(opt_state_like, lambda _: moments,
                        lambda c: _count_spec(c, n))
    return ReplicaState(params, opt)


def consolidate_state(state: ReplicaState, plan=None):
    """Average the replica axis -> the single post-training consensus model
    (float32 mean, stored in each leaf's dtype).

    Replicated states need no plan (``checkpoint.ckpt.consolidate``); FSDP
    states average the pod axis of each shard buffer, then unpack through
    the plan's shard layout.
    """
    from repro_torch.checkpoint.ckpt import consolidate
    if plan is not None and plan.sharding.is_sharded and \
            isinstance(state.params, tuple):
        mean_bufs = tuple(b.float().mean(0).to(b.dtype)
                          for b in state.params)
        return bucketing.unpack(mean_bufs, plan.shard_layout)
    if isinstance(state.params, tuple):
        raise ValueError(
            "consolidate_state got an FSDP (shard-buffer) state but no "
            "sharded plan to unpack it through; pass the compiled plan")
    return consolidate(state.params)
