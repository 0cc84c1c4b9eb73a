"""The rank world: one WAGMA replica per process over ``torch.distributed``.

Counterpart of ``repro/launch/mesh.py``.  Where JAX lays replicas over the
``data`` (and ``pod``) axes of a device mesh, the port lays them over the
ranks that ``torch.distributed.run`` (torchrun) starts:

    world = init_rank_world(data=4, backend="gloo")   # RANK, WORLD_SIZE, ...
    trainer = Trainer(cfg, 4, world=world)

The dp axes are named minor to major, as ``group_allreduce.dp_axis_layout``
names them: with ``--pod-axis 2 --data-axis 2`` the axes are
``("data", "pod")`` of sizes ``(2, 2)`` and the global dp rank, which is the
torch rank, is ``pod * 2 + data``.

**The model axis** (``model=M``): the ranks of one replica split its
model (``models/common.ModelWorld``).  The torch rank is ``dp_rank * M +
model_rank``, model minor, as ``jax.make_mesh((data, model))`` orders its
devices; ``RankWorld.rank`` stays the dp rank, which the batch, the plan's
wire and the checkpoint rows read.  Every rank creates, in the same order,
one process group a replica (its model ranks, ``model_group``) and one a
model coordinate (the ranks that hold the same slices, ``dp_group``),
which the plan's all-reduces run over.  With ``M = 1`` neither exists
and every collective runs over the whole world, as before.

**FSDP within a pod** (``shard_axis="data"``): the ranks that differ only
on the shard axis are one pod's members and share one set of weights,
each holding its column slice of the pod's shard buckets.  Every rank
creates, in the same order, one process group a pod (its members in
shard-axis order, ``shard_group``: the all-gather and the reduce-scatter
of ``core/plan.py``) and one a shard coordinate (the ranks holding the
same slice of every pod, the pod view's ``dp_group``: its all-reduces).
``RankWorld.drop_axis(shard_axis)`` is the pod view, the twin of
``Topology.drop_axis``: a world over the remaining dp axes whose rank is
this rank's pod and whose peers are the members at this rank's shard
coordinate, so the plan's butterfly, ring and mean run pod to pod on the
slices unchanged.  Under a model axis every group is made once a model
coordinate: a pod's members and a shard coordinate's pods at this rank's
model coordinate, which hold the same slices of the model.

The backend is the caller's explicit choice, never switched silently:
``nccl`` hands device tensors to the collectives and needs one card per
local rank (it raises otherwise: NCCL refuses two ranks on one card);
``gloo`` stages every exchange through host memory and lets the ranks share
a card (local rank r runs on card ``r % device_count``).  On the CPU
(``device_type="cpu"``) it is ``gloo``.

The reference's TPU v5e constants have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import tree as tr
from repro_torch.models import common as cm

BACKENDS = ("nccl", "gloo")


@dataclass(frozen=True)
class RankWorld:
    """This process's place among the ranks.

    ``axis_names``/``axis_sizes`` are the dp axes minor to major; ``rank``
    is the global dp rank, ``coords`` its coordinate on each axis (mixed
    radix, minor first).  ``model`` ranks split each replica's model, this
    one at ``model_rank``; the torch rank is ``rank * model +
    model_rank`` (the dp rank itself at ``model`` 1).

    ``shard_axis`` names the FSDP shard axis the world was started for
    (``init_rank_world``), ``shard_group`` this rank's pod's group and
    ``coord_groups`` the group of each shard coordinate, both at this
    rank's model coordinate.  A pod view (:meth:`drop_axis`) lists its
    ranks' torch ranks in ``torch_ranks``.
    """
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    rank: int
    device: torch.device
    backend: str
    model: int = 1
    model_rank: int = 0
    model_group: object = field(default=None, compare=False, repr=False)
    dp_group: object = field(default=None, compare=False, repr=False)
    shard_axis: Optional[str] = None
    shard_group: object = field(default=None, compare=False, repr=False)
    coord_groups: tuple = field(default=(), compare=False, repr=False)
    torch_ranks: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError("axis_names/axis_sizes length mismatch")
        if not 0 <= self.rank < self.P:
            raise ValueError(f"rank {self.rank} outside a world of {self.P}")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; options: "
                             f"{BACKENDS}")
        if not 0 <= self.model_rank < self.model:
            raise ValueError(f"model rank {self.model_rank} outside a "
                             f"model axis of {self.model}")

    @property
    def P(self) -> int:
        p = 1
        for s in self.axis_sizes:
            p *= s
        return p

    @property
    def coords(self) -> Tuple[int, ...]:
        out, r = [], self.rank
        for s in self.axis_sizes:
            out.append(r % s)
            r //= s
        return tuple(out)

    def rank_of(self, coords: Sequence[int]) -> int:
        """The global rank at ``coords`` (minor first)."""
        rank, stride = 0, 1
        for c, s in zip(coords, self.axis_sizes):
            rank += (c % s) * stride
            stride *= s
        return rank

    def torch_rank_of(self, dp_rank: int) -> int:
        """The torch rank of dp rank ``dp_rank`` at this rank's model
        coordinate (in a pod view, of pod ``dp_rank``'s member at this
        rank's shard coordinate)."""
        if self.torch_ranks is not None:
            return self.torch_ranks[dp_rank]
        return dp_rank * self.model + self.model_rank

    # -- FSDP within a pod ---------------------------------------------------
    def _axis_index(self, name: str) -> int:
        if name not in self.axis_names:
            raise ValueError(f"axis {name!r} not in {self.axis_names}")
        return self.axis_names.index(name)

    def pod_of(self, name: str) -> int:
        """This rank's pod: its dp rank with the shard axis ``name``
        dropped (``replica.effective_rank_map``)."""
        ax, rank, stride = self._axis_index(name), 0, 1
        for i, (c, s) in enumerate(zip(self.coords, self.axis_sizes)):
            if i != ax:
                rank += c * stride
                stride *= s
        return rank

    def shard_coord(self, name: str) -> int:
        """This rank's coordinate on the shard axis ``name``."""
        return self.coords[self._axis_index(name)]

    def shard_members(self, name: str) -> Tuple[int, ...]:
        """The torch ranks of this rank's pod at its model coordinate, in
        shard-axis order."""
        ax = self._axis_index(name)
        coords = list(self.coords)
        out = []
        for s in range(self.axis_sizes[ax]):
            coords[ax] = s
            out.append(self.torch_rank_of(self.rank_of(coords)))
        return tuple(out)

    def drop_axis(self, name: str) -> "RankWorld":
        """The pod view: a world over the dp axes but ``name`` whose rank
        is this rank's pod and whose peers are each pod's member at this
        rank's shard coordinate and model coordinate (their all-reduces
        over that coordinate's group, summed in pod order)."""
        ax = self._axis_index(name)
        if len(self.axis_names) == 1:
            raise ValueError("cannot drop the only dp axis")
        keep = [i for i in range(len(self.axis_names)) if i != ax]
        names = tuple(self.axis_names[i] for i in keep)
        sizes = tuple(self.axis_sizes[i] for i in keep)
        coord = self.coords[ax]
        coords = list(self.coords)
        ranks = []
        for pod in range(self.P // self.axis_sizes[ax]):
            rem = pod
            for i, s in zip(keep, sizes):
                coords[i] = rem % s
                rem //= s
            coords[ax] = coord
            ranks.append(self.torch_rank_of(self.rank_of(coords)))
        group = (self.coord_groups[coord] if self.shard_axis == name
                 and self.coord_groups else None)
        return RankWorld(names, sizes, self.pod_of(name), self.device,
                         self.backend, dp_group=group,
                         torch_ranks=tuple(ranks))

    @property
    def torch_rank(self) -> int:
        return self.torch_rank_of(self.rank)

    @property
    def model_world(self) -> Optional[cm.ModelWorld]:
        """This replica's model ranks, or ``None`` at ``model`` 1."""
        if self.model == 1:
            return None
        return cm.ModelWorld(self.model, self.model_rank, self.model_group,
                             self.stages_through_host)

    @property
    def stages_through_host(self) -> bool:
        """gloo takes CPU tensors: device buffers go through host memory."""
        return self.backend == "gloo" and self.device.type == "cuda"


def dp_axes(data: int, pod: Optional[int] = None
            ) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """Minor-to-major dp axes of a (pod, data) layout."""
    if pod:
        return ("data", "pod"), (int(data), int(pod))
    return ("data",), (int(data),)


def resolve_backend(backend: Optional[str], device_type: str) -> str:
    """``backend`` as given; ``None`` means ``nccl`` on the card and
    ``gloo`` on the CPU.  ``nccl`` on the CPU raises."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device type {device_type!r}")
    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; options: {BACKENDS}")
    if backend == "nccl" and device_type != "cuda":
        raise ValueError("the nccl backend runs on CUDA devices only; the "
                         "CPU takes gloo")
    return backend


def rank_device(backend: str, device_type: str, local_rank: int,
                local_world: int) -> torch.device:
    """The device of a local rank.  No rank finds itself on the CPU when a
    card was asked for: without one it raises."""
    if device_type == "cpu":
        return torch.device("cpu")
    n_cards = torch.cuda.device_count()
    if n_cards < 1:
        raise RuntimeError("no CUDA device: the ranks were asked to run on "
                           "the card (REPRO_TORCH_DEVICE=cpu asks for the "
                           "CPU)")
    if backend == "nccl" and local_world > n_cards:
        raise RuntimeError(
            f"nccl needs one card per local rank: {local_world} local ranks,"
            f" {n_cards} card(s); gloo lets ranks share a card")
    return torch.device("cuda", local_rank % n_cards)


def init_rank_world(data: int, pod: Optional[int] = None, *, model: int = 1,
                    backend: Optional[str] = None, device_type: str = "cuda",
                    init_method: str = "env://",
                    shard_axis: Optional[str] = None) -> RankWorld:
    """Join the process group torchrun describes (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``) and return this rank's world.
    ``data x pod x model`` must equal the world size; with ``model`` > 1
    every rank creates the model and dp groups, with ``shard_axis`` (FSDP
    within a pod) the pod groups and the shard coordinates' groups, one
    set a model coordinate.  A process already in the group only creates
    the groups of the world it asks for (every rank must ask alike)."""
    names, sizes = dp_axes(data, pod)
    world_size = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    p = 1
    for s in sizes:
        p *= s
    if p * model != world_size:
        raise ValueError(f"dp axes {dict(zip(names, sizes))} hold {p} "
                         f"replicas of {model} model rank(s); the world has "
                         f"{world_size} ranks")
    backend = resolve_backend(backend, device_type)
    device = rank_device(backend, device_type, local_rank, local_world)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method,
                                rank=rank, world_size=world_size)
    groups = {}
    if model > 1:
        for d in range(p):
            ranks = [d * model + m for m in range(model)]
            groups[("model", d)] = dist.new_group(ranks)
        for m in range(model):
            ranks = [d * model + m for d in range(p)]
            groups[("dp", m)] = dist.new_group(ranks)
    dp_rank, model_rank = divmod(rank, model)
    world = RankWorld(names, sizes, dp_rank, device, backend, model,
                      model_rank, groups.get(("model", dp_rank)),
                      groups.get(("dp", model_rank)))
    if shard_axis is None:
        return world
    ax = world._axis_index(shard_axis)
    probe = lambda r: dataclasses.replace(world, rank=r)
    pods = {}
    for r in range(p):          # every pod's members, in shard-axis order
        pods.setdefault(probe(r).pod_of(shard_axis), []).append(r)
    pod_groups, coord_groups = {}, {}
    for m in range(model):      # each model coordinate's torch ranks
        torch_rank = lambda d: d * model + m
        for e in sorted(pods):
            pod_groups[(e, m)] = dist.new_group(
                [torch_rank(d) for d in pods[e]])
        for c in range(sizes[ax]):
            coord_groups[(c, m)] = dist.new_group(
                [torch_rank(members[c]) for _, members in
                 sorted(pods.items())])
    return dataclasses.replace(
        world, shard_axis=shard_axis,
        coord_groups=tuple(coord_groups[(c, model_rank)]
                           for c in range(sizes[ax])),
        shard_group=pod_groups[(world.pod_of(shard_axis), model_rank)])


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _gather_leaves(world: RankWorld, tree, n: int, group=None,
                   dst: int = 0) -> Optional[list]:
    """The ``(1, ...)`` rows of each leaf from the ``n`` ranks of ``group``
    (the whole world by default) stacked on torch rank ``dst`` as ``(n,
    ...)`` CPU tensors in rank order (``None`` on the other ranks)."""
    out = []
    for leaf in tr.tree_leaves(tree):
        if leaf.shape[0] != 1:
            raise ValueError(f"a rank holds one row; got {tuple(leaf.shape)}")
        row = leaf[0].contiguous()
        if world.backend == "gloo":
            row = row.cpu()
        stacked = (torch.empty((n,) + tuple(row.shape), dtype=row.dtype,
                               device=row.device)
                   if world.torch_rank == dst else None)
        dist.gather(row, list(stacked.unbind(0)) if stacked is not None
                    else None, dst=dst, group=group)
        out.append(stacked.cpu() if stacked is not None else None)
    return out if world.torch_rank == dst else None


def gather_rows(world: RankWorld, tree):
    """Every dp rank's ``(1, ...)`` rows at this rank's model coordinate
    stacked on its dp rank 0 as ``(P, ...)`` CPU tensors (``None`` on the
    other ranks), leaf by leaf: at ``model`` 1 every rank's rows on rank
    0; with a model axis, each model coordinate's slices on its own."""
    out = _gather_leaves(world, tree, world.P, world.dp_group,
                         world.torch_rank_of(0))
    return None if out is None else tr.tree_unflatten(
        tr.tree_flatten(tree)[1], out)


def gather_world_rows(world: RankWorld, tree) -> Optional[tuple]:
    """Every torch rank's ``(1, ...)`` row of each leaf of ``tree`` (a
    tuple of buffers) stacked ``(P * model, ...)`` on torch rank 0 in
    torch-rank order, CPU tensors (``None`` on the other ranks)."""
    out = _gather_leaves(world, tree, world.P * world.model)
    return None if out is None else tuple(out)


def gather_model_slices(world: RankWorld, tree, dims):
    """Every rank's ``(1, ...)`` rows of its slices, rebuilt into whole
    ``(P, ...)`` CPU leaves on torch rank 0 (``None`` on the others) by
    the placement ``dims`` (``common.placement`` of the stacked tree):
    split leaves joined on their dim over the model ranks, whole ones
    taken from model rank 0.  At ``model`` 1, :func:`gather_rows`."""
    if world.model == 1:
        return gather_rows(world, tree)
    leaves = _gather_leaves(world, tree, world.P * world.model)
    if leaves is None:
        return None
    m = world.model
    per_rank = [tr.tree_unflatten(tr.tree_flatten(tree)[1],
                                  [a[r] for a in leaves])
                for r in range(world.P * m)]
    rows = [cm.join_slices(per_rank[d * m:(d + 1) * m],
                           tr.tree_map(lambda x: x - 1, dims))
            for d in range(world.P)]
    return tr.tree_map(lambda *xs: torch.stack(xs), *rows)
