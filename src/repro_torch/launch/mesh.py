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

The backend is the caller's explicit choice, never switched silently:
``nccl`` hands device tensors to the collectives and needs one card per
local rank (it raises otherwise: NCCL refuses two ranks on one card);
``gloo`` stages every exchange through host memory and lets the ranks share
a card (local rank r runs on card ``r % device_count``).  On the CPU
(``device_type="cpu"``) it is ``gloo``.

The reference's TPU v5e constants have no counterpart here.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import tree as tr

BACKENDS = ("nccl", "gloo")


@dataclass(frozen=True)
class RankWorld:
    """This process's place among the ranks.

    ``axis_names``/``axis_sizes`` are the dp axes minor to major; ``rank``
    is the global dp rank (the torch rank), ``coords`` its coordinate on
    each axis (mixed radix, minor first).
    """
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    rank: int
    device: torch.device
    backend: str

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError("axis_names/axis_sizes length mismatch")
        if not 0 <= self.rank < self.P:
            raise ValueError(f"rank {self.rank} outside a world of {self.P}")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; options: "
                             f"{BACKENDS}")

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


def init_rank_world(data: int, pod: Optional[int] = None, *,
                    backend: Optional[str] = None, device_type: str = "cuda",
                    init_method: str = "env://") -> RankWorld:
    """Join the process group torchrun describes (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``) and return this rank's world.
    ``data x pod`` must equal the world size."""
    names, sizes = dp_axes(data, pod)
    world_size = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    p = 1
    for s in sizes:
        p *= s
    if p != world_size:
        raise ValueError(f"dp axes {dict(zip(names, sizes))} hold {p} "
                         f"replicas; the world has {world_size} ranks")
    backend = resolve_backend(backend, device_type)
    device = rank_device(backend, device_type, local_rank, local_world)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method,
                                rank=rank, world_size=world_size)
    return RankWorld(names, sizes, rank, device, backend)


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def gather_rows(world: RankWorld, tree):
    """Every rank's ``(1, ...)`` rows stacked on rank 0 as ``(P, ...)``
    CPU tensors (``None`` on the other ranks), leaf by leaf."""
    out = []
    for leaf in tr.tree_leaves(tree):
        if leaf.shape[0] != 1:
            raise ValueError(f"a rank holds one row; got {tuple(leaf.shape)}")
        row = leaf[0].contiguous()
        if world.backend == "gloo":
            row = row.cpu()
        stacked = (torch.empty((world.P,) + tuple(row.shape),
                               dtype=row.dtype, device=row.device)
                   if world.rank == 0 else None)
        dist.gather(row, list(stacked.unbind(0)) if stacked is not None
                    else None, dst=0)
        out.append(stacked.cpu() if stacked is not None else None)
    if world.rank != 0:
        return None
    return tr.tree_unflatten(tr.tree_flatten(tree)[1], out)
