"""Topology-aware compiled averaging plans (DESIGN.md §9), replicated.

Counterpart of ``repro/core/plan.py``:

    topology = Topology.flat(("data",), (P,))      # or .hierarchical(...)
    plan     = compile_plan(topology, one_replica_tree, AveragingConfig(group_size=S))
    new      = plan.average(tree, phase)           # wait-avoiding group step
    new      = plan.sync(tree)                     # tau-periodic global step

``compile_plan`` runs once per (topology, config, tree structure, world),
cached, and precomputes what every step reuses: which link class each
butterfly bit rides, each class's bucket budget
(``choose_class_bucket_bytes``, the JAX package's cost model copied
exactly, since the layout depends on it) and each class's bucket layout.

Every collective goes through the plan's **wire**, three primitives (the
ppermutes and the pmean of the JAX plan):

* ``butterfly_exchange(buf, bit)``: the XOR partner's buffer for the global
  dp-rank ``bit``;
* ``ring_shift(buf, shift, n)``: the buffer of the rank ``shift`` behind
  in this rank's ring of ``n`` over the minor dp axis;
* ``pmean_rows(buf)`` (and ``sync_rows_``, in place): the mean over every
  replica, summed in float32 and scaled once by ``1/P``.

**Stacked rows** (compiled without a world, :data:`STACKED_WIRE`): the
replicas are the rows of one tensor, every leaf ``(P, ...)`` (the JAX
global layout); the exchange is a gather along dim 0 and the mean a mean
over dim 0.

**Ranks** (compiled over a ``launch.mesh.RankWorld``, :class:`RankWire`):
each process holds its own replica as ``(1, ...)`` leaves, as JAX's
``shard_map`` sees a ``(1, ...)`` block, and the primitives are
point-to-point ``torch.distributed`` ops (``batch_isend_irecv``) and a
float32 sum per bucket that adds the ranks in rank order, as the stacked
mean adds its rows (``all_to_all_single``, the adds, ``all_gather``).  On
gloo each exchange stages
through pinned host buffers (gloo takes CPU tensors); on nccl the device
buffers go to the wire as they are.  An exchange returns a receipt
(``overlap.Receipt``) at its tick of the wavefront (``core/overlap.py``)
and is waited on only right before its combine, so bucket k+1's payload is
on the wire while bucket k combines, as the reference's asynchronous
collective-permute does; the combines and their K1/K2 launches are those
of the stacked path.  The serial path (``overlap=False``) waits right
after it issues, and ``sync`` posts and waits at once.

Per element the arithmetic is the JAX plan's: the tree is cast to the
accumulation dtype (here while packing), ``log2(S)`` adds run in stage
order and the last combine scales by ``1/S``, so the fused path is
bit-identical to the per-leaf path and to the JAX plan under ``shard_map``
on every phase offset, and the average over ranks to the stacked one (a
rank adds ``own + partner`` where its partner adds ``partner + own``; fp32
addition commutes).  ``sync`` over ranks differs from the stacked mean only
in the order of the sum (pinned by tests).

The baselines' single-round ``mix`` runs its collective half through the
same wire; the combines are the averagers' own torch arithmetic in float32.

The serving KV transfer (``serve/kv_transfer.py``) prices its point-to-point
sends with :func:`link_transfer_seconds` on a link class, optionally with
the calibrated constants of ``LINK_CONSTANTS.json``
(:meth:`Topology.with_measured`).

**Sharded replicas** (DESIGN.md §10): ``compile_plan(..., sharding=
ShardingPolicy.fsdp_within_pod(axis))`` compiles the FSDP-within-pod
realisation.  The members of a pod (the ranks that differ only on the
shard axis) share one model; the state is the plan's shard-aligned bucket
buffers, one ``(P_eff, n_b)`` tensor a bucket, a row a pod.  Where the JAX
plan gives each device a column slice and composes an all-gather, a
reduce-scatter and a pod-to-pod butterfly on the slices, the stacked
realisation holds the global array on one device: ``unshard_tree`` reads a
pod's row, ``grad_shards`` is the float32 sum of the pod's members' packed
gradients times ``1/shard_size``, and ``average``/``sync``/``mix`` run the
replicated arithmetic over the ``P_eff`` rows (the butterfly's combines
through K1/K2).  Per element that is the JAX plan's arithmetic, so the
buffers agree with it bit for bit (pinned by tests).

Over a rank world (gather-all) each rank is one member of its pod and
holds the JAX plan's block, ``(1, n_b / shard_size)`` of every bucket:
``shard_tree`` slices it, ``unshard_tree`` is one tiled all-gather a
bucket over the pod's ranks (``RankWire.shard_all_gather``), and
``grad_shards`` packs this member's gradient in float32 and
reduce-scatters it, adding the members' slices in shard-axis order from
member 0's and scaling by ``1/shard_size``
(``RankWire.shard_reduce_scatter``), the one-card arithmetic bit for bit.
``average``/``sync``/``mix`` run on the pod view's wire
(``RankWorld.drop_axis``): the butterfly's bits, the ring and the mean
are in pod space, and the view's sums add the pods in pod order, as the
stacked mean adds its rows, times ``1/P_eff``.

**Layer-streamed replicas** (DESIGN.md §11): ``sharding=ShardingPolicy.
fsdp_within_pod(axis, streamed=True)`` compiles over the model's layered
tree ``{"stem", "layers", "head"}`` with a layer-aware shard layout (every
bucket in one ordered group: stem, span k, head).  ``stream_unshard(shards,
group, pod=)`` reads one group's buckets of a pod's row as views (the JAX
plan's per-group all-gather) and ``stream_grad_shards`` is the per-group
twin of ``grad_shards``; ``core/streaming.py`` walks them.

Over a rank world the streamed plan's ``stream_unshard`` posts one tiled
all-gather a bucket of the group and returns its receipt, and
``stream_grad_shards`` posts one reduce-scatter a bucket and returns
theirs: the engine resolves each where its schedule needs it (gather-all's
``unshard_tree``/``grad_shards`` resolve theirs at once).

Under a model axis a sharded plan is compiled over one model
coordinate's slice tree, and its shard collectives and pod view run over
that coordinate's groups (``launch/mesh.py``): each coordinate averages
its own slices, which is the whole rows' average element by element.

Not here: the step-time models (ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import json
import os
import time

import torch
import torch.distributed as dist

from repro_torch.core import bucketing, grouping, streaming
from repro_torch.core import overlap as pipeline
from repro_torch.core import tree as tr
from repro_torch.core.replica import REPLICATED, ShardingPolicy


# ---------------------------------------------------------------------------
# Link classes and topologies
# ---------------------------------------------------------------------------

# Default network constants (the JAX package's; Piz Daint-scale Aries).
DEFAULT_ALPHA = 20e-6          # seconds per collective launch
DEFAULT_BETA = 1.0 / 10e9      # seconds per wire byte
# Combine throughput: 2 reads + 1 write at P100-scale HBM (~700 GB/s) —
# seconds per *payload* byte per stage.
DEFAULT_GAMMA = 3.0 / 700e9


@dataclass(frozen=True)
class LinkClass:
    """One class of physical link with its own cost constants.

    ``alpha`` seconds per collective launch; ``beta`` seconds per wire
    byte; ``gamma`` combine seconds per payload byte; ``bucket_bytes`` pins
    this class's bucket budget, ``None`` lets
    :func:`choose_class_bucket_bytes` pick the modeled argmin.
    """
    name: str
    alpha: float = DEFAULT_ALPHA
    beta: float = DEFAULT_BETA
    gamma: float = DEFAULT_GAMMA
    bucket_bytes: Optional[int] = None


DEFAULT_LINK = LinkClass("link")
# The hierarchical defaults: the JAX package's model constants for an
# intra-pod (ICI) and an inter-pod (DCN) class, copied because bucket
# layouts depend on them.  They describe no link of the port's hardware.
ICI = LinkClass("ici", alpha=1e-6, beta=1.0 / 100e9)
DCN = LinkClass("dcn", alpha=50e-6, beta=1.0 / 10e9)

# The tracked calibration file at the repo root, the JAX package's one
# location of measured link constants (read as data; nothing of that
# package is imported).
DEFAULT_LINK_CONSTANTS_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))),
    "LINK_CONSTANTS.json")


@dataclass(frozen=True)
class Topology:
    """Frozen map from dp axes (minor-to-major) to link classes.

    Global dp-rank bit b lives on the axis whose cumulative log2 size spans
    b (``grouping.split_bit_over_axes``); ``axis_class[i]`` indexes
    ``link_classes`` for axis i.  On stacked rows the dp rank is the row,
    over ranks the torch rank.
    """
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    link_classes: Tuple[LinkClass, ...]
    axis_class: Tuple[int, ...]

    def __post_init__(self):
        if not (len(self.axis_names) == len(self.axis_sizes)
                == len(self.axis_class)):
            raise ValueError("axis_names/axis_sizes/axis_class length mismatch")
        for s in self.axis_sizes:
            grouping.ilog2(s)          # powers of two only
        for c in self.axis_class:
            if not 0 <= c < len(self.link_classes):
                raise ValueError(f"axis_class index {c} out of range")

    @classmethod
    def flat(cls, axis_names: Sequence[str], axis_sizes: Sequence[int],
             link: LinkClass = DEFAULT_LINK) -> "Topology":
        """Single link class for every axis."""
        names = tuple(axis_names)
        return cls(names, tuple(int(s) for s in axis_sizes), (link,),
                   (0,) * len(names))

    @classmethod
    def hierarchical(cls, axis_names: Sequence[str],
                     axis_sizes: Sequence[int], *,
                     dcn_axes: Sequence[str] = ("pod",),
                     ici: LinkClass = ICI,
                     dcn: LinkClass = DCN) -> "Topology":
        """Axes named in ``dcn_axes`` ride DCN; all others ride ICI."""
        names = tuple(axis_names)
        classes = tuple(1 if a in dcn_axes else 0 for a in names)
        if 1 not in classes:
            return cls.flat(names, axis_sizes, link=ici)
        return cls(names, tuple(int(s) for s in axis_sizes), (ici, dcn),
                   classes)

    @property
    def P(self) -> int:
        p = 1
        for s in self.axis_sizes:
            p *= s
        return p

    def class_of_bit(self, bit: int) -> int:
        ax, _ = grouping.split_bit_over_axes(bit, self.axis_sizes)
        return self.axis_class[ax]

    def link_of_bit(self, bit: int) -> LinkClass:
        return self.link_classes[self.class_of_bit(bit)]

    def axis_of_bit(self, bit: int) -> str:
        ax, _ = grouping.split_bit_over_axes(bit, self.axis_sizes)
        return self.axis_names[ax]

    def classes_in_use(self) -> Tuple[int, ...]:
        return tuple(sorted(set(self.axis_class)))

    def with_measured(self, path: Optional[str] = None) -> "Topology":
        """This topology with calibrated link constants loaded from disk.

        ``path`` defaults to :data:`DEFAULT_LINK_CONSTANTS_PATH`.  Per mesh
        axis the file holds a collective's launch latency ``alpha``, inverse
        wire bandwidth ``beta`` and combine rate ``gamma``, and optionally
        the all-gather's ``ag_alpha``/``ag_beta``.  Each link class takes
        the slowest measurement among its axes, the slower of the ppermute
        and all-gather numbers; classes with no measured axis keep their
        constants, and a pinned ``bucket_bytes`` survives.
        """
        with open(path or DEFAULT_LINK_CONSTANTS_PATH) as f:
            axes = json.load(f).get("axes", {})
        new_classes = []
        for ci, link in enumerate(self.link_classes):
            ms = [axes[a] for a, c in zip(self.axis_names, self.axis_class)
                  if c == ci and a in axes]
            if not ms:
                new_classes.append(link)
                continue
            new_classes.append(LinkClass(
                link.name + "@measured",
                alpha=max(max(float(m["alpha"]),
                              float(m.get("ag_alpha", 0.0))) for m in ms),
                beta=max(max(float(m["beta"]),
                             float(m.get("ag_beta", 0.0))) for m in ms),
                gamma=max(float(m.get("gamma", link.gamma)) for m in ms),
                bucket_bytes=link.bucket_bytes))
        return Topology(self.axis_names, self.axis_sizes,
                        tuple(new_classes), self.axis_class)

    def bottleneck(self) -> LinkClass:
        """The slowest-wire class — what a global collective is bound by."""
        return max(self.link_classes, key=lambda l: l.beta)

    def drop_axis(self, name: str) -> "Topology":
        """This topology minus one dp axis (the FSDP shard axis).

        The remaining axes keep their minor-to-major order and their link
        classes; the result is the *effective* (pod-level) replica space a
        sharded plan butterflies over.
        """
        if name not in self.axis_names:
            raise ValueError(f"axis {name!r} not in {self.axis_names}")
        keep = [i for i, a in enumerate(self.axis_names) if a != name]
        if not keep:
            raise ValueError("cannot drop the only dp axis")
        return Topology(tuple(self.axis_names[i] for i in keep),
                        tuple(self.axis_sizes[i] for i in keep),
                        self.link_classes,
                        tuple(self.axis_class[i] for i in keep))

    def describe(self) -> str:
        parts = []
        for i, link in enumerate(self.link_classes):
            axes = [f"{n}={s}" for n, s, c in
                    zip(self.axis_names, self.axis_sizes, self.axis_class)
                    if c == i]
            parts.append(f"{link.name}({', '.join(axes)}; "
                         f"a={link.alpha:.1e} b={link.beta:.1e})")
        return " | ".join(parts)


def ring_shift(buf: torch.Tensor, shift: int, n: int) -> torch.Tensor:
    """A ring ``ppermute`` over the minor dp axis of size ``n`` on stacked
    rows: JAX's perm ``(i, (i + shift) % n)`` delivers row i to row
    i + shift, so row j receives row ``j - shift`` of its ring
    (``torch.roll`` by ``+shift``).  The rows of one ring are consecutive,
    since the minor axis holds the low bits of the dp rank."""
    p = buf.shape[0]
    if p % n:
        raise ValueError(f"a ring of {n} does not tile {p} stacked replicas")
    rest = tuple(buf.shape[1:])
    return buf.reshape((p // n, n) + rest).roll(shift, 1).reshape(buf.shape)


def pmean_rows(buf: torch.Tensor) -> torch.Tensor:
    """A ``pmean`` over every replica on stacked rows: the mean over dim 0
    in every row of a new tensor."""
    return buf.mean(0, keepdim=True).expand_as(buf).contiguous()


def butterfly_exchange(buf: torch.Tensor, bit: int) -> torch.Tensor:
    """One butterfly stage on stacked rows: ``recv[i] = buf[i ^ (1 << bit)]``
    for the global dp-rank ``bit`` (a new tensor; ``buf`` is untouched)."""
    m = 1 << bit
    p = buf.shape[0]
    if p % (2 * m):
        raise ValueError(f"bit {bit} exceeds the {p} stacked replicas")
    # rows i and i ^ m are the two halves of a (2, m) block: swap them
    return buf.reshape((p // (2 * m), 2, m) + tuple(buf.shape[1:])).flip(1
           ).reshape(buf.shape)


# ---------------------------------------------------------------------------
# Wires: where the three primitives run
# ---------------------------------------------------------------------------

class StackedWire:
    """The primitives on stacked ``(P, ...)`` rows of one tensor (tensors,
    never receipts; no event log)."""
    events = None
    butterfly_exchange = staticmethod(butterfly_exchange)
    ring_shift = staticmethod(ring_shift)
    pmean_rows = staticmethod(pmean_rows)

    @staticmethod
    def sync_rows_(buf: torch.Tensor) -> torch.Tensor:
        """The float32 mean over dim 0 written into every row of ``buf``."""
        return buf.copy_(buf.mean(0, keepdim=True).expand_as(buf))


STACKED_WIRE = StackedWire()

# Host seconds and counts of every rank exchange so far: ``d2h_s`` and
# ``h2d_s`` the host's time staging (gloo on a card: the copy to pinned
# memory, which the send waits for, and the issue of the copy back),
# ``wire_s`` the exposed wait (the host blocked on a receipt's works or on
# a synchronous sum), ``bytes`` sent by this rank, ``ops`` collectives
# waited on; ``issued`` the receipts issued,
# ``in_flight_max`` the most pending at once (a running maximum),
# ``span_s`` the seconds with a receipt pending (from an issue that finds
# none to the resolve that leaves none).
_WIRE_STATS = {"d2h_s": 0.0, "wire_s": 0.0, "h2d_s": 0.0, "bytes": 0,
               "ops": 0, "issued": 0, "in_flight_max": 0, "span_s": 0.0}


def wire_stats() -> dict:
    return dict(_WIRE_STATS)


class _RankReceipt(pipeline.Receipt):
    """One exchange, sum or shard collective a :class:`RankWire` has
    posted: its works, where the delivery lands (``recv``, a host buffer
    when staged), how it becomes the tensor ``wait`` returns (``finish``),
    the host buffers it holds until then (``held``: (role, buffer) pairs),
    the buffer the wire reads (``sent``, kept alive until the wait) and the
    bytes it counts (``nbytes``; ``recv``'s where None)."""

    def __init__(self, wire, works, recv, finish, held=(), sent=None,
                 nbytes=None):
        self.wire, self.works, self.recv = wire, works, recv
        self.finish, self.held = finish, held
        self.sent, self.nbytes = sent, nbytes
        self.out = None

    def wait(self):
        if self.out is None:
            self.out = self.wire._resolve(self)
        return self.out


class RankWire:
    """The primitives over ``torch.distributed`` for one rank world: every
    buffer is this rank's own ``(1, ...)`` row.  Peers are dp ranks at
    this rank's model coordinate (its torch rank ``world.torch_rank_of``),
    and the sums run over its dp group, so with a model axis each
    model coordinate averages its own slices.

    ``butterfly_exchange``, ``ring_shift``, ``pmean_rows`` and the shard
    axis's ``shard_all_gather`` and ``shard_reduce_scatter`` post their
    ops and return a receipt (``overlap.Receipt``); its ``wait`` waits on
    the works and hands back the tensor.  ``n_slots`` is the most
    receipts pending at once so far: each holds its own host buffers (a
    slot) from posting to its wait.  ``sync_rows_`` posts and waits at
    once (the reference's tau-sync is a plain bucketed ``psum``).
    ``events``, a list where asked for (``None`` otherwise), gets the
    wavefronts' event logs (``overlap``).

    With gloo on a card (``world.stages_through_host``) each op stages
    through pinned host buffers, taken from a free list per (role, size,
    dtype) when it is posted and given back when it is resolved, so a
    buffer still on the wire is never written: the copy to the host runs
    on a side CUDA stream after an event recorded behind the buffer's
    producer, and the send is posted once it landed; the copy back runs
    on the side stream too and the caller's stream waits on its event,
    so the combine reads the delivery only after it landed, and the
    buffer is taken again only after that copy is done.  Otherwise (nccl
    on a card, gloo on the CPU) the buffers go to the wire as they are.
    """

    def __init__(self, world):
        self.world = world
        # (role, size, dtype) -> free pinned buffers, each beside the
        # event of its last copy back (None: nothing reads it)
        self._host: Dict[tuple, list] = {}
        self.n_slots = 0
        self.in_flight = 0
        self._since = 0.0
        self._side = None
        self.events: Optional[list] = None

    # -- receipts in flight and staging ------------------------------------
    def _post(self) -> None:
        if self.in_flight == 0:
            self._since = time.perf_counter()
        self.in_flight += 1
        self.n_slots = max(self.n_slots, self.in_flight)
        _WIRE_STATS["issued"] += 1
        _WIRE_STATS["in_flight_max"] = max(_WIRE_STATS["in_flight_max"],
                                           self.in_flight)

    def _take(self, role: str, like: torch.Tensor,
              numel: Optional[int] = None) -> torch.Tensor:
        """A pinned host buffer of ``like``'s dtype and size (``numel``
        elements where given) that nothing else holds: a given-back one,
        once its copy back is done, or a new one."""
        numel = like.numel() if numel is None else numel
        free = self._host.setdefault((role, numel, like.dtype), [])
        if not free:
            return torch.empty(numel, dtype=like.dtype, pin_memory=True)
        buf, done = free.pop()
        if done is not None:
            done.synchronize()
        return buf

    def _give(self, role: str, buf: torch.Tensor, done=None) -> None:
        self._host[(role, buf.numel(), buf.dtype)].append((buf, done))

    def _side_stream(self):
        if self._side is None:
            self._side = torch.cuda.Stream(device=self.world.device)
        return self._side

    def _to_host(self, host: torch.Tensor, buf: torch.Tensor
                 ) -> torch.Tensor:
        """``buf`` copied into the pinned ``host`` on the side stream,
        behind an event recorded on the caller's stream after ``buf``'s
        producer; returns once the copy has landed (the send reads it)."""
        t = time.perf_counter()
        src = buf.reshape(-1)
        ready = torch.cuda.Event()
        ready.record()
        side = self._side_stream()
        with torch.cuda.stream(side):
            side.wait_event(ready)
            host.copy_(src, non_blocking=True)
            landed = torch.cuda.Event()
            landed.record(side)
        src.record_stream(side)
        landed.synchronize()
        _WIRE_STATS["d2h_s"] += time.perf_counter() - t
        return host

    def _from_host(self, host: torch.Tensor, like: torch.Tensor,
                   shape=None):
        """A new device tensor on ``like``'s device, shaped like it (or
        ``shape``), holding ``host``, and the event of the copy: it runs
        on the side stream and the caller's stream waits for it."""
        t = time.perf_counter()
        side = self._side_stream()
        shape = tuple(like.shape) if shape is None else tuple(shape)
        with torch.cuda.stream(side):
            out = torch.empty(shape, dtype=host.dtype, device=like.device)
            out.copy_(host.view(shape), non_blocking=True)
            landed = torch.cuda.Event()
            landed.record(side)
        torch.cuda.current_stream().wait_event(landed)
        out.record_stream(torch.cuda.current_stream())
        _WIRE_STATS["h2d_s"] += time.perf_counter() - t
        return out, landed

    def _wait(self, works, sent: torch.Tensor,
              nbytes: Optional[int] = None) -> None:
        t = time.perf_counter()
        for w in works:
            w.wait()
        _WIRE_STATS["wire_s"] += time.perf_counter() - t
        _WIRE_STATS["bytes"] += (sent.numel() * sent.element_size()
                                 if nbytes is None else nbytes)
        _WIRE_STATS["ops"] += 1

    def _resolve(self, receipt: _RankReceipt) -> torch.Tensor:
        self._wait(receipt.works, receipt.recv, receipt.nbytes)
        out, done = receipt.finish(receipt.recv)
        receipt.sent = None
        for role, buf in receipt.held:      # a send buffer gloo has read
            self._give(role, buf, None if role == "send" else done)
        self.in_flight -= 1
        if self.in_flight == 0:
            _WIRE_STATS["span_s"] += time.perf_counter() - self._since
        return out

    # -- the primitives ----------------------------------------------------
    def _exchange(self, buf: torch.Tensor, send_to: int, recv_from: int):
        """Post the send of ``buf`` to dp rank ``send_to`` and the receive
        of what dp rank ``recv_from`` sends (shaped like ``buf``); returns
        its receipt (a copy of ``buf`` where both are this rank)."""
        rank = self.world.rank
        if send_to == rank and recv_from == rank:
            return buf.clone()
        send_to, recv_from = (self.world.torch_rank_of(send_to),
                              self.world.torch_rank_of(recv_from))
        src = buf.contiguous()
        held = ()
        if self.world.stages_through_host:
            send = self._to_host(self._take("send", src), src)
            recv = self._take("recv", src)
            held = (("send", send), ("recv", recv))
            finish = lambda recv: self._from_host(recv, src)
        else:
            send, recv = src, torch.empty_like(src)
            finish = lambda recv: (recv, None)
        self._post()
        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, send_to),
            dist.P2POp(dist.irecv, recv, recv_from)])
        return _RankReceipt(self, works, recv, finish, held)

    def butterfly_exchange(self, buf: torch.Tensor, bit: int):
        """The XOR partner's buffer (rank ``r ^ (1 << bit)``), as a
        receipt."""
        ax, local_bit = grouping.split_bit_over_axes(bit,
                                                     self.world.axis_sizes)
        coords = list(self.world.coords)
        coords[ax] ^= 1 << local_bit
        peer = self.world.rank_of(coords)
        return self._exchange(buf, peer, peer)

    def ring_shift(self, buf: torch.Tensor, shift: int, n: int):
        """Send to the rank ``shift`` ahead in this rank's ring of ``n``
        over the minor dp axis, receive from the rank ``shift`` behind (JAX's
        perm ``(i, (i + shift) % n)``); returns the receipt."""
        minor = self.world.axis_sizes[0]
        if minor % n:
            raise ValueError(f"a ring of {n} does not tile the minor axis of "
                             f"{minor} ranks")
        coords = list(self.world.coords)
        i = coords[0] % n
        base = coords[0] - i
        ahead, behind = list(coords), list(coords)
        ahead[0] = base + (i + shift) % n
        behind[0] = base + (i - shift) % n
        return self._exchange(buf, self.world.rank_of(ahead),
                              self.world.rank_of(behind))

    def _dp_group(self) -> dict:
        """The sums' group: the dp group where a model axis or a pod
        view makes one, else the whole world."""
        if self.world.dp_group is not None:
            return {"group": self.world.dp_group}
        if self.world.torch_ranks is not None:
            raise ValueError(
                f"a pod view's {self.world.P} ranks have no process group: "
                "start the world with init_rank_world(..., shard_axis=...)")
        return {}

    def _rows_on(self, host: torch.Tensor, k: int, like: torch.Tensor):
        """``host`` viewed as ``(k, n)`` rows on ``like``'s device (copied
        back through the side stream when staged) and the copy's event
        (``None`` where nothing was copied)."""
        rows = host.view(k, -1)
        if rows.device == like.device:
            return rows, None
        return self._from_host(host, like, rows.shape)

    def _ordered_post(self, buf: torch.Tensor):
        """Post the first half of a sum over the dp ranks in rank order
        (gloo's and nccl's all-reduces fix no order of the adds: at four
        ranks and more their float32 sum parts from the stacked mean's in
        the last bits): ``buf`` cut into P column blocks (zero-padded to a
        multiple of P), block q to dp rank q, one ``all_to_all_single``.  Returns the work, the delivery (every
        rank's block q, in rank order) and the host buffers it holds."""
        kw = self._dp_group()
        ranks = [self.world.torch_rank_of(r) for r in range(self.world.P)]
        if ranks != sorted(ranks):
            raise ValueError(f"dp ranks {ranks} are not in their process "
                             "group's order")
        n, p = buf.numel(), self.world.P
        flat = buf.reshape(-1)
        if n % p:
            flat = torch.cat([flat, flat.new_zeros(p - n % p)])
        if self.world.stages_through_host:
            src = self._to_host(self._take("send", flat), flat)
            recv = self._take("recv", flat)
            held = (("send", src), ("recv", recv))
        else:
            src, recv, held = flat.contiguous(), torch.empty_like(flat), ()
        return (dist.all_to_all_single(recv, src, async_op=True, **kw), recv,
                held)

    def _ordered_finish(self, recv: torch.Tensor, like: torch.Tensor):
        """The second half: this rank's block summed over the dp ranks in
        rank order (:func:`_sum_rows`), then every rank's block
        all-gathered.  Returns the sum shaped like ``like`` on its device
        and the event of the copy that read ``recv`` (``None`` where
        nothing was copied)."""
        p = self.world.P
        rows, done = self._rows_on(recv, p, like)
        block = _sum_rows(rows)
        if self.world.stages_through_host:
            src = self._to_host(self._take("send", block), block)
            out = self._take("gather", block, recv.numel())
        else:
            src = block
            out = torch.empty(recv.numel(), dtype=block.dtype,
                              device=block.device)
        work = dist.all_gather_into_tensor(out, src, async_op=True,
                                           **self._dp_group())
        self._wait([work], src,
                   (p - 1) * block.numel() * block.element_size())
        total, landed = self._rows_on(out, 1, like)
        if landed is not None:
            self._give("send", src)
            self._give("gather", out, landed)
        return total.reshape(-1)[:like.numel()].view(like.shape), done

    def sync_rows_(self, buf: torch.Tensor) -> torch.Tensor:
        """One float32 sum of ``buf`` over every dp rank in rank order,
        posted and waited at once, then one scale by ``1/P``, in place."""
        work, recv, held = self._ordered_post(buf)
        self._wait([work], recv, (self.world.P - 1) * recv.numel()
                   // self.world.P * recv.element_size())
        total, done = self._ordered_finish(recv, buf)
        buf.copy_(total)
        for role, host in held:
            self._give(role, host, None if role == "send" else done)
        return buf.mul_(1.0 / self.world.P)

    def pmean_rows(self, buf: torch.Tensor):
        """The mean over every dp rank in a new tensor (``sync_rows_``'s
        arithmetic); returns its receipt."""
        inv = 1.0 / self.world.P
        work, recv, held = self._ordered_post(buf)
        self._post()

        def finish(recv):
            out, done = self._ordered_finish(recv, buf)
            return out.mul_(inv), done
        return _RankReceipt(self, [work], recv, finish, held)

    # -- the shard axis's collectives (FSDP within a pod) ------------------
    def _shard_group(self, axis: str):
        """This rank's pod at its model coordinate (its members' torch
        ranks in shard-axis order) and the process-group keyword of its
        collectives: the pod's group, or none where the pod is the whole
        torch world (one pod, no model axis)."""
        members = self.world.shard_members(axis)
        if self.world.shard_axis == axis and self.world.shard_group:
            return members, {"group": self.world.shard_group}
        if len(members) != self.world.P * self.world.model:
            raise ValueError(
                f"a pod of {len(members)} ranks has no process group: start "
                f"the world with init_rank_world(..., shard_axis={axis!r})")
        return members, {}

    def shard_all_finite(self, finite: torch.Tensor, axis: str
                         ) -> torch.Tensor:
        """``finite`` (a bool) ANDed over the pod's ranks: one int32 MIN
        over its group (the reference's ``pmin`` over the shard axis)."""
        _, kw = self._shard_group(axis)
        flag = finite.to(dtype=torch.int32).reshape(1)
        flag = flag.cpu() if self.world.backend == "gloo" else flag.to(
            self.world.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN, **kw)
        return flag[0].bool()

    def shard_all_gather(self, buf: torch.Tensor, axis: str):
        """Post one tiled all-gather of this member's ``(n,)`` slice over
        its pod's group (the reference's ``all_gather(tiled=True)``);
        returns its receipt, whose wait gives the pod's members' slices
        joined in shard-axis order, ``(pod_size * n,)`` on ``buf``'s
        device."""
        members, kw = self._shard_group(axis)
        n, size = buf.numel(), len(members)
        src, held = buf.reshape(-1), ()
        if self.world.stages_through_host:
            src = self._to_host(self._take("send", buf), buf)
            out = self._take("gather", buf, size * n)
            held = (("send", src), ("gather", out))
        else:
            out = torch.empty(size * n, dtype=buf.dtype, device=buf.device)
        order = sorted(members)
        perm = (None if order == list(members)
                else [order.index(t) for t in members])

        def finish(out):
            rows, done = self._rows_on(out, size, buf)
            return (rows if perm is None else rows[perm]).reshape(-1), done
        self._post()
        work = dist.all_gather_into_tensor(out, src, async_op=True, **kw)
        return _RankReceipt(self, [work], out, finish, held, src,
                            (size - 1) * n * buf.element_size())

    def shard_reduce_scatter(self, buf: torch.Tensor, axis: str):
        """Post the reduce-scatter of this member's ``(pod_size * n,)``
        float32 buffer over its pod; returns its receipt, whose wait gives
        this member's ``(n,)`` slice of the pod's members' sum, added in
        shard-axis order from member 0's (:func:`_sum_rows`), a new tensor
        on ``buf``'s device (not yet scaled).  gloo's ``reduce_scatter``
        fixes no order, so it is one ``all_to_all_single`` (slice k to
        member k) and the sum at the wait."""
        members, kw = self._shard_group(axis)
        size = len(members)
        order = sorted(members)
        cols = buf.reshape(size, -1)
        if order != list(members):
            cols = cols[[members.index(t) for t in order]]
        src, held = cols.reshape(-1), ()
        if self.world.stages_through_host:
            src = self._to_host(self._take("send", buf), src)
            out = self._take("scatter", buf)
            held = (("send", src), ("scatter", out))
        else:
            src = src.contiguous()
            out = torch.empty_like(src)
        perm = (None if order == list(members)
                else [order.index(t) for t in members])

        def finish(out):
            rows, done = self._rows_on(out, size, buf)
            return _sum_rows(rows if perm is None else rows[perm]), done
        self._post()
        work = dist.all_to_all_single(out, src, async_op=True, **kw)
        return _RankReceipt(self, [work], out, finish, held, src,
                            (size - 1) * (buf.numel() // size)
                            * buf.element_size())


def _sum_rows(rows: torch.Tensor) -> torch.Tensor:
    """The sum of a ``(k, n)`` tensor's rows in row order, starting from a
    copy of row 0: the stacked mean's and the one-card ``grad_shards``'
    order of float32 adds."""
    acc = rows[0].clone()
    for r in rows[1:]:
        acc.add_(r)
    return acc


_WIRES: Dict[object, RankWire] = {}


def wire_for(world):
    """The wire a plan over ``world`` runs on (:data:`STACKED_WIRE` for
    ``None``); one per world, so that its host buffers are shared."""
    if world is None:
        return STACKED_WIRE
    wire = _WIRES.get(world)
    if wire is None:
        wire = _WIRES[world] = RankWire(world)
    return wire


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AveragingConfig:
    """Everything about the averaging math that is not the topology.

    ``bucket_bytes`` is a global override of every class's budget.  The
    fused path always combines through K1/K2 (``kernels/ops.py`` picks the
    kernel or its plain version by device).
    """
    group_size: Optional[int] = None      # None -> sqrt(P) rounded to pow2
    tau: int = 10                         # global sync period (paper §V-B)
    average_dtype: Optional[str] = "float32"   # accumulation dtype
    dynamic_groups: bool = True           # False -> fixed groups (ablation 2)
    fused: bool = True                    # bucketed flat-buffer path
    bucket_bytes: Optional[int] = None    # global budget override
    overlap: bool = True                  # wavefront bucket pipeline (§8)


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


# ---------------------------------------------------------------------------
# Per-class cost model + budget choice (copied exactly: layouts depend on it)
# ---------------------------------------------------------------------------

def class_stage_seconds(payload_bytes: float, link: LinkClass,
                        n_buckets: int, *, overlap: bool = True) -> float:
    """Modeled seconds for ONE butterfly stage on ``link`` with B buckets."""
    wire = payload_bytes * link.beta
    combine = payload_bytes * link.gamma
    if overlap:
        return pipeline.overlapped_stage_seconds(wire, combine, n_buckets,
                                                 link.alpha)
    return max(n_buckets, 1) * link.alpha + wire + combine


@lru_cache(maxsize=None)
def choose_class_bucket_bytes(
        payload_bytes: int, link: LinkClass, *, overlap: bool = True,
        candidates: Tuple[int, ...] = bucketing.BUCKET_BYTES_CANDIDATES
        ) -> int:
    """Bucket budget minimising THIS link class's modeled stage time."""
    if link.bucket_bytes is not None:
        return link.bucket_bytes
    payload = max(int(payload_bytes), 1)
    best, best_t = None, None
    for cand in candidates:
        n_buckets = max(1, -(-payload // cand))
        t = class_stage_seconds(payload, link, n_buckets, overlap=overlap)
        if best_t is None or t < best_t:
            best, best_t = cand, t
    return best


def link_transfer_seconds(payload_bytes: float, link: LinkClass, *,
                          message_bytes: Optional[int] = None) -> float:
    """Modeled seconds to move ``payload_bytes`` point-to-point on ``link``:
    one ``alpha`` per message plus the wire time, the payload packed into
    ``message_bytes``-sized messages (``None``: this link's non-overlapped
    budget from :func:`choose_class_bucket_bytes`, as the KV transfer
    packs).  A model of the link class, not a time of any machine."""
    payload = max(int(payload_bytes), 0)
    if payload == 0:
        return 0.0
    if message_bytes is None:
        message_bytes = choose_class_bucket_bytes(payload, link,
                                                  overlap=False)
    n_messages = max(1, -(-payload // int(message_bytes)))
    return n_messages * link.alpha + payload * link.beta


# ---------------------------------------------------------------------------
# Combines
# ---------------------------------------------------------------------------

def _stage_combine(acc, recv, scale: float):
    """(acc + recv) * scale through K1, in place into ``acc``."""
    from repro_torch.kernels import ops
    return ops.group_average_combine(acc, recv, scale, out=acc)


def _combine_many(accs, recvs, scale: float):
    """Batch of independent (acc, recv) combines — one wavefront tick.

    Groups the batch by dtype and feeds each group to ONE K2 launch (K1 for
    a single pair), in place into the accumulators.
    """
    from repro_torch.kernels import ops
    outs = [None] * len(accs)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, a in enumerate(accs):
        by_dtype.setdefault(a.dtype, []).append(i)
    for idxs in by_dtype.values():
        group = [accs[i] for i in idxs]
        res = ops.group_average_combine_multi(
            group, [recvs[i] for i in idxs], scale, outs=group)
        for i, o in zip(idxs, res):
            outs[i] = o
    return outs


# ---------------------------------------------------------------------------
# The compiled plan
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class StageRun:
    """A maximal run of consecutive butterfly stages on one link class."""
    class_index: int
    bits: Tuple[int, ...]


class AveragingPlan:
    """Compiled realisation of group + global averaging on one topology.

        plan.average(tree, phase)    group butterfly for a phase index
        plan.sync(tree)              tau-periodic global mean

    on the trees of its wire (stacked ``(P, ...)`` rows, or this rank's
    ``(1, ...)`` row), plus the stacked-simulator twins
    (``average_stacked``/``sync_stacked``) and accounting (``describe``,
    ``butterfly_summary``).
    """

    def __init__(self, topology: Topology, cfg: AveragingConfig,
                 storage_struct, work_struct, payload_bytes: int,
                 sharding: ShardingPolicy = REPLICATED, world=None):
        self.topology = topology
        self.cfg = cfg
        self.sharding = sharding
        if world is not None and tuple(world.axis_sizes) != \
                topology.axis_sizes:
            raise ValueError(f"rank world axes {world.axis_sizes} do not "
                             f"match the topology's {topology.axis_sizes}")
        self.world = world
        self.P = topology.P
        # Sharded plans butterfly over the *effective* (pod-level) replica
        # space: the shard axis's ranks share weights and act as ONE
        # logical WAGMA worker (DESIGN.md §10).
        if sharding.is_sharded:
            if sharding.shard_axis not in topology.axis_names:
                raise ValueError(
                    f"shard_axis {sharding.shard_axis!r} not a dp axis of "
                    f"{topology.axis_names}")
            self.shard_axis_index = topology.axis_names.index(
                sharding.shard_axis)
            self.shard_size = topology.axis_sizes[self.shard_axis_index]
            shard_link = topology.link_classes[
                topology.axis_class[self.shard_axis_index]]
            if len(topology.classes_in_use()) > 1 and \
                    shard_link.beta >= topology.bottleneck().beta:
                raise ValueError(
                    f"shard_axis {sharding.shard_axis!r} rides the "
                    f"bottleneck link class {shard_link.name!r}; FSDP "
                    "shards over an intra-pod (ICI) axis")
            self.eff_topology = topology.drop_axis(sharding.shard_axis)
        else:
            self.shard_axis_index = None
            self.shard_size = 1
            self.eff_topology = topology
        # over ranks a sharded plan averages pod to pod on the pod view
        # (its shard collectives run on the whole world's wire)
        self.shard_wire = wire_for(world)
        self.wire = wire_for(
            world.drop_axis(sharding.shard_axis)
            if world is not None and sharding.is_sharded else world)
        self.P_eff = self.eff_topology.P
        self.S = cfg.group_size or grouping.default_group_size(self.P_eff)
        if self.S > self.P_eff:
            raise ValueError(f"group size {self.S} exceeds replica world "
                             f"{self.P_eff}")
        self.avg_dtype = (None if cfg.average_dtype is None
                          else _DTYPES[cfg.average_dtype])
        if cfg.dynamic_groups:
            self.offsets: Tuple[int, ...] = grouping.distinct_offsets(
                self.P_eff, self.S)
        else:
            self.offsets = (0,)
        self.storage_struct = storage_struct    # Spec tree, storage dtypes
        self.work_struct = work_struct          # Spec tree, accumulation dtype
        self.payload_bytes = payload_bytes      # bytes of the work tree
        self.class_bucket_bytes: Dict[int, int] = {}
        for ci in topology.classes_in_use():
            if cfg.bucket_bytes is not None:
                self.class_bucket_bytes[ci] = cfg.bucket_bytes
            else:
                self.class_bucket_bytes[ci] = choose_class_bucket_bytes(
                    payload_bytes, topology.link_classes[ci],
                    overlap=cfg.overlap)
        self.sync_bucket_bytes = (cfg.bucket_bytes
                                  or bucketing.DEFAULT_BUCKET_BYTES)
        self._runs: Dict[int, Tuple[StageRun, ...]] = {}
        self._shard_layout: Optional[bucketing.BucketLayout] = None
        # layer-streamed state layout (DESIGN.md §11): the ordered leaf
        # groups come from the layered tree convention up front, so a
        # non-layered tree fails at compile time, not at the first gather
        if sharding.is_sharded and sharding.streamed:
            self._stream_groups = streaming.layered_leaf_groups(
                storage_struct)
            self.n_stream_spans = len(storage_struct["layers"])
        else:
            self._stream_groups = None
            self.n_stream_spans = 0
        self._stream_sublayouts: Dict[int, bucketing.BucketLayout] = {}
        # the non-empty buckets stream_unshard has read (one pod's read
        # serves all its members, as one device's gather does in JAX)
        self.stream_gathers = 0
        # a list where asked for (None otherwise): each streamed fwd+bwd's
        # event log (streaming.check_stream_event_log)
        self.stream_log: Optional[list] = None

    # -- static schedule ---------------------------------------------------
    @property
    def n_phases(self) -> int:
        return len(self.offsets)

    def runs_for_offset(self, offset: int) -> Tuple[StageRun, ...]:
        """The offset's stages as maximal runs of equal link class; bits
        in the effective replica space (the pod-level one, shard axis
        dropped, for sharded plans)."""
        cached = self._runs.get(offset)
        if cached is not None:
            return cached
        bits = grouping.mask_bits_for_offset(self.P_eff, self.S, offset)
        runs: List[StageRun] = []
        for bit in bits:
            ci = self.eff_topology.class_of_bit(bit)
            if runs and runs[-1].class_index == ci:
                runs[-1] = StageRun(ci, runs[-1].bits + (bit,))
            else:
                runs.append(StageRun(ci, (bit,)))
        self._runs[offset] = tuple(runs)
        return self._runs[offset]

    def class_layout(self, class_index: int) -> bucketing.BucketLayout:
        """The (cached) bucket layout the class's stages pack into."""
        return bucketing.layout_for(
            self.work_struct,
            max_bucket_bytes=self.class_bucket_bytes[class_index])

    # -- sharded-state layout (ShardingPolicy.fsdp_within_pod) -------------
    @property
    def shard_layout(self) -> bucketing.BucketLayout:
        """Storage-dtype bucket layout the sharded state persists in.

        Every bucket is padded to shard_size x 128 elements, so that each of
        the pod's devices owns an equal, lane-aligned slice in the JAX
        package.  One layout serves storage, the gather, the gradient
        reduction and the pod-to-pod butterfly (the stage bits all ride the
        non-shard axes: no repack between runs).
        """
        if not self.sharding.is_sharded:
            raise ValueError("shard_layout is only defined for sharded plans")
        if self._shard_layout is None:
            self._shard_layout = bucketing.layout_for(
                self.storage_struct,
                max_bucket_bytes=self.shard_bucket_bytes,
                align=self.shard_size,
                groups=self._stream_groups)
        return self._shard_layout

    @property
    def shard_bucket_bytes(self) -> int:
        """The sharded state's bucket budget: the butterfly link class's."""
        if self.cfg.bucket_bytes is not None:
            return self.cfg.bucket_bytes
        eff_classes = self.eff_topology.classes_in_use()
        link_ci = max(eff_classes,
                      key=lambda ci: self.topology.link_classes[ci].beta)
        return self.class_bucket_bytes[link_ci]

    def shard_struct(self) -> tuple:
        """Specs of one device's owned shard slices in the JAX package
        (each bucket's ``1/shard_size``)."""
        lay = self.shard_layout
        return tuple(tr.Spec((s // self.shard_size,), d)
                     for s, d in zip(lay.bucket_sizes, lay.bucket_dtypes))

    @property
    def _over_ranks(self) -> bool:
        return self.world is not None and self.sharding.is_sharded

    def shard_tree(self, stacked_tree) -> tuple:
        """``(P_eff, ...)`` pod trees -> the ``(P_eff, n_b)`` shard
        buffers (new tensors): the stacked twin of the JAX plan's pack and
        slice of each device's share.  Over ranks, this rank's pod's
        ``(1, ...)`` tree -> its ``(1, n_b / shard_size)`` slices."""
        bufs = bucketing.pack(stacked_tree, self.shard_layout)
        if not self._over_ranks:
            return bufs
        s = self.world.shard_coord(self.sharding.shard_axis)
        out = []
        for b in bufs:
            n = b.shape[-1] // self.shard_size
            out.append(b[..., s * n:(s + 1) * n].clone())
        return tuple(out)

    def _rank_pod(self, pod: Optional[int]) -> str:
        """The shard axis, once ``pod`` (None: any) is this rank's pod."""
        axis = self.sharding.shard_axis
        if pod not in (None, self.world.pod_of(axis)):
            raise ValueError(f"rank {self.world.rank} holds pod "
                             f"{self.world.pod_of(axis)}, not {pod}")
        return axis

    def _all_gather(self, buf: torch.Tensor, axis: str):
        """The receipt of one tiled all-gather of a rank's ``(1, n)``
        slice over its pod (a zero-size slice as it is)."""
        if not buf.numel():
            return buf.reshape(-1)
        return self.shard_wire.shard_all_gather(buf, axis)

    def _reduce_scatter(self, buf: torch.Tensor):
        """The receipt of one float32 bucket's reduce-scatter over this
        rank's pod, scaled by ``1/shard_size`` once it lands (a zero-size
        bucket as it is)."""
        if not buf.numel():
            return buf
        inv = 1.0 / self.shard_size
        return pipeline.Mapped(self.shard_wire.shard_reduce_scatter(
            buf, self.sharding.shard_axis), lambda t: t.mul_(inv))

    def unshard_tree(self, shards, pod: Optional[int] = None):
        """Shard buffers -> pod ``pod``'s full tree (the JAX plan's
        all-gather over the shard axis), its leaves views into the pod's
        row; with no ``pod``, every pod's tree stacked ``(P_eff, ...)``.
        Over ranks one tiled all-gather a bucket of this rank's ``(1, n)``
        slices over its pod's ranks, each resolved as soon as it is
        posted: its pod's tree (``(1, ...)`` with no ``pod``)."""
        if self._over_ranks:
            axis = self._rank_pod(pod)
            rows = tuple(pipeline.resolve(self._all_gather(b, axis))
                         for b in shards)
            if pod is None:
                rows = tuple(r[None] for r in rows)
            return bucketing.unpack(rows, self.shard_layout)
        rows = shards if pod is None else tuple(b[pod] for b in shards)
        return bucketing.unpack(rows, self.shard_layout)

    def grad_shards(self, member_grads) -> tuple:
        """One pod's members' full-tree gradients -> its float32 grad
        buffers (the pod mean).

        ``member_grads`` yields each member's gradient tree in rank order
        (a generator keeps one member's gradients alive at a time).  The
        first is packed in float32, each next one added into those buffers
        leaf by leaf, and the sum scaled by ``1/shard_size``: the JAX plan's
        tiled ``psum_scatter`` times ``1/shard_size``, every device's slice
        at once.  Returns ``(n_b,)`` buffers.  Over ranks it yields this
        member's alone, packed in float32 and reduce-scattered over its pod
        (``RankWire.shard_reduce_scatter``: the same adds in the same
        order), each bucket's resolved as soon as it is posted: this rank's
        ``(n_b / shard_size,)`` slices.
        """
        bufs = self._pod_mean(member_grads, self.shard_layout)
        if not self._over_ranks:
            return bufs
        return tuple(pipeline.resolve(self._reduce_scatter(b)) for b in bufs)

    def _pod_mean(self, member_grads, layout) -> tuple:
        """``member_grads`` packed through ``layout`` in float32 and
        summed in rank order, times ``1/shard_size``; over ranks this
        member's alone, packed (the caller reduce-scatters it)."""
        acc, n = None, 0
        for g in member_grads:
            if acc is None:
                acc = bucketing.pack(g, layout, dtype=torch.float32)
            else:
                bucketing.pack_add_(g, layout, acc)
            n += 1
            del g
        if acc is None:
            raise ValueError("a pod with no members")
        if not self._over_ranks:
            return tuple(b.mul_(1.0 / self.shard_size) for b in acc)
        if n != 1:
            raise ValueError(f"over ranks a pod mean takes this member's "
                             f"gradients alone, got {n} members'")
        return acc

    # -- layer-streamed gather/scatter (DESIGN.md §11) ---------------------
    def _require_streamed(self):
        if self._stream_groups is None:
            raise ValueError(
                "stream_* needs a streamed plan: compile with "
                "ShardingPolicy.fsdp_within_pod(axis, streamed=True) over "
                "the layered param tree")

    def stream_bucket_indices(self, group: int) -> Tuple[int, ...]:
        """Global bucket indices holding one stream group's leaves."""
        self._require_streamed()
        return self.shard_layout.group_bucket_indices(group)

    def stream_group_template(self, group: int):
        """The group's sub-Spec-tree of the layered storage struct."""
        self._require_streamed()
        if group == streaming.STEM_GROUP:
            return self.storage_struct["stem"]
        if group == streaming.head_group(self.n_stream_spans):
            return self.storage_struct["head"]
        return self.storage_struct["layers"][group - 1]

    def stream_sublayout(self, group: int) -> bucketing.BucketLayout:
        """Pack/unpack layout of ONE group's buckets (a layout view).

        The grouped global layout restarts its greedy fill at every group
        boundary, so laying out the group's sub-tree alone at the same
        budget and alignment gives exactly the global layout's slice for
        that group: asserted here once per group, then cached.
        """
        self._require_streamed()
        lay = self._stream_sublayouts.get(group)
        if lay is not None:
            return lay
        lay = bucketing.layout_for(
            self.stream_group_template(group),
            max_bucket_bytes=self.shard_bucket_bytes, align=self.shard_size)
        idxs = self.stream_bucket_indices(group)
        glob = self.shard_layout
        if (lay.n_buckets != len(idxs)
                or tuple(lay.bucket_sizes) != tuple(
                    glob.bucket_sizes[i] for i in idxs)
                or tuple(lay.bucket_dtypes) != tuple(
                    glob.bucket_dtypes[i] for i in idxs)):
            raise AssertionError(
                f"group {group} sublayout diverged from the global grouped "
                f"layout: {lay.describe()} vs global buckets {idxs}")
        self._stream_sublayouts[group] = lay
        return lay

    def stream_unshard(self, shards, group: int, *, pod: int,
                       barrier: bool = False):
        """One group's buckets of pod ``pod``'s row -> its sub-tree, leaves
        views into the row (the JAX plan's per-group all-gather, as
        :meth:`unshard_tree` reads a pod's whole row).  Over ranks
        ``pod`` is this rank's: one tiled all-gather a bucket of its
        ``(1, n)`` slices over the pod's ranks is posted, and the receipt
        returned (``overlap.resolve`` makes it the sub-tree, views into
        the gathered rows).

        ``barrier`` is the JAX plan's fence against CSE of a backward
        re-gather with the forward one; eager PyTorch has nothing to
        fence, and the keyword keeps the engine the reference's.
        """
        self._require_streamed()
        idxs = self.stream_bucket_indices(group)
        lay = self.stream_sublayout(group)
        self.stream_gathers += sum(1 for i in idxs if shards[i].numel())
        if self._over_ranks:
            axis = self._rank_pod(pod)
            return pipeline.Mapped(
                tuple(self._all_gather(shards[i], axis) for i in idxs),
                lambda rows: bucketing.unpack(rows, lay))
        return bucketing.unpack(tuple(shards[i][pod] for i in idxs), lay)

    def stream_grad_shards(self, member_grads, group: int) -> tuple:
        """One group's gradients of a pod's members -> its float32 grad
        buffers (the pod mean), the per-group twin of :meth:`grad_shards`.

        ``member_grads`` yields each member's gradient sub-tree of the
        group in rank order.  The first is packed in float32, each next
        one added into those buffers leaf by leaf, and the sum scaled by
        ``1/shard_size``: per element the gather-all path's arithmetic, so
        streamed gradients are bit-identical to it.  Returns the group's
        ``(n_b,)`` buffers in its bucket order.  Over ranks it yields this
        member's alone, and each bucket's reduce-scatter is posted: a
        receipt a bucket (``overlap.resolve`` makes them this rank's
        ``(n_b / shard_size,)`` slices, scaled).
        """
        self._require_streamed()
        bufs = self._pod_mean(member_grads, self.stream_sublayout(group))
        if not self._over_ranks:
            return bufs
        return tuple(self._reduce_scatter(b) for b in bufs)

    def stream_group_bytes(self) -> Dict[int, int]:
        """Gathered (padded storage) bytes per stream group."""
        self._require_streamed()
        lay = self.shard_layout
        return {g: lay.group_bytes(g) for g in sorted(set(lay.bucket_groups))}

    def stream_peak_gathered_bytes(self) -> int:
        """Peak gathered bytes of the streamed schedule (liveness walk)."""
        self._require_streamed()
        return streaming.max_in_flight_gathered_bytes(
            self.stream_group_bytes(), self.n_stream_spans)

    def full_gathered_bytes(self) -> int:
        """Transient bytes of a gather-all unshard (every padded bucket)."""
        lay = self.shard_layout
        return sum(s * d.itemsize
                   for s, d in zip(lay.bucket_sizes, lay.bucket_dtypes))

    # -- execution: the paper's group butterfly ----------------------------
    def average(self, tree, phase: int):
        """Wait-avoiding group model averaging for phase index ``phase``.

        Replicated plans take (and return) the stacked params tree; sharded
        plans take the tuple of ``(P_eff, n_b)`` shard buffers and
        butterfly them pod to pod."""
        return self.average_offset(tree, self.offsets[phase])

    def _cast_shards(self, shards):
        if self.avg_dtype is None:
            return list(shards)
        return [b.to(self.avg_dtype, copy=True) if b.numel() else b
                for b in shards]

    def _uncast_shards(self, work, shards):
        return tuple(w.to(b.dtype) for w, b in zip(work, shards))

    def _average_sharded(self, shards, offset: int):
        """Pod-to-pod butterfly on the ``(P_eff, n_b)`` shard buffers.

        Per element the arithmetic is exactly the replicated plan's:
        log2(S) adds in stage order, then one scale, through K1/K2 in the
        accumulation dtype; so the sharded path is bit-identical to the
        replicated plan over ``eff_topology`` on the unpacked pod rows.
        Returns new buffers; ``shards`` is not modified.
        """
        bits = grouping.mask_bits_for_offset(self.P_eff, self.S, offset)
        inv_s = 1.0 / self.S
        exchange = self.wire.butterfly_exchange
        work = self._cast_shards(shards)
        if self.cfg.overlap:
            work = pipeline.overlapped_butterfly(
                work, bits, inv_s, exchange=exchange,
                combine_many=_combine_many,
                log=getattr(self.wire, "events", None))
        else:
            out = []
            for buf in work:
                if buf.numel():
                    for i, bit in enumerate(bits):
                        recv = pipeline.resolve(exchange(buf, bit))
                        s = inv_s if i == len(bits) - 1 else 1.0
                        buf = _stage_combine(buf, recv, s)
                out.append(buf)
            work = out
        return self._uncast_shards(work, shards)

    def average_offset(self, tree, offset: int):
        """Group averaging for an explicit phase offset.

        Returns a new tree; ``tree`` is not modified."""
        if self.sharding.is_sharded:
            return self._average_sharded(tree, offset)
        bits = grouping.mask_bits_for_offset(self.P_eff, self.S, offset)
        inv_s = 1.0 / self.S
        exchange = self.wire.butterfly_exchange

        if not self.cfg.fused:
            def avg_leaf(w):
                acc = w.to(self.avg_dtype) if self.avg_dtype is not None \
                    else w
                for bit in bits:
                    acc = acc + pipeline.resolve(exchange(acc, bit))
                return (acc * inv_s).to(w.dtype)

            return tr.tree_map(avg_leaf, tree)

        runs = self.runs_for_offset(offset)
        # Cast once (while packing) and keep the accumulation dtype across
        # runs, so multi-class butterflies stay bit-identical to the
        # per-leaf reference.
        work = tree
        for ri, run in enumerate(runs):
            scale = inv_s if ri == len(runs) - 1 else 1.0
            layout = self.class_layout(run.class_index)
            bufs = bucketing.pack(work, layout, dtype=self.avg_dtype)
            if self.cfg.overlap:
                bufs = pipeline.overlapped_butterfly(
                    bufs, run.bits, scale, exchange=exchange,
                    combine_many=_combine_many,
                log=getattr(self.wire, "events", None))
            else:
                def mix(acc, run=run, scale=scale):
                    for i, bit in enumerate(run.bits):
                        recv = pipeline.resolve(exchange(acc, bit))
                        s = scale if i == len(run.bits) - 1 else 1.0
                        acc = _stage_combine(acc, recv, s)
                    return acc
                bufs = [mix(b) if b.numel() else b for b in bufs]
            work = bucketing.unpack(bufs, layout, cast=False)
        return tr.tree_map(lambda w, o: w.to(o.dtype), work, tree)

    # -- execution: tau-periodic global sync -------------------------------
    def sync(self, tree):
        """Synchronous mean over all replicas (Alg. 2 line 16), in float32,
        written back to every row (every rank).

        Sharded plans average each shard buffer's ``P_eff`` pod rows only:
        the shard axis's members hold one model, not divergent copies."""
        mean_rows = self.wire.sync_rows_
        if self.sharding.is_sharded:
            return tuple(mean_rows(b.to(torch.float32, copy=True)).to(b.dtype)
                         if b.numel() else b for b in tree)
        if not self.cfg.fused:
            return tr.tree_map(lambda w: mean_rows(w.float().clone()).to(
                w.dtype), tree)
        return bucketing.tree_map_bucketed(
            mean_rows, tree, compute_dtype=torch.float32,
            max_bucket_bytes=self.sync_bucket_bytes)

    # -- execution: single-round gossip/psum mixes (baseline averagers) ----
    def mix_bucket_bytes(self, bits: Tuple[int, ...] = ()) -> int:
        """Budget for a single-round mix touching the given dp-rank bits:
        the slowest wire among their link classes (every class for a
        global collective, ``bits=()``)."""
        if self.cfg.bucket_bytes is not None:
            return self.cfg.bucket_bytes
        if bits:
            classes = {self.eff_topology.class_of_bit(b) for b in bits}
            link = max((self.topology.link_classes[c] for c in classes),
                       key=lambda l: l.beta)
        else:
            link = self.eff_topology.bottleneck()
        return choose_class_bucket_bytes(self.payload_bytes, link,
                                         overlap=self.cfg.overlap)

    def mix(self, tree, issue: Callable, combine: Callable, *,
            bits: Tuple[int, ...] = ()):
        """Apply a float32 gossip/psum mix to a tree, per bucket (fused) or
        per leaf, and return a new tree in the storage dtypes.

        ``issue(buf) -> recv`` is the collective half on a whole buffer,
        through the plan's wire (``wire.pmean_rows``, ``wire.ring_shift``,
        ``wire.butterfly_exchange``; over ranks a receipt, resolved right
        before its combine), ``combine(buf, recv) -> buf`` the local
        arithmetic; every granularity computes the same element math.
        With ``overlap=True`` every bucket's collectives are issued before
        any bucket's combine (``overlap.overlapped_mix``).  Sharded plans
        mix the shard buffers' pod rows directly (``bits`` in pod space).
        """
        mixfn = lambda buf: combine(buf, pipeline.resolve(issue(buf)))
        if self.sharding.is_sharded:
            work = [b.float() if b.numel() else b for b in tree]
            if self.cfg.overlap:
                out = pipeline.overlapped_mix(work, issue, combine)
            else:
                out = [mixfn(b) if b.numel() else b for b in work]
            return tuple(o.to(b.dtype) for o, b in zip(out, tree))
        if not self.cfg.fused:
            return tr.tree_map(lambda w: mixfn(w.float()).to(w.dtype), tree)
        budget = self.mix_bucket_bytes(tuple(bits))
        if not self.cfg.overlap:
            return bucketing.tree_map_bucketed(
                mixfn, tree, compute_dtype=torch.float32,
                max_bucket_bytes=budget)
        return bucketing.tree_map_buckets(
            lambda bufs: pipeline.overlapped_mix(bufs, issue, combine),
            tree, compute_dtype=torch.float32, max_bucket_bytes=budget)

    # -- stacked-simulator twins -------------------------------------------
    def average_stacked(self, stacked_tree, *, t: int):
        """Simulator twin: W[i] <- mean over i's group by the averaging
        matrix of iteration ``t``."""
        from repro_torch.core import group_allreduce as ga
        return ga.group_average_stacked(stacked_tree, P=self.P_eff,
                                        S=self.S, t=t)

    def sync_stacked(self, stacked_tree):
        from repro_torch.core import group_allreduce as ga
        return ga.global_average_stacked(stacked_tree, P=self.P_eff)

    # -- accounting ----------------------------------------------------------
    def n_leaves(self) -> int:
        return len(tr.tree_leaves(self.work_struct))

    def butterfly_summary(self, offset: int = 0) -> List[dict]:
        """One dict per stage run: link class, bits, budget, exchanges.

        Sharding never changes the launch count per stage: the sharded
        butterfly runs one exchange per shard-layout bucket, so under FSDP
        every class reports the shard layout's bucket count."""
        out = []
        for run in self.runs_for_offset(offset):
            link = self.topology.link_classes[run.class_index]
            if self.sharding.is_sharded:
                units = self.shard_layout.n_buckets
                budget = self.shard_bucket_bytes
            else:
                units = (self.class_layout(run.class_index).n_buckets
                         if self.cfg.fused else self.n_leaves())
                budget = self.class_bucket_bytes[run.class_index]
            out.append({
                "link": link.name,
                "bits": run.bits,
                "axes": tuple(self.eff_topology.axis_of_bit(b)
                              for b in run.bits),
                "stages": len(run.bits),
                "bucket_bytes": budget,
                "n_buckets": units,
                "exchanges": len(run.bits) * units,
            })
        return out

    def describe(self) -> str:
        """Human-readable plan summary (stages, classes, budgets)."""
        lines = [
            f"AveragingPlan P={self.P} S={self.S} tau={self.cfg.tau} "
            f"payload={self.payload_bytes / 2**20:.2f}MiB "
            f"avg_dtype={self.avg_dtype} fused={self.cfg.fused} "
            f"overlap={self.cfg.overlap}",
            f"  topology: {self.topology.describe()}",
            f"  sharding: {self.sharding.describe()}"
            + (f" -> {self.P_eff} logical replicas of "
               f"{self.shard_size} shards" if self.sharding.is_sharded
               else ""),
            f"  wire: " + ("stacked rows" if self.world is None else
                           f"{self.world.P} ranks over "
                           f"{self.world.backend}"),
        ]
        if self.sharding.is_sharded:
            lines.append(
                f"  shard layout: budget "
                f"{self.shard_bucket_bytes / 2**20:.0f}MiB -> "
                f"{self.shard_layout.n_buckets} buckets x "
                f"{self.shard_size} slices")
            if self._stream_groups is not None:
                lay = self.shard_layout
                lines.append(
                    f"  layer map ({self.n_stream_spans} spans + stem/head):"
                    f" {lay.describe_groups()}")
                lines.append(
                    f"  streamed coverage: peak gathered "
                    f"{self.stream_peak_gathered_bytes() / 2**20:.2f}MiB "
                    f"of {self.full_gathered_bytes() / 2**20:.2f}MiB "
                    f"full-tree ({streaming.expected_stream_gathers(self)} "
                    f"gathers/step fwd+bwd)")
        else:
            for ci in self.topology.classes_in_use():
                link = self.topology.link_classes[ci]
                bb = self.class_bucket_bytes[ci]
                nb = self.class_layout(ci).n_buckets if self.cfg.fused else 0
                lines.append(f"  class {link.name}: budget "
                             f"{bb / 2**20:.0f}MiB -> {nb} buckets")
        for ph, off in enumerate(self.offsets):
            runs = ", ".join(
                f"{r['link']}[bits={list(r['bits'])} x{r['n_buckets']}buk]"
                for r in self.butterfly_summary(off))
            lines.append(f"  phase {ph} (offset {off}): {runs}")
        lines.append(f"  sync: mean budget "
                     f"{self.sync_bucket_bytes / 2**20:.0f}MiB")
        stats = bucketing.layout_cache_stats()
        lines.append(f"  layout cache: {stats['hits']} hits / "
                     f"{stats['misses']} misses")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Compilation (cached on topology x config x tree structure)
# ---------------------------------------------------------------------------

_PLAN_CACHE: Dict[tuple, AveragingPlan] = {}
# Sharded plans are also indexed by the *shard-buffer* structure they
# produce, so that averagers handed the sharded state (a tuple of
# ``(P_eff, n_b)`` buffers) inside the train step resolve back to the plan
# compiled from the full tree at init time.
_SHARD_STRUCT_CACHE: Dict[tuple, AveragingPlan] = {}


def clear_plan_cache() -> None:
    """Drop every compile-time cache: plans, the wires (and their host
    buffers), the per-class budget sweep, and ``bucketing``'s layout cache
    and budget sweep."""
    _PLAN_CACHE.clear()
    _SHARD_STRUCT_CACHE.clear()
    _WIRES.clear()
    choose_class_bucket_bytes.cache_clear()
    bucketing.clear_layout_cache()


def evict_topology(topology: Topology) -> int:
    """Drop the cached plans compiled for one topology; returns the entries
    removed.

    Membership changes (``core/elastic.py``) retire topologies for good,
    so ``ElasticTrainer`` evicts their plans instead of clearing every
    cache as :func:`clear_plan_cache` does.  Cache keys lead with the
    topology, so eviction is a key-prefix filter.  A rank world that no
    remaining plan runs over loses its wire, and with it the wire's pinned
    host buffers.
    """
    removed = 0
    for cache in (_PLAN_CACHE, _SHARD_STRUCT_CACHE):
        dead = [k for k in cache if k[0] == topology]
        for k in dead:
            del cache[k]
        removed += len(dead)
    live = {getattr(w, "world", None) for p in _PLAN_CACHE.values()
            for w in (p.wire, p.shard_wire)}
    for world in [w for w in _WIRES if w not in live]:
        del _WIRES[world]
    return removed


def _structure_key(tree) -> tuple:
    leaves, treedef = tr.tree_flatten(tree)
    return (treedef, tuple((tuple(l.shape), l.dtype) for l in leaves))


def compile_plan(topology: Topology, tree_shapes,
                 config: AveragingConfig = AveragingConfig(),
                 sharding: ShardingPolicy = REPLICATED,
                 world=None) -> AveragingPlan:
    """Compile the averaging once for ONE replica's tree structure.

    ``tree_shapes`` may be tensors or :class:`~repro_torch.core.tree.Spec`
    leaves (only shapes and dtypes are read; a stacked tree's
    ``tree.struct(t, drop=1)`` gives them).  ``world`` (a
    ``launch.mesh.RankWorld``) runs the plan over ranks, ``None`` on
    stacked rows.  Cached on (topology, config, sharding, structure,
    world).

    ``sharding=ShardingPolicy.fsdp_within_pod(axis)`` compiles the sharded
    plan from the FULL tree; later calls with one pod's row of the plan's
    own shard buffers (storage dtypes, or float32 as the gradients are)
    resolve to the same plan.
    """
    structure = _structure_key(tree_shapes)
    if sharding.is_sharded:
        plan = _SHARD_STRUCT_CACHE.get((topology, config, sharding,
                                        structure, world))
        if plan is not None:
            return plan
    key = (topology, config, sharding, structure, world)
    plan = _PLAN_CACHE.get(key)
    if plan is not None:
        return plan
    storage = tr.struct(tree_shapes)
    avg = None if config.average_dtype is None \
        else _DTYPES[config.average_dtype]
    work = storage if avg is None else tr.tree_map(
        lambda l: tr.Spec(l.shape, avg), storage)
    payload = bucketing.tree_payload_bytes(work)
    plan = AveragingPlan(topology, config, storage, work, payload,
                         sharding=sharding, world=world)
    _PLAN_CACHE[key] = plan
    if sharding.is_sharded:
        lay = plan.shard_layout
        # over ranks the state is a rank's column slices
        div = plan.shard_size if world is not None else 1
        for dtypes in (lay.bucket_dtypes,
                       (torch.float32,) * lay.n_buckets):
            row = tuple(tr.Spec((n // div,), d)
                        for n, d in zip(lay.bucket_sizes, dtypes))
            _SHARD_STRUCT_CACHE.setdefault(
                (topology, config, sharding, _structure_key(row), world),
                plan)
    return plan
