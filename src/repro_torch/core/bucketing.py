"""Flat-buffer bucketing for collective communication (MG-WFBP-style).

Counterpart of ``repro/core/bucketing.py``.  A params tree is packed into a
handful of contiguous, dtype-homogeneous flat **buckets** so every
butterfly stage does one exchange per bucket, and the combine arithmetic
streams through the fused kernels K1/K2 (``kernels/group_average.py``).

The layout is a pure function of one replica's tree *structure* (treedef,
leaf shapes and dtypes, bucket budget) and is cached; it is identical to
the JAX package's layout of the same tree (boundaries, offsets, dtype
grouping; pinned by tests):

* leaves are grouped by dtype, filled greedily in canonical (JAX) order;
* a bucket closes when adding the next leaf would push it past
  ``max_bucket_bytes`` (an oversize leaf gets its own bucket; leaves are
  never split);
* each bucket is zero-padded to a whole number of 128-element lanes (zeros
  are a fixed point of the butterfly, so the pad stays zero);
* zero-size leaves occupy zero-length slices.

Trees may carry leading replica dims: ``pack`` of a stacked tree (every
leaf ``(P, ...)``) gives ``(P, n_b)`` buckets, padded per replica as JAX
pads per device, and ``unpack`` inverts it.  ``tree_map_buckets`` and
``tree_map_bucketed`` take stacked trees (the port's replicated
realisation) and lay them out by one replica's structure.  ``align=`` pads
every bucket to a multiple of ``align * 128`` elements: the FSDP-within-pod
state (``core/replica.py``) passes the pod size, so each bucket splits into
``align`` equal, lane-aligned shard slices, as in the JAX package.

``groups=`` makes a layout **layer-aware** (DESIGN.md §11), for the
layer-streamed FSDP state: one ordered group id a leaf (stem, spans,
head); leaves are packed group by group and a bucket never spans two
groups, so one layer span's parameters are a contiguous run of whole
buckets, and a group's slice of the layout equals the layout of its
sub-tree alone.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core import tree as tr

# Default bucket budget (the JAX package's).
DEFAULT_BUCKET_BYTES = 32 * 1024 * 1024

# Buckets are padded to a multiple of this many elements (the TPU lane
# width in the JAX package; kept so that layouts are identical).
_LANES = 128


@dataclass(frozen=True)
class _LeafSlot:
    bucket: int            # which bucket this leaf lives in
    offset: int            # element offset of the leaf inside the bucket
    size: int              # element count (0 for empty leaves)
    shape: Tuple[int, ...]
    dtype: torch.dtype


@dataclass(frozen=True)
class BucketLayout:
    """Cached pack/unpack plan for one tree structure."""
    treedef: object
    slots: Tuple[_LeafSlot, ...]          # one per leaf, canonical order
    bucket_sizes: Tuple[int, ...]         # padded element counts
    bucket_dtypes: Tuple[torch.dtype, ...]
    # layer-aware layouts: the ordered group id each bucket belongs to, or
    # () for ungrouped layouts.  Bucket indices are ordered by group, so a
    # group's buckets are a contiguous run.
    bucket_groups: Tuple[int, ...] = ()

    @property
    def n_buckets(self) -> int:
        return len(self.bucket_sizes)

    @property
    def grouped(self) -> bool:
        return bool(self.bucket_groups)

    def group_bucket_indices(self, group: int) -> Tuple[int, ...]:
        """Bucket indices holding the given group's leaves (contiguous)."""
        return tuple(i for i, g in enumerate(self.bucket_groups)
                     if g == group)

    def group_bucket_map(self) -> Dict[int, Tuple[int, ...]]:
        """The layer <-> bucket map: ordered group id -> bucket indices."""
        out: Dict[int, Tuple[int, ...]] = {}
        for i, g in enumerate(self.bucket_groups):
            out[g] = out.get(g, ()) + (i,)
        return out

    def group_bytes(self, group: int) -> int:
        """Padded bytes of one group's buckets (its gathered footprint)."""
        return sum(self.bucket_sizes[i] * self.bucket_dtypes[i].itemsize
                   for i in self.group_bucket_indices(group))

    def describe(self) -> str:
        return " ".join(
            f"[{i}:{str(d).split('.')[-1]}x{s}]"
            for i, (s, d) in enumerate(zip(self.bucket_sizes,
                                           self.bucket_dtypes)))

    def describe_groups(self) -> str:
        """Compact layer-map summary: ``g0->b0, g1->b1-b2, ...``."""
        if not self.grouped:
            return "ungrouped"
        parts = []
        for g, idxs in sorted(self.group_bucket_map().items()):
            rng = (f"b{idxs[0]}" if len(idxs) == 1
                   else f"b{idxs[0]}-b{idxs[-1]}")
            parts.append(f"{g}->{rng}")
        return ", ".join(parts)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _pad_to_lanes(n: int, align: int = 1) -> int:
    unit = _LANES * max(int(align), 1)
    return -(-n // unit) * unit if n else 0


def build_layout(tree, *, max_bucket_bytes: int = DEFAULT_BUCKET_BYTES,
                 align: int = 1,
                 groups: Optional[Tuple[int, ...]] = None) -> BucketLayout:
    """Plan buckets for one replica's ``tree`` (tensors or :class:`Spec`);
    every bucket padded to a multiple of ``align * 128`` elements.

    ``groups`` (one ordered layer id a leaf, in canonical order) fills the
    buckets group by group in ascending id, canonical order within a
    group, and closes every open bucket at a group boundary, so the greedy
    fill restarts per group and a group's slice of the layout is the
    layout of its sub-tree alone."""
    leaves, treedef = tr.tree_flatten(tree)
    metas = [(_numel(l.shape), tuple(l.shape), l.dtype) for l in leaves]
    if groups is not None and len(groups) != len(metas):
        raise ValueError(f"groups has {len(groups)} entries for "
                         f"{len(metas)} leaves")
    order = list(range(len(metas)))
    if groups is not None:
        order.sort(key=lambda li: (groups[li], li))
    slot_of_leaf: Dict[int, _LeafSlot] = {}
    bucket_sizes: list = []
    bucket_dtypes: list = []
    bucket_groups: list = []
    open_bucket: Dict[torch.dtype, int] = {}  # dtype -> open bucket index
    cur_group = None
    for li in order:
        size, shape, dtype = metas[li]
        if groups is not None and groups[li] != cur_group:
            cur_group = groups[li]
            open_bucket = {}                  # buckets never span groups
        bi = open_bucket.get(dtype)
        if bi is not None:
            would_be = (bucket_sizes[bi] + size) * dtype.itemsize
            if bucket_sizes[bi] > 0 and size > 0 and would_be > max_bucket_bytes:
                bi = None                      # close it, open a fresh one
        if bi is None:
            bi = len(bucket_sizes)
            bucket_sizes.append(0)
            bucket_dtypes.append(dtype)
            bucket_groups.append(cur_group)
            open_bucket[dtype] = bi
        slot_of_leaf[li] = _LeafSlot(bi, bucket_sizes[bi], size, shape, dtype)
        bucket_sizes[bi] += size
    return BucketLayout(treedef,
                        tuple(slot_of_leaf[i] for i in range(len(metas))),
                        tuple(_pad_to_lanes(s, align) for s in bucket_sizes),
                        tuple(bucket_dtypes),
                        tuple(bucket_groups) if groups is not None else ())


_LAYOUT_CACHE: Dict[tuple, BucketLayout] = {}
_LAYOUT_STATS = {"hits": 0, "misses": 0}


def clear_layout_cache() -> None:
    """Drop all cached layouts and the budget sweep's cache."""
    _LAYOUT_CACHE.clear()
    _LAYOUT_STATS["hits"] = _LAYOUT_STATS["misses"] = 0
    choose_bucket_bytes.cache_clear()


def layout_cache_stats() -> dict:
    """Hit/miss counters for :func:`layout_for`."""
    return dict(_LAYOUT_STATS)


def layout_for(tree, *, max_bucket_bytes: int = DEFAULT_BUCKET_BYTES,
               align: int = 1,
               groups: Optional[Tuple[int, ...]] = None) -> BucketLayout:
    """Cached :func:`build_layout` keyed on structure, the budget, the
    shard alignment and the layer groups, never on the phase offset or
    anything else a caller threads around."""
    leaves, treedef = tr.tree_flatten(tree)
    key = (treedef, tuple((tuple(l.shape), l.dtype) for l in leaves),
           max_bucket_bytes, align, groups)
    layout = _LAYOUT_CACHE.get(key)
    if layout is None:
        _LAYOUT_STATS["misses"] += 1
        layout = _LAYOUT_CACHE[key] = build_layout(
            tree, max_bucket_bytes=max_bucket_bytes, align=align,
            groups=groups)
    else:
        _LAYOUT_STATS["hits"] += 1
    return layout


def _lead_shape(leaf, slot) -> Tuple[int, ...]:
    lead = tuple(leaf.shape[:leaf.dim() - len(slot.shape)])
    if tuple(leaf.shape[len(lead):]) != slot.shape:
        raise ValueError(f"leaf of shape {tuple(leaf.shape)} does not end in "
                         f"the layout's {slot.shape}")
    return lead


def pack(tree, layout: BucketLayout, dtype=None) -> Tuple[torch.Tensor, ...]:
    """The tree's leaves copied into the layout's flat buckets.

    Leaves may carry the same leading replica dims ``lead``; buckets are
    then ``lead + (n_b,)``.  Every bucket is a new buffer (callers may
    combine into it in place).  ``dtype`` overrides every bucket's dtype
    (leaves are cast while packing, as a cast followed by a pack would).
    """
    leaves = tr.tree_leaves(tree)
    if len(leaves) != len(layout.slots):
        raise ValueError(f"tree has {len(leaves)} leaves, layout "
                         f"{len(layout.slots)}")
    lead = _lead_shape(leaves[0], layout.slots[0]) if leaves else ()
    device = leaves[0].device if leaves else None
    out = [torch.empty(lead + (size,), dtype=dtype or bdtype, device=device)
           for size, bdtype in zip(layout.bucket_sizes, layout.bucket_dtypes)]
    filled = [0] * layout.n_buckets
    for leaf, slot in zip(leaves, layout.slots):
        if _lead_shape(leaf, slot) != lead:
            raise ValueError("pack: leaves with different leading dims")
        if slot.size:
            out[slot.bucket][..., slot.offset:slot.offset + slot.size].copy_(
                leaf.reshape(lead + (slot.size,)))
            filled[slot.bucket] += slot.size
    for buf, n in zip(out, filled):
        buf[..., n:].zero_()
    return tuple(out)


def pack_add_(tree, layout: BucketLayout, buckets: Sequence[torch.Tensor]):
    """Add the tree's leaves into ``buckets`` (as :func:`pack` lays them
    out) in place, each leaf cast to its bucket's dtype while it is added:
    ``pack(tree, dtype=b.dtype)`` summed into ``buckets`` with no packed
    copy of the tree.  Returns ``buckets``."""
    leaves = tr.tree_leaves(tree)
    if len(leaves) != len(layout.slots):
        raise ValueError(f"tree has {len(leaves)} leaves, layout "
                         f"{len(layout.slots)}")
    for leaf, slot in zip(leaves, layout.slots):
        if slot.size:
            lead = _lead_shape(leaf, slot)
            buckets[slot.bucket][..., slot.offset:slot.offset + slot.size
                                 ].add_(leaf.reshape(lead + (slot.size,)))
    return buckets


def unpack(buckets: Sequence[torch.Tensor], layout: BucketLayout,
           cast: bool = True):
    """Exact inverse of :func:`pack` (static slices).  ``cast=False`` keeps
    each leaf in its bucket's dtype instead of the slot's.  A leaf in its
    bucket's dtype is a view into the bucket."""
    leaves = []
    for slot in layout.slots:
        buf = buckets[slot.bucket]
        lead = tuple(buf.shape[:-1])
        flat = buf[..., slot.offset:slot.offset + slot.size]
        leaf = flat.reshape(lead + slot.shape)
        leaves.append(leaf.to(slot.dtype) if cast else leaf)
    return tr.tree_unflatten(layout.treedef, leaves)


def tree_map_buckets(fn: Callable[[list], list], tree, *,
                     compute_dtype=torch.float32,
                     max_bucket_bytes: int = DEFAULT_BUCKET_BYTES):
    """Apply a mixing function to the whole LIST of buckets of a stacked
    tree at once (so the overlapped scheduler can interleave across
    buckets).  The layout is one replica's (leaves without dim 0); buffers
    are ``(P, n_b)`` in ``compute_dtype`` (``None`` = storage dtype) and cast
    back.  Zero-size buckets are passed to ``fn`` and restored untouched."""
    layout = layout_for(tr.struct(tree, drop=1),
                        max_bucket_bytes=max_bucket_bytes)
    bufs = pack(tree, layout, dtype=compute_dtype)
    outs = fn(list(bufs))
    if len(outs) != len(bufs):
        raise ValueError(f"bucket mixing fn returned {len(outs)} buffers "
                         f"for {len(bufs)} buckets")
    return unpack(tuple(o.to(d) for o, d in zip(outs, layout.bucket_dtypes)),
                  layout)


def tree_map_bucketed(fn: Callable[[torch.Tensor], torch.Tensor], tree, *,
                      compute_dtype=torch.float32,
                      max_bucket_bytes: int = DEFAULT_BUCKET_BYTES):
    """Apply a per-bucket mixing function to each non-empty bucket: the
    serial wrapper over :func:`tree_map_buckets`."""
    return tree_map_buckets(
        lambda bufs: [fn(b) if b.numel() else b for b in bufs], tree,
        compute_dtype=compute_dtype, max_bucket_bytes=max_bucket_bytes)


def tree_payload_bytes(tree) -> int:
    """Total leaf bytes of a params tree (tensors or :class:`Spec`)."""
    return sum(_numel(l.shape) * l.dtype.itemsize
               for l in tr.tree_leaves(tree))


# Candidate budgets swept by :func:`choose_bucket_bytes` — 1 MiB..128 MiB.
BUCKET_BYTES_CANDIDATES = tuple((1 << i) * 1024 * 1024 for i in range(8))


@lru_cache(maxsize=None)
def choose_bucket_bytes(payload_bytes: int, *, P: int, S: int,
                        tau: int = 10,
                        overlap: bool = True,
                        alpha: float = None, beta: float = None,
                        gamma: float = None,
                        candidates: Tuple[int, ...] = BUCKET_BYTES_CANDIDATES
                        ) -> int:
    """Bucket budget minimising the modeled (single-class) step time: the
    argmin of ``group_allreduce.wagma_step_time`` over ``candidates``."""
    from repro_torch.core import group_allreduce as ga   # circular import
    alpha = ga.DEFAULT_ALPHA if alpha is None else alpha
    beta = ga.DEFAULT_BETA if beta is None else beta
    gamma = ga.DEFAULT_GAMMA if gamma is None else gamma
    payload = max(int(payload_bytes), 1)
    best, best_t = None, None
    for cand in candidates:
        n_buckets = max(1, -(-payload // cand))
        t = ga.wagma_step_time(payload, P, S, tau=tau, n_buckets=n_buckets,
                               alpha=alpha, beta=beta, gamma=gamma,
                               overlap=overlap)
        if best_t is None or t < best_t:
            best, best_t = cand, t
    return best
