"""Paged KV cache: fixed-size block pool with per-request block tables.

Counterpart of ``repro/serve/kv_cache.py``.  A host-side :class:`BlockPool`
hands out fixed-size blocks of ``block_size`` token positions and keeps a
per-request block table.  The device pool is the model's own cache tree
with the batch/seq dims replaced by ``(n_blocks, block_size)``:
``{"global": {"k","v"}}`` leaves of shape
``(n_sb, n_blocks, block_size, KH, hd)``.

:func:`build_paged_decode` runs one decode step for a ragged batch: it
gathers each row's block table into a contiguous cache view
``(n_sb, N, S_view, KH, hd)``, runs the model's own ``decode_step`` on the
views with one position per row, and scatters the newly written K/V back
to ``(table[pos // bs], pos % bs)``.  Where the JAX package vmaps a B=1
decode over the rows, this module writes the batch dimension out.
:func:`build_paged_prefill` fills one request's blocks through the model's
own ``prefill`` at the natural prompt length.  :func:`extract_blocks` and
:func:`insert_blocks` move a request's block rows out of and into a pool:
the disaggregated scheduler (``serve/kv_transfer.py``) ships them.

Block 0 is the null block: never allocated, owned by nobody.  Padding rows
of a bucket-padded decode batch point their whole table at it, so their
discarded gathers and scatters never touch a real request's blocks.  Stale
contents of reused or null blocks are unobservable: ``decode_attention``
masks every position >= the row's length, and each position is written
before it first becomes valid.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np
import torch

from repro_torch.serve.decode import greedy_pick

NULL_BLOCK = 0


class OutOfBlocks(RuntimeError):
    """The pool cannot cover a request's tokens; caller must preempt."""


@dataclass
class BlockPool:
    """Host-side block allocator with per-request block tables.

    Invariants (pinned by the hypothesis property test):
    * a block is owned by at most one request (the null block by none);
    * ``free`` / ``evict`` return every owned block to the free list;
    * a request's table always holds exactly
      ``ceil(covered_tokens / block_size)`` blocks.
    """
    n_blocks: int
    block_size: int
    evictions: int = 0
    _free: List[int] = field(default_factory=list)
    _tables: Dict[object, List[int]] = field(default_factory=dict)
    _tokens: Dict[object, int] = field(default_factory=dict)

    def __post_init__(self):
        if self.n_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the null block)")
        if self.block_size < 1:
            raise ValueError("block_size must be positive")
        # LIFO free list; block 0 (null) is never handed out.
        self._free = list(range(self.n_blocks - 1, 0, -1))

    @property
    def n_free(self) -> int:
        return len(self._free)

    def blocks_for(self, n_tokens: int) -> int:
        return -(-max(int(n_tokens), 0) // self.block_size)

    def tokens_covered(self, rid) -> int:
        return self._tokens.get(rid, 0)

    def table(self, rid) -> List[int]:
        return list(self._tables.get(rid, ()))

    def padded_table(self, rid, max_blocks: int) -> np.ndarray:
        """The request's table padded with the null block to a fixed width."""
        tbl = self._tables.get(rid, [])
        if len(tbl) > max_blocks:
            raise ValueError(f"request {rid!r} holds {len(tbl)} blocks "
                             f"> max_blocks={max_blocks}")
        out = np.full((max_blocks,), NULL_BLOCK, np.int32)
        out[:len(tbl)] = tbl
        return out

    def can_allocate(self, rid, n_tokens: int) -> bool:
        need = self.blocks_for(n_tokens) - len(self._tables.get(rid, ()))
        return need <= self.n_free

    def allocate(self, rid, n_tokens: int) -> List[int]:
        """Grow ``rid``'s table to cover ``n_tokens``; returns the table.

        Atomic: raises :class:`OutOfBlocks` without taking anything when
        the free list cannot cover the growth.  Never shrinks.
        """
        tbl = self._tables.setdefault(rid, [])
        need = self.blocks_for(n_tokens) - len(tbl)
        if need > self.n_free:
            if not tbl:
                del self._tables[rid]
            raise OutOfBlocks(
                f"request {rid!r} needs {need} more blocks for {n_tokens} "
                f"tokens; {self.n_free} free of {self.n_blocks - 1}")
        for _ in range(max(need, 0)):
            tbl.append(self._free.pop())
        self._tokens[rid] = max(self._tokens.get(rid, 0), int(n_tokens))
        return list(tbl)

    def free(self, rid) -> int:
        """Release every block of ``rid``; returns how many were freed."""
        tbl = self._tables.pop(rid, [])
        self._tokens.pop(rid, None)
        self._free.extend(reversed(tbl))
        return len(tbl)

    def evict(self, rid) -> int:
        """Preemption: same as :meth:`free`, counted separately."""
        n = self.free(rid)
        if n:
            self.evictions += 1
        return n

    def owned_blocks(self) -> List[int]:
        return [b for tbl in self._tables.values() for b in tbl]

    def check_invariants(self) -> None:
        owned = self.owned_blocks()
        assert NULL_BLOCK not in owned, "null block was allocated"
        assert len(owned) == len(set(owned)), "a block is double-owned"
        assert not set(owned) & set(self._free), "owned block on free list"
        assert len(owned) + self.n_free == self.n_blocks - 1, \
            "blocks leaked or duplicated"
        for rid, tbl in self._tables.items():
            assert len(tbl) == self.blocks_for(self._tokens[rid]), \
                f"table of {rid!r} does not cover its tokens exactly"


# ---------------------------------------------------------------------------
# Device pool + paged model steps
# ---------------------------------------------------------------------------

def init_paged_pool(model, n_blocks: int, block_size: int):
    """The model's cache tree with ``(B, max_len) -> (n_blocks, block_size)``.

    Only full-attention ("global") caches page; sliding-window ring caches
    keep a window per request, not per position, so they do not decompose
    into shareable blocks (fails loudly).
    """
    probe = model.init_caches(1, block_size)
    extra = set(probe) - {"global"}
    if extra:
        raise NotImplementedError(
            f"paged serving supports full-attention (global) caches only; "
            f"{model.cfg.name} has cache groups {sorted(probe)}")
    return {g: {n: a.new_zeros((a.shape[0], n_blocks) + a.shape[2:])
                for n, a in leaves.items()} for g, leaves in probe.items()}


def _gather_view(pool_leaf, tables):
    """(n_sb, n_blocks, bs, ...), tables (N, max_blocks) ->
    (n_sb, N, max_blocks*bs, ...): dense cache views, one row per table."""
    g = pool_leaf[:, tables]                       # (n_sb, N, mb, bs, ...)
    return g.reshape(g.shape[:2] + (g.shape[2] * g.shape[3],) + g.shape[4:])


def build_paged_decode(model, *, block_size: int):
    """Ragged-batch decode:
    ``step(params, pool, tables, tokens, positions) -> (pool, next_tokens,
    logits)``.

    ``tables`` (N, max_blocks), ``tokens``/``positions`` (N,) int64 tensors
    on the model's device, every row at its own position.  The pool is
    updated in place and returned.  The greedy pick and ``logits`` (N, V),
    the rows' last-position logits with the vocab-padding columns masked,
    are ``serve.decode.greedy_pick``'s, as ``build_serve_step``'s are: over
    a model world the ranks' gathered pick and logits.
    """

    def step(params, pool, tables, tokens, positions):
        views = {g: {n: _gather_view(p, tables) for n, p in leaves.items()}
                 for g, leaves in pool.items()}
        logits, views = model.decode_step(params, views, tokens[:, None],
                                          positions)
        rows = torch.arange(tables.shape[0], device=tables.device)
        blk = tables[rows, positions // block_size]
        slot = positions % block_size
        for g, leaves in pool.items():
            for n, p in leaves.items():
                p[:, blk, slot] = views[g][n][:, rows, positions]
        nxt, last = greedy_pick(model, logits[:, -1])
        return pool, nxt.to(tokens.dtype), last

    return step


def build_paged_prefill(model, *, block_size: int):
    """Single-request prefill into the pool:
    ``fn(params, pool, tokens, table) -> (pool, first_token)``.

    ``tokens`` (1, L) at the natural prompt length (never padded, so the
    prefill K/V and logits equal the uncontended reference's); ``table``
    (max_blocks,) the request's padded table.  ``max_blocks * block_size``
    is the view length every later decode gathers, so the prefill pads its
    cache to exactly that.  The pool is updated in place and returned.  The
    first token is ``serve.decode.greedy_pick``'s (over a model world, the
    ranks' gathered pick).
    """

    def prefill(params, pool, tokens, table):
        s_view = table.shape[0] * block_size
        logits, caches = model.prefill(params, {"tokens": tokens}, s_view)
        for g, leaves in pool.items():
            for n, p in leaves.items():
                c = caches[g][n][:, 0]             # (n_sb, S_view, ...)
                p[:, table] = c.reshape((c.shape[0], table.shape[0],
                                         block_size) + c.shape[2:])
        first = greedy_pick(model, logits[:, -1])[0][0]
        return pool, first.to(tokens.dtype)

    return prefill


def _on_pool(pool_leaf, table) -> torch.Tensor:
    return torch.as_tensor(table, dtype=torch.int64, device=pool_leaf.device)


def extract_blocks(pool, table):
    """Host copies of the blocks in ``table``: leaves ``(n_sb, len(table),
    block_size, KH, hd)`` in the pool's dtype."""
    return {g: {n: p[:, _on_pool(p, table)].cpu() for n, p in leaves.items()}
            for g, leaves in pool.items()}


def insert_blocks(pool, table, blocks):
    """Write shipped block rows (leaves ``(n_sb, len(table), block_size,
    KH, hd)``, on any device) into the pool at ``table``, in the pool's
    dtype, in place; returns the pool."""
    for g, leaves in pool.items():
        for n, p in leaves.items():
            p[:, _on_pool(p, table)] = blocks[g][n].to(device=p.device,
                                                       dtype=p.dtype)
    return pool
