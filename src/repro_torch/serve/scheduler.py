"""Continuous-batching scheduler over the paged KV cache, counterpart of
``repro/serve/scheduler.py``.

Request lifecycle::

    WAITING --admit(prefill)--> RUNNING --max tokens / EOS--> FINISHED
       ^                          |
       +------under pressure------+   (preemption frees the victim's blocks)

Each :meth:`ServeScheduler.step` admits as many waiting requests as the
block pool can hold (prefill runs at admission, one request at a time, and
writes the prompt's K/V straight into the pool), then runs ONE decode
iteration for every running request — a single batched
``build_paged_decode`` call in which each request sits at its own
position.  Requests join and leave the batch between iterations without
draining anyone else: that is continuous batching.

**Bucket-padded batch shapes.**  The decode batch is padded up to the next
entry of ``batch_buckets`` (powers of two by default) with rows pointing
at the null block, so the decode step sees a new shape only when the
running set crosses a bucket boundary — never per request count.
``decode_shapes_compiled`` records every distinct padded shape for the
tests to assert exactly that.

**Preemption (recompute).**  When a decode step needs a block and the pool
is exhausted, the most-recently admitted running request is evicted: its
blocks return to the pool and it re-queues at the *front* of the waiting
line with its generated tokens dropped.  On re-admission it recomputes
from the prompt; greedy decode is deterministic, so the regenerated tokens
— and therefore the request's final output — are bit-identical to an
uncontended run (vLLM's recompute policy).

**Over model ranks** (a model built with ``model_world=``): every rank of
the replica runs this scheduler on its own slices, with the same requests
in the same order.  The pool holds the rank's KV heads, and the paged
steps' greedy pick is the ranks' gathered one (``decode.greedy_pick``),
so every rank sees the same tokens.  Admission, preemption, bucket
padding and retirement depend only on the requests, the pool and those
tokens, so the ranks take the same decisions; each step checks that
they did: an ``all_gather`` over the model group of a few integers
(:meth:`ServeScheduler.schedule_digest`), on the host, must agree.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import zlib

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.serve import kv_cache
from repro_torch.serve.kv_cache import BlockPool, OutOfBlocks

WAITING, RUNNING, FINISHED = "waiting", "running", "finished"


@dataclass
class Request:
    rid: object
    prompt: np.ndarray                  # (L,) int32
    max_new_tokens: int
    eos_id: Optional[int] = None
    state: str = WAITING
    out: List[int] = field(default_factory=list)
    preemptions: int = 0

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.size)

    @property
    def done(self) -> bool:
        return len(self.out) >= self.max_new_tokens or (
            self.eos_id is not None and bool(self.out)
            and self.out[-1] == self.eos_id)


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"batch {n} exceeds the largest bucket {buckets[-1]}")


class ServeScheduler:
    """Continuous batching + paged KV over one model replica.

    ``n_blocks`` / ``block_size`` size the pool (block 0 is reserved);
    ``max_blocks_per_req`` bounds any request's context at
    ``max_blocks_per_req * block_size`` tokens and fixes the decode view
    length (= the dense reference's ``max_len``).
    """

    def __init__(self, model, params, *, n_blocks: int, block_size: int,
                 max_blocks_per_req: int, max_batch: int = 8,
                 batch_buckets: Optional[Sequence[int]] = None):
        self.model, self.params = model, params
        self.block_size = int(block_size)
        self.max_blocks_per_req = int(max_blocks_per_req)
        self.max_batch = int(max_batch)
        if batch_buckets is None:
            batch_buckets = []
            b = 1
            while b < self.max_batch:
                batch_buckets.append(b)
                b *= 2
            batch_buckets.append(self.max_batch)
        self.batch_buckets = tuple(sorted(set(int(b) for b in batch_buckets)))
        self.blocks = BlockPool(n_blocks, block_size)
        self.pool = kv_cache.init_paged_pool(model, n_blocks, block_size)
        self._decode = kv_cache.build_paged_decode(model,
                                                   block_size=block_size)
        self._prefill = kv_cache.build_paged_prefill(model,
                                                     block_size=block_size)
        self.waiting: deque = deque()
        self.running: List[Request] = []
        self.finished: Dict[object, Request] = {}
        self.decode_shapes_compiled: set = set()
        self.n_decode_steps = 0
        self.n_prefills = 0

    # -- admission -----------------------------------------------------

    def submit(self, req: Request) -> None:
        max_ctx = self.max_blocks_per_req * self.block_size
        if req.prompt_len + req.max_new_tokens > max_ctx:
            raise ValueError(
                f"request {req.rid!r} needs {req.prompt_len + req.max_new_tokens}"
                f" positions > max context {max_ctx}")
        req.state = WAITING
        self.waiting.append(req)

    def _do_prefill(self, req: Request, table: np.ndarray) -> int:
        """Prefill ``req`` into the pool; returns the first generated token.

        A method, so that a disaggregated scheduler can override it.
        """
        tokens = self._on_device(req.prompt[None])
        self.pool, first = self._prefill(self.params, self.pool, tokens,
                                         self._on_device(table))
        return int(first)

    def _on_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.int64, device=self.model.device)

    def _admit(self) -> None:
        while self.waiting and len(self.running) < self.max_batch:
            req = self.waiting[0]
            # prompt + 1 so the first decode write has a slot
            if not self.blocks.can_allocate(req.rid, req.prompt_len + 1):
                break
            self.waiting.popleft()
            self.blocks.allocate(req.rid, req.prompt_len + 1)
            table = self.blocks.padded_table(req.rid, self.max_blocks_per_req)
            first = self._do_prefill(req, table)
            self.n_prefills += 1
            req.out = [first]
            req.state = RUNNING
            self.running.append(req)
            self._retire(req)

    # -- preemption ----------------------------------------------------

    def _preempt(self, victim: Request) -> None:
        self.blocks.evict(victim.rid)
        victim.out = []
        victim.preemptions += 1
        victim.state = WAITING
        self.running.remove(victim)
        self.waiting.appendleft(victim)

    def _ensure_blocks(self, req: Request) -> bool:
        """Cover this step's K/V write; False if ``req`` itself got evicted."""
        need = req.prompt_len + len(req.out)
        while True:
            try:
                self.blocks.allocate(req.rid, need)
                return True
            except OutOfBlocks:
                if len(self.running) == 1:
                    raise OutOfBlocks(
                        f"request {req.rid!r} alone exceeds the pool "
                        f"({self.blocks.n_blocks - 1} blocks of "
                        f"{self.block_size})")
                victim = self.running[-1]
                self._preempt(victim)
                if victim is req:
                    return False

    # -- the serve loop ------------------------------------------------

    def _retire(self, req: Request) -> None:
        if req.state == RUNNING and req.done:
            self.blocks.free(req.rid)
            self.running.remove(req)
            req.state = FINISHED
            self.finished[req.rid] = req

    def step(self) -> bool:
        """Admit + one decode iteration; False when nothing is in flight.
        Over a model world the ranks' schedules are checked to agree."""
        busy = self._step()
        self._check_schedule()
        return busy

    def _step(self) -> bool:
        self._admit()
        if not self.running:
            if self.waiting:
                # nothing running and the head of the queue cannot be
                # admitted: the pool cannot serve this request at all
                req = self.waiting[0]
                self.blocks.allocate(req.rid, req.prompt_len + 1)
            return False
        batch = [r for r in list(self.running)
                 if r.state == RUNNING and self._ensure_blocks(r)]
        # later _ensure_blocks calls can only preempt *later* admissions
        # (victims pop from the running tail), but keep the guard honest:
        batch = [r for r in batch if r.state == RUNNING]
        if not batch:
            return True
        n_pad = _bucket(len(batch), self.batch_buckets)
        tables = np.zeros((n_pad, self.max_blocks_per_req), np.int32)
        tokens = np.zeros((n_pad,), np.int32)
        positions = np.zeros((n_pad,), np.int32)
        for i, req in enumerate(batch):
            tables[i] = self.blocks.padded_table(req.rid,
                                                 self.max_blocks_per_req)
            tokens[i] = req.out[-1]
            positions[i] = req.prompt_len + len(req.out) - 1
        self.decode_shapes_compiled.add((n_pad, self.max_blocks_per_req))
        self.pool, nxt, _ = self._decode(self.params, self.pool,
                                         self._on_device(tables),
                                         self._on_device(tokens),
                                         self._on_device(positions))
        nxt = nxt.cpu().numpy()
        for i, req in enumerate(batch):
            req.out.append(int(nxt[i]))
            self._retire(req)
        self.n_decode_steps += 1
        return True

    def schedule_digest(self) -> List[int]:
        """A few integers that every model rank's schedule must share after
        a step: the crc32 of the running requests' ids and token counts
        and of the waiting line's ids, the prefills, decode steps and
        evictions so far, and the free blocks."""
        running = repr([(r.rid, len(r.out)) for r in self.running])
        waiting = repr([r.rid for r in self.waiting])
        return [zlib.crc32(running.encode()), zlib.crc32(waiting.encode()),
                self.n_prefills, self.n_decode_steps, self.blocks.evictions,
                self.blocks.n_free]

    def _check_schedule(self) -> None:
        """Over a model world: the ranks' :meth:`schedule_digest` must
        agree (an ``all_gather`` of host integers, through the device only
        where the backend takes device tensors)."""
        mw = getattr(self.model, "model_world", None)
        if mw is None:
            return
        mine = torch.tensor(self.schedule_digest(), dtype=torch.int64)
        if not mw.staged:
            mine = mine.to(self.model.device)
        every = [torch.empty_like(mine) for _ in range(mw.size)]
        dist.all_gather(every, mine, group=mw.group)
        if any(not torch.equal(e, every[0]) for e in every):
            raise RuntimeError(
                f"model rank {mw.rank}: the ranks' schedules parted after "
                f"decode step {self.n_decode_steps}: "
                f"{[e.tolist() for e in every]}")

    def run(self) -> Dict[object, List[int]]:
        """Serve until every submitted request finishes."""
        while self.waiting or self.running:
            self.step()
        return {rid: list(r.out) for rid, r in self.finished.items()}
