"""Disaggregated prefill/decode: link-costed KV block transfer.

Counterpart of ``repro/serve/kv_transfer.py``.  Prefill and decode want
different hardware (a compute-bound batch job against a latency-bound
memory-bound loop), so a disaggregated deployment runs them on separate
workers and streams each request's KV blocks from the prefill worker to
the decode worker.

* The **connector interface** (:class:`KVConnector`, ``insert``/``select``
  over an abstract :class:`Transport`) follows vLLM's ``kv_connector``:
  the prefill worker inserts a request's blocks, the decode worker selects
  them, and neither knows the wire.
* The **bucketing layer** packs the request's block tree into
  dtype-homogeneous flat buffers at the link's modeled budget
  (``plan.choose_class_bucket_bytes``, non-overlapped), and the wire then
  chunks each buffer at that budget (a layout never splits a leaf, and one
  KV leaf can dwarf the budget).
* ``plan.link_transfer_seconds`` prices every transfer on the link class
  (default: the DCN class; ``Topology.with_measured`` gives calibrated
  ones).  :class:`TransferStats` keeps that model's seconds beside the
  bytes and messages; it is a model of the link class, not a time of the
  machine that runs this.

The wire carries host torch tensors in the pool's dtype (bfloat16 has no
numpy dtype): the blocks leave the card into pinned host memory (the
caching host allocator reuses it by size), are packed and sent on the
host, and are written into the decode pool from there.  Pack, wire and
unpack copy bytes and do no arithmetic, so the decode pool holds exactly
what ``build_paged_prefill`` would have scattered and the tokens equal the
colocated scheduler's (pinned by tests).
"""

from __future__ import annotations

import abc
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import bucketing
from repro_torch.core import plan as plan_mod
from repro_torch.core import tree as tr
from repro_torch.models.transformer import torch_dtype
from repro_torch.serve import kv_cache
from repro_torch.serve.decode import greedy_pick
from repro_torch.serve.scheduler import Request, ServeScheduler


def kv_payload_bytes(cfg, n_tokens: int) -> int:
    """Bytes of K+V a dense-family request carries for ``n_tokens``."""
    itemsize = torch_dtype(cfg).itemsize
    return int(2 * cfg.n_layers * cfg.n_kv_heads * cfg.hd * itemsize
               * max(int(n_tokens), 0))


# ---------------------------------------------------------------------------
# Transport + connector
# ---------------------------------------------------------------------------

class Transport(abc.ABC):
    """One-way message pipe between a prefill and a decode worker."""

    @abc.abstractmethod
    def send(self, rid, messages: Tuple[torch.Tensor, ...]
             ) -> Tuple[torch.Tensor, ...]:
        """Ship flat messages; returns what the receiver observes."""


class InProcessTransport(Transport):
    """Both workers in one process: the wire is a host-side copy."""

    def __init__(self):
        self.messages_sent = 0
        self.bytes_sent = 0

    def send(self, rid, messages):
        out = tuple(m.clone() for m in messages)
        self.messages_sent += len(out)
        self.bytes_sent += sum(m.numel() * m.element_size() for m in out)
        return out


@dataclass
class TransferStats:
    requests: int = 0          # inserts: a preempted request ships again
    blocks: int = 0
    payload_bytes: int = 0
    messages: int = 0
    modeled_seconds: float = 0.0


class KVConnector(abc.ABC):
    """vLLM-style KV exchange point between prefill and decode workers."""

    @abc.abstractmethod
    def insert(self, rid, kv_blocks, meta: dict) -> None:
        """Publish one finished request's KV blocks (+ metadata)."""

    @abc.abstractmethod
    def select(self, rid) -> Optional[Tuple[object, dict]]:
        """Take a request's blocks; None when not (yet) inserted."""


class LinkCostedConnector(KVConnector):
    """Connector that packs blocks into link-budget-sized messages.

    ``link`` prices the transfer (default: the DCN class); ``message_bytes``
    overrides the modeled per-message budget.
    """

    def __init__(self, link: plan_mod.LinkClass = plan_mod.DCN,
                 transport: Optional[Transport] = None,
                 message_bytes: Optional[int] = None):
        self.link = link
        self.transport = transport or InProcessTransport()
        self.message_bytes = message_bytes
        self.stats = TransferStats()
        self._store: Dict[object, tuple] = {}

    def budget_for(self, payload_bytes: int) -> int:
        if self.message_bytes is not None:
            return int(self.message_bytes)
        return plan_mod.choose_class_bucket_bytes(
            max(int(payload_bytes), 1), self.link, overlap=False)

    def insert(self, rid, kv_blocks, meta: dict) -> None:
        if rid in self._store:
            raise KeyError(f"request {rid!r} already inserted")
        payload = bucketing.tree_payload_bytes(kv_blocks)
        budget = self.budget_for(payload)
        layout = bucketing.layout_for(kv_blocks, max_bucket_bytes=budget)
        messages, splits = [], []
        for buf in bucketing.pack(kv_blocks, layout):
            per = max(1, budget // buf.element_size())
            chunks = [buf[i:i + per] for i in range(0, buf.numel(), per)] \
                or [buf]
            splits.append(len(chunks))
            messages.extend(chunks)
        messages = self.transport.send(rid, tuple(messages))
        self._store[rid] = (messages, tuple(splits), layout, dict(meta))
        self.stats.requests += 1
        self.stats.blocks += int(meta.get("n_blocks", 0))
        self.stats.payload_bytes += int(payload)
        self.stats.messages += len(messages)
        self.stats.modeled_seconds += plan_mod.link_transfer_seconds(
            payload, self.link, message_bytes=budget)

    def select(self, rid):
        entry = self._store.pop(rid, None)
        if entry is None:
            return None
        messages, splits, layout, meta = entry
        bufs, i = [], 0
        for n in splits:
            bufs.append(torch.cat(messages[i:i + n]) if n > 1
                        else messages[i])
            i += n
        return bucketing.unpack(bufs, layout), meta


# ---------------------------------------------------------------------------
# Disaggregated serving
# ---------------------------------------------------------------------------

def build_prefill_export(model, *, block_size: int, max_blocks: int):
    """The prefill worker's step: ``fn(params, tokens (1, L)) -> (block
    rows {g: {n: (n_sb, max_blocks, block_size, KH, hd)}}, first_token)``.

    The math of ``build_paged_prefill`` (the same ``max_blocks *
    block_size`` view, the same masked greedy argmax) without the scatter
    into a pool: the blocks leave through the connector instead.
    """
    def fn(params, tokens):
        s_view = max_blocks * block_size
        logits, caches = model.prefill(params, {"tokens": tokens}, s_view)
        blocks = {g: {n: c[:, 0].reshape((c.shape[0], max_blocks,
                                          block_size) + c.shape[3:])
                      for n, c in leaves.items()}
                  for g, leaves in caches.items()}
        first = greedy_pick(model, logits[:, -1])[0][0]
        return blocks, first.to(tokens.dtype)

    return fn


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``, pinned when it leaves a card."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
    return host.copy_(t)


class DisaggregatedScheduler(ServeScheduler):
    """The continuous-batching scheduler with prefill on another worker.

    The decode side is unchanged (same pool, same bucket-padded decode
    batches); only ``_do_prefill`` differs: the prompt's K/V is computed
    with ``prefill_params`` (the prefill worker's own weight copy), staged
    to the host, shipped through the connector as packed messages, and
    written into this pool's blocks.  A preempted request is prefilled and
    shipped again under the same ``rid``.

    ``staging`` holds host-clock seconds (the card synchronised around
    each part): ``d2h_s`` the blocks' copy off the card, ``connector_s``
    insert and select (pack, the transport's copy, unpack), ``h2d_s`` the
    write into the pool.

    Over model ranks (a model built with ``model_world=``) every rank runs
    this scheduler on its own slices with the same requests in the same
    order, as :class:`ServeScheduler` does: its prefill worker exports the
    rank's KV heads from its slices of ``prefill_params``, ships them
    through its own connector into its own pool, and the first token is
    ``greedy_pick``'s gathered one, equal on every rank.  ``staging`` and
    the connector's ``TransferStats`` are the rank's.
    """

    def __init__(self, model, params, *, prefill_params=None,
                 connector: Optional[KVConnector] = None,
                 link: plan_mod.LinkClass = plan_mod.DCN, **kw):
        super().__init__(model, params, **kw)
        self.prefill_params = params if prefill_params is None \
            else prefill_params
        self.connector = connector if connector is not None \
            else LinkCostedConnector(link=link)
        self._export = build_prefill_export(
            model, block_size=self.block_size,
            max_blocks=self.max_blocks_per_req)
        self.staging = {"d2h_s": 0.0, "connector_s": 0.0, "h2d_s": 0.0}

    def _synced_clock(self) -> float:
        if torch.device(self.model.device).type == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter()

    def _do_prefill(self, req: Request, table: np.ndarray) -> int:
        # --- prefill worker ---
        blocks, first = self._export(self.prefill_params,
                                     self._on_device(req.prompt[None]))
        n_ship = len(self.blocks.table(req.rid))     # covers prompt_len + 1
        t0 = self._synced_clock()
        shipped = tr.tree_map(lambda b: _to_host(b[:, :n_ship]), blocks)
        t1 = self._synced_clock()
        self.connector.insert(req.rid, shipped,
                              {"first": int(first), "n_blocks": n_ship,
                               "prompt_len": req.prompt_len})
        # --- decode worker ---
        got = self.connector.select(req.rid)
        if got is None:
            raise RuntimeError(f"connector lost request {req.rid!r}")
        kv_blocks, meta = got
        t2 = self._synced_clock()
        self.pool = kv_cache.insert_blocks(
            self.pool, self._on_device(table[:n_ship]), kv_blocks)
        t3 = self._synced_clock()
        for key, dt in (("d2h_s", t1 - t0), ("connector_s", t2 - t1),
                        ("h2d_s", t3 - t2)):
            self.staging[key] += dt
        return int(meta["first"])
