"""Synthetic data pipeline.

The port's own copy of ``repro/data/synthetic.py`` (numpy only): batches
are byte-identical to the JAX package's for the same (cfg, shape, seed,
step, worker).

Two generators:

* ``SyntheticTask`` — a *learnable* LM task: tokens follow a fixed random
  first-order teacher (permutation-mixture transition table), so
  cross-entropy meaningfully decreases during the convergence benchmarks and
  example drivers. Deterministic per (seed, step, worker).
* length-imbalance sampling (paper §V-C Fig. 6): per-batch sentence lengths
  drawn from a log-normal fitted to the paper's WMT distribution, returned as
  padded (tokens, mask) — used by the straggler simulator and benchmarks to
  reproduce the unbalanced-workload setting.

Everything is numpy-host-side; the launcher moves each replica's rows to
the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass
class SyntheticTask:
    vocab: int
    seq_len: int
    seed: int = 0
    order_mix: float = 0.75     # teacher determinism (learnability)

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        v = self.vocab
        # teacher: tok_{t+1} = perm[tok_t] with prob order_mix, else uniform
        self.perm = rng.permutation(v)

    def batch(self, step: int, worker: int, batch_size: int,
              seq_len: Optional[int] = None) -> dict:
        s = seq_len or self.seq_len
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + worker)
        toks = np.empty((batch_size, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, batch_size)
        noise = rng.random((batch_size, s)) > self.order_mix
        rand = rng.integers(0, self.vocab, (batch_size, s))
        for t in range(s):
            nxt = self.perm[toks[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def imbalanced_batch(self, step: int, worker: int, batch_size: int,
                         median_len: Optional[int] = None) -> dict:
        """Padded batch with log-normal lengths (paper Fig. 6 style)."""
        s = self.seq_len
        med = median_len or max(s // 4, 8)
        rng = np.random.default_rng(
            (self.seed * 2_000_003 + step) * 65_537 + worker)
        lens = np.clip(rng.lognormal(np.log(med), 0.6, batch_size), 4, s
                       ).astype(np.int32)
        base = self.batch(step, worker, batch_size)
        mask = (np.arange(s)[None, :] < lens[:, None]).astype(np.float32)
        return {**base, "mask": mask, "lengths": lens}

    def work_per_batch(self, batch: dict) -> float:
        """Relative compute cost (token count) — the imbalance signal."""
        if "lengths" in batch:
            return float(batch["lengths"].sum())
        return float(batch["tokens"].size)


def make_batch_fn(cfg, shape, seed: int = 0, imbalanced: bool = False):
    """Returns batch_fn(step, worker, per_worker_batch) for a model config,
    adding the modality-stub inputs required by the family."""
    task = SyntheticTask(vocab=cfg.vocab, seq_len=shape.seq_len, seed=seed)
    rng = np.random.default_rng(seed + 77)

    def fn(step: int, worker: int, bsz: int) -> dict:
        if cfg.family == "vlm":
            s_text = shape.seq_len - cfg.n_patches
            b = task.batch(step, worker, bsz, seq_len=s_text)
            b["patches"] = rng.standard_normal(
                (bsz, cfg.n_patches, cfg.d_model)).astype(np.float32) * 0.02
            return b
        if cfg.family == "audio":
            b = (task.imbalanced_batch(step, worker, bsz) if imbalanced
                 else task.batch(step, worker, bsz))
            if cfg.encoder_frames:
                b["frames"] = rng.standard_normal(
                    (bsz, cfg.encoder_frames, cfg.d_model)
                ).astype(np.float32) * 0.02
            else:
                b["src"] = np.random.default_rng(seed + step).integers(
                    0, cfg.vocab, (bsz, 64), dtype=np.int32)
            return b
        return (task.imbalanced_batch(step, worker, bsz) if imbalanced
                else task.batch(step, worker, bsz))

    return fn
