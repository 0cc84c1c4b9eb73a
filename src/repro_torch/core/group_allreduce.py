"""Stacked group averaging simulator and the alpha-beta collective model.

Counterpart of ``repro/core/group_allreduce.py`` (its removed kwarg shims
have no counterpart).  Execution lives in ``core/plan.py``; what stays
here: the minor-to-major dp-axis layout helper, the stacked simulator
(``W <- A_t @ W``, the oracle the plan is held against) and the classic
single-class alpha-beta(-gamma) cost model that ``bucketing``'s budget
sweep reads.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import grouping
from repro_torch.core import overlap as pipeline
from repro_torch.core import tree as tr
# the cost model's defaults (bucketing's budget sweep reads them here)
from repro_torch.core.plan import DEFAULT_ALPHA, DEFAULT_BETA, DEFAULT_GAMMA  # noqa: F401


def dp_axis_layout(mesh_axis_names: Sequence[str], mesh_shape: dict,
                   dp_axes: Sequence[str]) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """Minor-to-major dp axis names/sizes for global dp-rank bit mapping.

    Mesh axes are major-to-minor left-to-right, so ('pod', 'data', 'model')
    with dp_axes ('pod', 'data') gives names=('data', 'pod'),
    sizes=(16, 2): global dp rank = pod*16 + data.
    """
    ordered = [a for a in mesh_axis_names if a in dp_axes]
    names = tuple(reversed(ordered))
    sizes = tuple(mesh_shape[a] for a in names)
    return names, sizes


# ---------------------------------------------------------------------------
# Stacked simulator path (leading replica axis)
# ---------------------------------------------------------------------------

def averaging_matrix(P: int, S: int, t: int) -> np.ndarray:
    return np.asarray(grouping.averaging_matrix(P, S, t), dtype=np.float32)


def group_average_stacked(stacked_tree, *, P: int, S: int, t: int):
    """Simulator: W[i] <- mean over i's group, on (P, ...) stacked trees."""
    A = torch.from_numpy(averaging_matrix(P, S, t))

    def avg_leaf(w):
        flat = w.reshape(P, -1).float()
        out = A.to(flat.device) @ flat
        return out.reshape(w.shape).to(w.dtype)

    return tr.tree_map(avg_leaf, stacked_tree)


def global_average_stacked(stacked_tree, *, P: int):
    def avg_leaf(w):
        mean = w.float().mean(0, keepdim=True)
        return mean.expand(w.shape).to(w.dtype).contiguous()

    return tr.tree_map(avg_leaf, stacked_tree)


# ---------------------------------------------------------------------------
# Analytical collective-cost model (single link class)
# ---------------------------------------------------------------------------

def collective_bytes_per_device(n_bytes: int, P: int, S: int,
                                algorithm: str = "wagma") -> float:
    """Bytes sent per device per training step for an n_bytes payload.

    butterfly global  : log2(P) * N        (recursive doubling, full payload)
    ring allreduce    : 2N(P-1)/P ~= 2N    (bandwidth-optimal global)
    wagma group       : log2(S) * N        (the paper's saving)
    gossip (D-PSGD)   : 2N                 (two neighbours)
    """
    lp, ls = grouping.ilog2(P), grouping.ilog2(max(S, 1))
    if algorithm == "wagma":
        return ls * n_bytes
    if algorithm == "butterfly_global":
        return lp * n_bytes
    if algorithm == "ring_allreduce":
        return 2.0 * n_bytes * (P - 1) / P
    if algorithm == "gossip":
        return 2.0 * n_bytes
    raise ValueError(algorithm)


def collective_stages(P: int, S: int, algorithm: str = "wagma") -> int:
    """Serial collective rounds per step (the latency-bound term)."""
    lp, ls = grouping.ilog2(P), grouping.ilog2(max(S, 1))
    if algorithm == "wagma":
        return ls
    if algorithm == "butterfly_global":
        return lp
    if algorithm == "ring_allreduce":
        return 2 * (P - 1)
    if algorithm == "gossip":
        return 2
    raise ValueError(algorithm)


def alpha_beta_time(wire_bytes: float, stages: int, *, n_buckets: int = 1,
                    alpha: float = DEFAULT_ALPHA,
                    beta: float = DEFAULT_BETA,
                    gamma: float = 0.0,
                    overlap: bool = False) -> float:
    """``stages`` serial collective rounds: serial
    ``stages * n_buckets * alpha + wire_bytes * (beta + gamma)``; overlapped,
    each stage pays ``max(wire, combine)`` plus fill/drain
    (``overlap.overlapped_stage_seconds``)."""
    b = max(n_buckets, 1)
    if not overlap or stages <= 0:
        return stages * b * alpha + wire_bytes * (beta + gamma)
    per_stage_wire = wire_bytes * beta / stages
    per_stage_combine = wire_bytes * gamma / stages
    return stages * pipeline.overlapped_stage_seconds(
        per_stage_wire, per_stage_combine, b, alpha)


def collective_time(n_bytes: float, P: int, S: int,
                    algorithm: str = "wagma", *, n_buckets: int = 1,
                    alpha: float = DEFAULT_ALPHA,
                    beta: float = DEFAULT_BETA,
                    gamma: float = 0.0,
                    overlap: bool = False) -> float:
    """Alpha-beta wall time per step of one algorithm's collective."""
    wire = collective_bytes_per_device(n_bytes, P, S, algorithm)
    return alpha_beta_time(wire, collective_stages(P, S, algorithm),
                           n_buckets=n_buckets, alpha=alpha, beta=beta,
                           gamma=gamma, overlap=overlap)


def wagma_step_time(n_bytes: float, P: int, S: int, *, tau: int,
                    n_buckets: int = 1, alpha: float = DEFAULT_ALPHA,
                    beta: float = DEFAULT_BETA,
                    gamma: float = 0.0,
                    overlap: bool = False) -> float:
    """Tau-amortised WAGMA averaging seconds/step: (tau-1) group butterflies
    + one ring-allreduce global sync, averaged."""
    group = collective_time(n_bytes, P, S, "wagma", n_buckets=n_buckets,
                            alpha=alpha, beta=beta, gamma=gamma,
                            overlap=overlap)
    sync = collective_time(n_bytes, P, S, "ring_allreduce",
                           n_buckets=n_buckets, alpha=alpha, beta=beta)
    return ((tau - 1) * group + sync) / tau
