"""Dynamic grouping strategy (paper Algorithm 1).

The port's own copy of ``repro/core/grouping.py`` (pure Python; the tests
pin every function to the JAX package's).

The paper's pseudocode (``mask <<= shift``) is internally inconsistent with its
own worked example (P=8, S=4: iteration 1 must yield groups {0,1,4,5} and
{2,3,6,7}); the example-consistent form — which we implement and pin with
tests — is:

    stage r of iteration t exchanges over XOR-mask bit  (t*log2(S) + r) % log2(P)

for r = 0..log2(S)-1.  The union of those pairwise XOR relations partitions the
P workers into P/S non-overlapping groups of size S, and the initial bit
rotates every iteration so local updates propagate globally within
ceil(log(P)/log(S)) iterations.

Everything in this module is pure Python/NumPy on *static* quantities (the
group pattern of iteration t): the training loop selects one of
``n_phases(P, S)`` step variants by ``phase_offset(P, S, t)``.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import List, Sequence, Tuple


def ilog2(x: int) -> int:
    """Exact integer log2; raises for non powers of two."""
    if x <= 0 or (x & (x - 1)) != 0:
        raise ValueError(f"{x} is not a positive power of two")
    return x.bit_length() - 1


def default_group_size(P: int) -> int:
    """The paper's S = sqrt(P), rounded down to a power of two (S>=2 for P>=4)."""
    lp = ilog2(P)
    return 1 << max(1, lp // 2) if P >= 4 else P


def phase_offset(P: int, S: int, t: int) -> int:
    """First butterfly bit used at iteration t: (t*log2 S) mod log2 P."""
    lp, ls = ilog2(P), ilog2(S)
    if ls == 0:
        return 0
    return (t * ls) % lp


def n_phases(P: int, S: int) -> int:
    """Number of distinct phase offsets (== number of compiled step variants)."""
    lp, ls = ilog2(P), ilog2(S)
    if ls == 0:
        return 1
    # offsets cycle through multiples of gcd(ls, lp) mod lp
    return lp // math.gcd(ls, lp)


def distinct_offsets(P: int, S: int) -> Tuple[int, ...]:
    """The phase offsets actually reached over the iteration sequence."""
    seen, out, t = set(), [], 0
    lp = ilog2(P)
    for t in range(lp + 1):
        o = phase_offset(P, S, t)
        if o in seen:
            break
        seen.add(o)
        out.append(o)
    return tuple(out)


def mask_bits_for_offset(P: int, S: int, offset: int) -> Tuple[int, ...]:
    """XOR-mask bit positions for the log2(S) butterfly stages, given an offset."""
    lp, ls = ilog2(P), ilog2(S)
    return tuple((offset + r) % lp for r in range(ls))


def mask_bits(P: int, S: int, t: int) -> Tuple[int, ...]:
    """XOR-mask bit positions exercised at iteration t (Algorithm 1)."""
    return mask_bits_for_offset(P, S, phase_offset(P, S, t))


@lru_cache(maxsize=None)
def groups_for_offset(P: int, S: int, offset: int) -> Tuple[Tuple[int, ...], ...]:
    """Partition of range(P) into P/S groups of size S for a phase offset.

    Union-find over the pairwise XOR equivalence relations of Algorithm 1.
    """
    bits = mask_bits_for_offset(P, S, offset)
    parent = list(range(P))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for b in bits:
        m = 1 << b
        for p in range(P):
            q = p ^ m
            rp, rq = find(p), find(q)
            if rp != rq:
                parent[max(rp, rq)] = min(rp, rq)

    byroot = {}
    for p in range(P):
        byroot.setdefault(find(p), []).append(p)
    groups = tuple(tuple(sorted(g)) for g in sorted(byroot.values()))
    assert all(len(g) == S for g in groups), (P, S, offset, groups)
    return groups


def groups_for_iteration(P: int, S: int, t: int) -> Tuple[Tuple[int, ...], ...]:
    """The P/S groups active at training iteration t."""
    return groups_for_offset(P, S, phase_offset(P, S, t))


def averaging_matrix(P: int, S: int, t: int):
    """Doubly-stochastic P x P matrix A_t with A[i,j] = 1/S iff same group.

    Used by the stacked (single-process) simulator: W_next = A_t @ W.
    Returned as a nested list to keep this module free of numpy and torch.
    """
    A = [[0.0] * P for _ in range(P)]
    for g in groups_for_iteration(P, S, t):
        w = 1.0 / S
        for i in g:
            for j in g:
                A[i][j] = w
    return A


def propagation_latency(P: int, S: int) -> int:
    """Iterations for one worker's update to influence all P workers.

    With dynamic grouping each iteration multiplies the influenced set by S
    (fresh bits every step), so ceil(log_S P) iterations suffice — the paper's
    `log_S P` claim (e.g. P=64, S=8 -> 2).
    """
    if S <= 1:
        return math.inf if P > 1 else 0
    lp, ls = ilog2(P), ilog2(S)
    return math.ceil(lp / ls)


def split_bit_over_axes(bit: int, axis_sizes: Sequence[int]) -> Tuple[int, int]:
    """Map a global dp-rank XOR bit onto (axis_index, local_bit).

    ``axis_sizes`` is minor-to-major (e.g. [16, 2] for data=16 minor,
    pod=2 major; global rank = pod_idx*16 + data_idx).
    """
    for ax, size in enumerate(axis_sizes):
        lb = ilog2(size)
        if bit < lb:
            return ax, bit
        bit -= lb
    raise ValueError("bit exceeds total dp rank space")
