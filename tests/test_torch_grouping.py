"""The port's copy of the dynamic grouping schedule (paper Algorithm 1)
against the JAX package's, for every power-of-two P <= 64 and group size,
with the paper's P=8, S=4 worked example pinned (DESIGN.md §3)."""

import pytest

from repro.core import grouping as jg
from repro_torch.core import grouping as tg

P_S = [(1 << lp, 1 << ls) for lp in range(0, 7) for ls in range(0, lp + 1)]


@pytest.mark.parametrize("P,S", P_S)
def test_every_function_matches_jax(P, S):
    assert tg.ilog2(P) == jg.ilog2(P)
    assert tg.default_group_size(P) == jg.default_group_size(P)
    assert tg.n_phases(P, S) == jg.n_phases(P, S)
    assert tg.distinct_offsets(P, S) == jg.distinct_offsets(P, S)
    assert tg.propagation_latency(P, S) == jg.propagation_latency(P, S)
    for t in range(2 * tg.ilog2(P) + 3):
        assert tg.phase_offset(P, S, t) == jg.phase_offset(P, S, t)
        assert tg.mask_bits(P, S, t) == jg.mask_bits(P, S, t)
        assert tg.groups_for_iteration(P, S, t) == \
            jg.groups_for_iteration(P, S, t)
        assert tg.averaging_matrix(P, S, t) == jg.averaging_matrix(P, S, t)
    for off in range(tg.ilog2(P) or 1):
        assert tg.mask_bits_for_offset(P, S, off) == \
            jg.mask_bits_for_offset(P, S, off)
        assert tg.groups_for_offset(P, S, off) == \
            jg.groups_for_offset(P, S, off)
    sizes = [2] * tg.ilog2(P) or [1]
    for bit in range(tg.ilog2(P)):
        assert tg.split_bit_over_axes(bit, sizes) == \
            jg.split_bit_over_axes(bit, sizes)


def test_paper_example_p8_s4():
    assert tg.distinct_offsets(8, 4) == (0, 2, 1)
    assert [tg.mask_bits(8, 4, t) for t in range(3)] == \
        [(0, 1), (2, 0), (1, 2)]
    assert tg.groups_for_iteration(8, 4, 0) == ((0, 1, 2, 3), (4, 5, 6, 7))
    assert tg.groups_for_iteration(8, 4, 1) == ((0, 1, 4, 5), (2, 3, 6, 7))
    assert tg.groups_for_iteration(8, 4, 2) == ((0, 2, 4, 6), (1, 3, 5, 7))
    assert tg.propagation_latency(8, 4) == 2


def test_invalid_sizes_raise_like_jax():
    for bad in (0, 3, 12):
        with pytest.raises(ValueError):
            tg.ilog2(bad)
        with pytest.raises(ValueError):
            jg.ilog2(bad)
    with pytest.raises(ValueError):
        tg.split_bit_over_axes(3, (2, 2))
