"""The butterfly combine K1/K2: the port's plain versions against the JAX
package's Pallas kernels (interpret mode, as tests/test_kernels.py runs
them) and against both packages' oracles, bit for bit, in float32 and
bfloat16, on empty, lane-unaligned and ragged inputs.

On the CPU ``kernels/ops.py`` takes the plain versions and launches
nothing; the CUDA kernels are held against the same plain versions on the
card (tests/test_torch_kernels_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import group_average as ga
from repro_torch.kernels import ops, ref

DTYPES = ["float32", "bfloat16"]
SCALES = [1.0, 0.25, 1.0 / 3.0]
SHAPES = [(0,), (1,), (127,), (128,), (1000,), (3, 5, 7), (2, 0, 4), (4099,)]


def _pair(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(shape) * 3).astype(np.float32)
    r = (rng.standard_normal(shape) * 3).astype(np.float32)
    return ((torch.from_numpy(w).to(getattr(torch, dtype)),
             torch.from_numpy(r).to(getattr(torch, dtype))),
            (jnp.asarray(w, getattr(jnp, dtype)),
             jnp.asarray(r, getattr(jnp, dtype))))


def _bits(x):
    """Raw bits (float32 view is exact for bf16 too)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy().view(np.uint32)
    return np.asarray(x, np.float32).view(np.uint32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("inv_s", SCALES)
def test_k1_plain_bit_exact_vs_pallas_and_refs(dtype, inv_s):
    for i, shape in enumerate(SHAPES):
        (w, r), (jw, jr) = _pair(shape, dtype, i)
        got = ops.group_average_combine(w, r, inv_s)
        assert got.dtype == w.dtype and got.shape == w.shape
        want = jops.group_average_combine(jw, jr, inv_s)
        np.testing.assert_array_equal(_bits(got), _bits(want),
                                      err_msg=f"{shape} {dtype} {inv_s}")
        np.testing.assert_array_equal(
            _bits(got), _bits(jref.group_average_ref(jw, jr, inv_s)))
        np.testing.assert_array_equal(
            _bits(got), _bits(ref.group_average_ref(w, r, inv_s)))
        np.testing.assert_array_equal(
            _bits(got), _bits(ga.group_average_combine_plain(w, r, inv_s)))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("inv_s", SCALES)
def test_k2_plain_bit_exact_vs_pallas_on_ragged_lists(dtype, inv_s):
    sizes = [1000, 1, 128, 3 * 128 + 5, 0, 77, 256]
    pairs = [_pair((n,), dtype, 10 + i) for i, n in enumerate(sizes)]
    ws = [p[0][0] for p in pairs]
    rs = [p[0][1] for p in pairs]
    got = ops.group_average_combine_multi(ws, rs, inv_s)
    want = jops.group_average_combine_multi([p[1][0] for p in pairs],
                                            [p[1][1] for p in pairs], inv_s)
    assert len(got) == len(sizes)
    for g, wnt, w, r in zip(got, want, ws, rs):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(_bits(g), _bits(wnt))
        # each result is K1 on its own pair
        np.testing.assert_array_equal(
            _bits(g), _bits(ops.group_average_combine(w, r, inv_s)))


def test_empty_input_returns_w_and_cpu_launches_nothing():
    ops.reset_launch_counts()
    w = torch.zeros((0, 3))
    assert ops.group_average_combine(w, w.clone(), 0.5) is w
    (a, b), _ = _pair((300,), "float32", 0)
    out = a.clone()
    res = ops.group_average_combine(a, b, 0.25, out=out)
    assert res is out
    np.testing.assert_array_equal(_bits(out),
                                  _bits(ref.group_average_ref(a, b, 0.25)))
    ops.group_average_combine_multi([a, a], [b, b], 1.0, outs=[a.clone(),
                                                              a.clone()])
    assert ops.launch_counts() == {"flash_attention": 0,
                                   "group_average_combine": 0,
                                   "group_average_combine_multi": 0,
                                   "rglru_scan": 0, "rglru_scan_tma": 0,
                                   "rglru_scan_walk": 0}


def test_multi_validation_errors_like_jax():
    (a, b), (ja, jb) = _pair((8,), "float32", 1)
    for args in (([], []), ([a], [b, b])):
        with pytest.raises(ValueError):
            ops.group_average_combine_multi(*args, 0.5)
    with pytest.raises(ValueError):
        ops.group_average_combine_multi([a, a.bfloat16()], [b, b.bfloat16()],
                                        0.5)
    with pytest.raises(ValueError):
        jops.group_average_combine_multi([], [], 0.5)
    with pytest.raises(ValueError):
        jops.group_average_combine_multi([ja, ja.astype(jnp.bfloat16)],
                                         [jb, jb.astype(jnp.bfloat16)], 0.5)
    with pytest.raises(ValueError):                # not a CPU or CUDA tensor
        ops.group_average_combine(a.to("meta"), b.to("meta"), 0.5)


def test_cuda_wrappers_reject_cpu_tensors():
    """The kernel wrappers never take the plain path: a CPU tensor is an
    error there, not a fallback."""
    (a, b), _ = _pair((16,), "float32", 2)
    with pytest.raises(ValueError):
        ga.group_average_combine_cuda(a, b, 0.5)
    with pytest.raises(ValueError):
        ga.group_average_combine_multi_cuda([a, a], [b, b], 0.5)
