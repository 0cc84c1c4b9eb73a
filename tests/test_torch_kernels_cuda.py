"""K3, K1, K2 and K4 on the card: the CUDA kernels against their plain
torch versions.

Imports neither JAX nor the JAX package, so it runs where the card is:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_kernels_cuda.py

Every test here needs a CUDA card and skips without one.  The shapes are
chip_smoke.py's: tests/test_kernels.py's ATTN_CASES in float32 and
bfloat16, the head dim 256 cases, the serving slices' prefill shapes (with
transformer-wmt's encoder, decoder and cross-attention, WMT_ATTN_CASES) and
the edges of the TMA/wgmma bf16 kernel (TMA_EDGE_CASES), for K3; the
butterfly combine's sizes, ragged lists and scales for K1/K2 (also in
place, ``out`` is ``w``), and RGLRU_CASES, recurrentgemma's scan shapes
and a ragged W in both dtypes, with and without h0, and the edges of K4's
TMA route (K4_EDGE_CASES) on both routes, with the route asserted, for
K4, also through ``rglru_scan_train`` (forward and backward scan): K1, K2
and K4 must be bit-identical to their plain versions.
"""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import group_average as ga
from repro_torch.kernels import ops
from repro_torch.kernels import rglru_scan as rg

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import (GA_DTYPES, GA_RAGGED, GA_SCALES,  # noqa: E402
                        GA_SIZES, HD256_CASES, K4_CASES, K4_DTYPES,
                        K4_EDGE_CASES, KERNEL_CASES, SLICE_LENGTHS,
                        TMA_EDGE_CASES, TOL, WMT_ATTN_CASES, bf16_bound)

CASES = KERNEL_CASES + [(1, L, L, 32, 4, 64, True, None, "bfloat16")
                        for L in SLICE_LENGTHS] + HD256_CASES + \
    TMA_EDGE_CASES + WMT_ATTN_CASES


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(case, device):
    b, sq, sk, h, kh, hd = case[:6]
    dtype = getattr(torch, case[8])
    rng = np.random.default_rng(0)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                  ).to(device=device, dtype=dtype)
                 for shape in ((b, sq, h, hd), (b, sk, kh, hd), (b, sk, kh, hd)))


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain_on_card(case, cuda_device):
    causal, window, dtype = case[6:]
    q, k, v = _inputs(case, cuda_device)
    before = ops.launch_counts()["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               rtol=TOL[dtype], atol=TOL[dtype])
    if dtype == "bfloat16":     # and element by element, scaled to the output
        assert bf16_bound(q, k, v, causal, window)(got) <= 1


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    q, k, v = _inputs((1, 8, 8, 2, 1, 40, True, None, "float32"), cuda_device)
    with pytest.raises(ValueError):             # hd 40: not a multiple of 16
        ops.flash_attention(q, k, v)
    q, k, v = _inputs((1, 8, 8, 2, 1, 32, True, None, "float32"), cuda_device)
    with pytest.raises(NotImplementedError):
        ops.flash_attention(q, k, v, q_offset=4)
    with pytest.raises(ValueError):             # f16 is not a kernel dtype
        ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):             # not contiguous
        ops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)


def _pair(n, dtype, device, offset=0, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    base = torch.randn(2, n + offset, generator=gen, device=device).to(
        getattr(torch, dtype))
    return base[0, offset:], base[1, offset:]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", GA_DTYPES)
@pytest.mark.parametrize("scale", GA_SCALES)
def test_k1_bit_identical_to_plain_on_card(dtype, scale, cuda_device):
    for n, offset in [(n, 0) for n in GA_SIZES] + [(1000, 1), (4099, 1)]:
        w, r = _pair(n, dtype, cuda_device, offset)
        before = ops.launch_counts()["group_average_combine"]
        got = ops.group_average_combine(w, r, scale)
        want = ga.group_average_combine_plain(w, r, scale)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (n, offset)
        assert ops.launch_counts()["group_average_combine"] == \
            before + (1 if n else 0)
        inplace = w.clone()                        # out may alias w
        ops.group_average_combine(inplace, r, scale, out=inplace)
        assert torch.equal(inplace, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", GA_DTYPES)
@pytest.mark.parametrize("scale", GA_SCALES)
def test_k2_bit_identical_to_plain_on_card(dtype, scale, cuda_device):
    for sizes, offsets, launches in (
            (GA_RAGGED, [0] * len(GA_RAGGED), 1),
            (GA_RAGGED, [i % 2 for i in range(len(GA_RAGGED))], 1),
            ([97 + 13 * i for i in range(70)], [i % 2 for i in range(70)],
             2)):
        pairs = [_pair(n, dtype, cuda_device, off, seed=i)
                 for i, (n, off) in enumerate(zip(sizes, offsets))]
        ws, rs = [p[0] for p in pairs], [p[1] for p in pairs]
        before = ops.launch_counts()["group_average_combine_multi"]
        got = ops.group_average_combine_multi(ws, rs, scale)
        want = ga.group_average_combine_multi_plain(ws, rs, scale)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert ops.launch_counts()["group_average_combine_multi"] == \
            before + launches
        for g, w, r in zip(got, ws, rs):          # K2 == K1 on each pair
            assert torch.equal(g, ops.group_average_combine(w, r, scale))
        inplace = [w.clone() for w in ws]          # outs are the ws
        ops.group_average_combine_multi(inplace, rs, scale, outs=inplace)
        assert all(torch.equal(a, b) for a, b in zip(inplace, want))


@pytest.mark.cuda
def test_k1_k2_reject_what_they_do_not_take(cuda_device):
    w, r = _pair(64, "float32", cuda_device)
    with pytest.raises(ValueError):               # sizes differ
        ops.group_average_combine(w, r[:32], 0.5)
    with pytest.raises(ValueError):               # f16 is not a kernel dtype
        ops.group_average_combine(w.half(), r.half(), 0.5)
    with pytest.raises(ValueError):               # not contiguous
        ops.group_average_combine(w.reshape(8, 8).t(), r.reshape(8, 8), 0.5)
    with pytest.raises(ValueError):               # one dtype per launch
        ops.group_average_combine_multi([w, w.bfloat16()],
                                        [r, r.bfloat16()], 0.5)


def _k4_inputs(case, device):
    b, s, w, with_h0, dtype = case
    a_dt, x_dt = K4_DTYPES.get(dtype, (dtype, dtype))
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.uniform(0.5, 0.999, (b, s, w)).astype(
        np.float32)).to(device=device, dtype=getattr(torch, a_dt))
    x = torch.from_numpy((rng.standard_normal((b, s, w)) * 0.1).astype(
        np.float32)).to(device=device, dtype=getattr(torch, x_dt))
    h0 = (torch.from_numpy(rng.standard_normal((b, w)).astype(np.float32)
                           ).to(device) if with_h0 else None)
    return a, x, h0


@pytest.mark.cuda
@pytest.mark.parametrize("case", K4_CASES)
def test_k4_bit_identical_to_plain_on_card(case, cuda_device):
    dtype = case[4]
    a, x, h0 = _k4_inputs(case, cuda_device)
    before = ops.launch_counts()["rglru_scan"]
    got = ops.rglru_scan(a, x, h0)
    want = rg.rglru_scan_plain(a, x, h0)
    torch.cuda.synchronize()
    assert ops.launch_counts()["rglru_scan"] == before + 1
    assert got.dtype == x.dtype and got.shape == x.shape
    assert torch.equal(got, want)
    if dtype == "float32":                   # mixed: bf16 a, f32 x
        assert torch.equal(ops.rglru_scan(a.bfloat16(), x, h0),
                           rg.rglru_scan_plain(a.bfloat16(), x, h0))


@pytest.mark.cuda
def test_k4_rejects_what_it_does_not_take(cuda_device):
    a = torch.rand(2, 5, 8, device=cuda_device)
    x = torch.rand(2, 5, 8, device=cuda_device)
    with pytest.raises(ValueError):               # h0 must be float32
        ops.rglru_scan(a, x, torch.zeros(2, 8, device=cuda_device).bfloat16())
    with pytest.raises(ValueError):               # h0 of another shape
        ops.rglru_scan(a, x, torch.zeros(2, 7, device=cuda_device))
    with pytest.raises(ValueError):               # f16 is not a kernel dtype
        ops.rglru_scan(a.half(), x.half())
    with pytest.raises(ValueError):               # not contiguous
        ops.rglru_scan(a.transpose(0, 1).contiguous().transpose(0, 1), x)
    with pytest.raises(ValueError):               # shapes differ
        ops.rglru_scan(a[:, :4], x)


@pytest.mark.cuda
@pytest.mark.parametrize("case", K4_EDGE_CASES)
def test_k4_tma_edges_bit_identical_on_both_routes(case, cuda_device):
    """The dispatcher takes the route the rule names (asserted by the
    per-route counts); the walk route agrees too; a TMA request on a shape
    the rule sends down the walk route raises."""
    b, s, w = case[:3]
    a, x, h0 = _k4_inputs(case, cuda_device)
    want = rg.rglru_scan_plain(a, x, h0)
    route = "tma" if s >= rg.TMA_STEPS else "walk"   # every edge W is 16-byte
    assert rg.route(s, w, a.dtype, x.dtype,
                    (a.data_ptr(), x.data_ptr(), x.data_ptr())) == route
    before = ops.launch_counts()
    got = ops.rglru_scan(a, x, h0)
    after = ops.launch_counts()
    assert after["rglru_scan"] == before["rglru_scan"] + 1
    assert after[f"rglru_scan_{route}"] == before[f"rglru_scan_{route}"] + 1
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(rg.rglru_scan_cuda(a, x, h0, via="walk"), want)
    if route == "walk":
        with pytest.raises(RuntimeError, match="tma route"):
            rg.rglru_scan_cuda(a, x, h0, via="tma")


@pytest.mark.cuda
def test_k4_misaligned_view_takes_the_walk_route(cuda_device):
    buf = torch.rand(2 * 256 * 64 + 1, device=cuda_device) * 0.5 + 0.5
    a = buf[1:].view(2, 256, 64)                   # 4 bytes past alignment
    x = torch.rand(2, 256, 64, device=cuda_device)
    before = ops.launch_counts()["rglru_scan_walk"]
    got = ops.rglru_scan(a, x)
    assert ops.launch_counts()["rglru_scan_walk"] == before + 1
    assert torch.equal(got, rg.rglru_scan_plain(a, x))
    with pytest.raises(RuntimeError, match="tma route"):
        rg.rglru_scan_cuda(a, x, via="tma")
    with pytest.raises(ValueError, match="route"):
        rg.rglru_scan_cuda(a, x, via="scan")


@pytest.mark.cuda
@pytest.mark.parametrize("case", K4_EDGE_CASES)
def test_k4_scan_train_bit_identical_on_both_routes(case, cuda_device):
    """``rglru_scan_train`` through K4 (forward and backward scan, on the
    route the rule picks and counted on it, then forced onto the walk
    route): its output and its gradients for a, x and h0 bit-identical to
    the same function through the plain scan on the same CUDA tensors."""
    b, s, w = case[:3]
    a, x, h0 = _k4_inputs(case, cuda_device)
    dh = torch.randn(x.shape, generator=torch.Generator(
        device=cuda_device).manual_seed(1), device=cuda_device).to(x.dtype)

    def run(train):
        ins = [t.clone().requires_grad_(True) for t in (a, x, h0)
               if t is not None]
        h = train(ins[0], ins[1], ins[2] if h0 is not None else None)
        return [h.detach()] + list(torch.autograd.grad(h, ins, dh))

    want = run(lambda *t: rg.rglru_scan_train(*t, scan=rg.rglru_scan_plain))
    route = "tma" if s >= rg.TMA_STEPS else "walk"   # every edge W is 16-byte
    before = ops.launch_counts()
    got = run(ops.rglru_scan_train)
    after = ops.launch_counts()
    assert after["rglru_scan"] == before["rglru_scan"] + 2
    assert after[f"rglru_scan_{route}"] == before[f"rglru_scan_{route}"] + 2
    walk = run(lambda *t: rg.rglru_scan_train(*t, scan=functools.partial(
        rg.rglru_scan_cuda, via="walk")))
    torch.cuda.synchronize()
    for g, k, v in zip(got, walk, want):
        assert g.dtype == v.dtype and torch.equal(g, v)
        assert torch.equal(k, v)
