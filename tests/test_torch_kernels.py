"""The port's flash attention (K3) against the JAX package.

On the CPU the port's dispatcher takes the plain torch version; it and the
naive oracle are held against the Pallas kernel (interpret mode, as
tests/test_kernels.py runs it) and the model's ``blocked_attention`` on the
same numpy inputs.  Tolerances are those of tests/test_kernels.py: 2e-4 in
float32, 3e-2 in bfloat16.  The kernel itself runs only on a CUDA card:
tests/test_torch_kernels_cuda.py holds it against the plain version there.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models.common import blocked_attention as jax_blocked
from repro_torch.kernels import _build, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import (ATTN_CASES, TOL,  # noqa: E402
                        bf16_bound, bf16_faults,  # (tests/test_kernels.py's)
                        check_k3_build, check_k4_build, ptxas_report)


def _inputs(case, seed=0):
    b, sq, sk, h, kh, hd = case[:6]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, hd)).astype(np.float32),
            rng.standard_normal((b, sk, kh, hd)).astype(np.float32),
            rng.standard_normal((b, sk, kh, hd)).astype(np.float32))


def _torch(a, dtype, device="cpu"):
    return torch.from_numpy(a).to(device=device, dtype=getattr(torch, dtype))


def _np(x):
    return np.asarray(x.float().cpu() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("case", ATTN_CASES)
def test_plain_and_ref_match_pallas_and_blocked(case):
    causal, window, dtype = case[6:]
    qn, kn, vn = _inputs(case)
    jq, jk, jv = (jnp.asarray(a, getattr(jnp, dtype)) for a in (qn, kn, vn))
    tq, tk, tv = (_torch(a, dtype) for a in (qn, kn, vn))
    pallas = _np(jops.flash_attention(jq, jk, jv, causal=causal,
                                      window=window, block_q=64, block_k=64))
    blocked = _np(jax_blocked(jq, jk, jv, causal=causal, window=window,
                              block_q=64, block_k=64))
    plain = ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                                block_q=64, block_k=64)
    oracle = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    assert plain.dtype == tq.dtype and plain.shape == tq.shape
    tol = TOL[dtype]
    for got in (_np(plain), _np(oracle)):
        np.testing.assert_allclose(got, pallas, rtol=tol, atol=tol)
        np.testing.assert_allclose(got, blocked, rtol=tol, atol=tol)


@pytest.mark.parametrize("q_offset,window", [(40, None), (40, 24)])
def test_plain_q_offset_matches_blocked(q_offset, window):
    qn, kn, vn = _inputs((1, 24, 64, 4, 2, 32))
    want = jax_blocked(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn),
                       causal=True, window=window, block_q=16, block_k=16,
                       q_offset=q_offset)
    got = fa.flash_attention_plain(
        torch.from_numpy(qn), torch.from_numpy(kn), torch.from_numpy(vn),
        causal=True, window=window, block_q=16, block_k=16, q_offset=q_offset)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_plain_fully_masked_rows_are_zero():
    """A row that sees no key (its window lies past the cache) is 0, not
    NaN: masked scores add an exact zero and the denominator is clamped."""
    qn, kn, vn = _inputs((1, 8, 16, 2, 1, 16))
    out = fa.flash_attention_plain(
        torch.from_numpy(qn), torch.from_numpy(kn), torch.from_numpy(vn),
        causal=True, window=4, q_offset=100)
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.parametrize("case", [(2, 128, 128, 4, 2, 64, True, None),
                                  (1, 300, 300, 2, 1, 256, True, 64)])
def test_bf16_bound_passes_plain_and_rejects_planted_faults(case):
    """chip_smoke's element-wise bf16 bound for K3: the plain version's bf16
    result passes it; an off-by-one window, a causal edge one key late
    (key q+1 visible) and a skipped KV tile do not."""
    causal, window = case[6:]
    q, k, v = (_torch(a, "bfloat16") for a in _inputs(case))
    excess = bf16_bound(q, k, v, causal, window)
    assert excess(fa.flash_attention_plain(q, k, v, causal=causal,
                                           window=window)) <= 0.5
    faults = bf16_faults(q, k, v, causal, window)
    assert "causal_leak" in faults
    assert len(faults) == (3 if window else 2)
    for name, out in faults.items():
        assert out.shape == q.shape and out.dtype == q.dtype
        assert excess(out) > 1, name


def test_cpu_dispatch_takes_plain_path_and_counts_nothing():
    ops.reset_launch_counts()
    qn, kn, vn = _inputs((1, 16, 16, 2, 1, 16))
    ops.flash_attention(torch.from_numpy(qn), torch.from_numpy(kn),
                        torch.from_numpy(vn))
    assert ops.launch_counts() == {"flash_attention": 0,
                                   "group_average_combine": 0,
                                   "group_average_combine_multi": 0,
                                   "rglru_scan": 0, "rglru_scan_tma": 0,
                                   "rglru_scan_walk": 0}
    with pytest.raises(ValueError):
        ops.flash_attention(*(torch.from_numpy(a).to("meta")
                              for a in (qn, kn, vn)))


def test_flash_attention_refuses_inputs_that_need_a_gradient():
    """K3 is forward only: its CUDA output carries no gradient, so the
    dispatcher raises on either device when grad is enabled and an input
    requires grad, instead of silently cutting the graph."""
    q, k, v = (torch.from_numpy(a) for a in _inputs((1, 8, 8, 2, 1, 16)))
    for needs in (q, k, v):
        needs.requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            ops.flash_attention(q, k, v)
        with torch.no_grad():
            assert ops.flash_attention(q, k, v).grad_fn is None
        needs.requires_grad_(False)
    assert ops.flash_attention(q, k, v).shape == q.shape


def test_build_is_lazy_and_targets_sm90a():
    assert _build.sources() == ["flash_attention", "group_average",
                                "rglru_scan"]
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build._libs == {}           # importing compiled nothing
    assert _build.BUILD_DIR.parts[-2:] == ("build", "kernels")


def test_lib_path_follows_source_and_shared_header(tmp_path, monkeypatch):
    """A library is named by a hash of its source, every shared header
    beside it and the flags: editing any of them names a new library, so a
    stale build is never loaded."""
    (tmp_path / "k.cu").write_text('#include "hopper.cuh"\n')
    (tmp_path / "hopper.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._lib_path("k")
    assert _build._lib_path("k") == first
    (tmp_path / "hopper.cuh").write_text("// v2\n")
    second = _build._lib_path("k")
    assert second != first
    (tmp_path / "other.cuh").write_text("// new header\n")
    third = _build._lib_path("k")
    assert third != second
    flags = _build.NVCC_FLAGS
    monkeypatch.setattr(_build, "NVCC_FLAGS", (*flags, "-G"))
    assert _build._lib_path("k") not in (first, second, third)
    monkeypatch.setattr(_build, "NVCC_FLAGS", flags)
    assert _build._lib_path("k") == third
    (tmp_path / "k.cu").write_text("// edited\n")
    assert _build._lib_path("k") != third


# ptxas -v lines as nvcc prints them for two K3 kernels (sm_90a)
_PTXAS = """\
ptxas info    : Compiling entry function '_ZN4_GLOBAL__N_114attn_fwd_wgmmaILi64EEEv' for 'sm_90a'
ptxas info    : Function properties for _ZN4_GLOBAL__N_114attn_fwd_wgmmaILi64EEEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN4_GLOBAL__N_112attn_fwd_f32ILi64EEEv' for 'sm_90a'
ptxas info    : Function properties for _ZN4_GLOBAL__N_112attn_fwd_f32ILi64EEEv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 140 registers, used 1 barriers, 16384 bytes smem
ptxas info    : Compiling entry function '_ZN4_GLOBAL__N_114attn_fwd_wgmmaILi256EEEv' for 'sm_90a'
ptxas info    : Function properties for _ZN4_GLOBAL__N_114attn_fwd_wgmmaILi256EEEv
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
"""


def test_ptxas_report_parses_kernels_and_k3_check_refuses_spills():
    """chip_smoke reads K3's ptxas report: registers and spills per kernel;
    any spill of a bf16 (wgmma) kernel fails the run, the f32 kernel is not
    held to it."""
    got = ptxas_report(_PTXAS)
    assert got["_ZN4_GLOBAL__N_114attn_fwd_wgmmaILi64EEEv"] == {
        "stack": 0, "spill_stores": 0, "spill_loads": 0, "registers": 168}
    assert got["_ZN4_GLOBAL__N_114attn_fwd_wgmmaILi256EEEv"]["spill_loads"] == 4
    assert len(got) == 3
    with pytest.raises(AssertionError, match="spill"):
        check_k3_build(_PTXAS)
    clean = _PTXAS.replace("4 bytes spill stores, 4 bytes spill loads",
                           "0 bytes spill stores, 0 bytes spill loads")
    assert sorted(check_k3_build(clean)) == [
        "_ZN4_GLOBAL__N_114attn_fwd_wgmmaILi256EEEv",
        "_ZN4_GLOBAL__N_114attn_fwd_wgmmaILi64EEEv"]
    with pytest.raises(AssertionError, match="no bf16"):
        check_k3_build("")


# ptxas -v lines for K4's library: a walk-route kernel and two TMA-route ones
_PTXAS_K4 = """\
ptxas info    : Function properties for _ZN4_GLOBAL__N_117rglru_scan_kernelIffEEvPKT_PKT0_PKfPS3_ii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers
ptxas info    : Function properties for _ZN4_GLOBAL__N_121rglru_scan_tma_kernelIffEEv14CUtensorMap_stS1_PKfPT0_ii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers
ptxas info    : Function properties for _ZN4_GLOBAL__N_121rglru_scan_tma_kernelI13__nv_bfloat16fEEv14CUtensorMap_stS2_PKfPT0_ii
    16 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 255 registers
"""


def test_k4_build_check_covers_only_tma_kernels_and_refuses_spills():
    """chip_smoke fails the run if ptxas spills in any TMA-route K4
    kernel; the walk-route kernel is not counted among them."""
    with pytest.raises(AssertionError, match="K4 TMA kernels spill"):
        check_k4_build(_PTXAS_K4)
    clean = _PTXAS_K4.replace("8 bytes spill stores, 8 bytes spill loads",
                              "0 bytes spill stores, 0 bytes spill loads")
    got = check_k4_build(clean)
    assert len(got) == 2 and all("rglru_scan_tma_kernel" in n for n in got)
    with pytest.raises(AssertionError, match="no K4 TMA kernel"):
        check_k4_build(_PTXAS)
