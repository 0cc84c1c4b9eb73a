"""K3 on the card: the CUDA kernel against its plain torch version.

Imports neither JAX nor the JAX package, so it runs where the card is:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_kernels_cuda.py

Every test here needs a CUDA card and skips without one.  The shapes are
chip_smoke.py's: tests/test_kernels.py's ATTN_CASES in float32 and
bfloat16, and the serving slice's prefill shapes.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import KERNEL_CASES, SLICE_LENGTHS, TOL  # noqa: E402

CASES = KERNEL_CASES + [(1, L, L, 32, 4, 64, True, None, "bfloat16")
                        for L in SLICE_LENGTHS]


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
