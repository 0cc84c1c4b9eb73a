"""Flash attention forward: the Hopper kernel K3 and its plain version.

``flash_attention_cuda`` launches ``csrc/flash_attention.cu``, the
hand-written replacement of ``repro/kernels/flash_attention.py::
_attn_kernel``: for bfloat16 a warp-specialised kernel that loads tiles by
TMA through an mbarrier ring and runs both products on ``wgmma``; scalar
FMAs for float32; head dims 16-128 in steps of 16 and 256 (see the
source's note for the design and what bounds it).
``flash_attention_plain`` computes the same function in torch with the
algorithm of ``repro.models.common.blocked_attention``: an online softmax
over KV blocks with fp32 m/l/acc, visiting only the blocks a causal mask or
a window can reach.  Masked scores contribute an exact zero, so a row with
no visible key returns 0 rather than NaN.

Both take the JAX layouts: q (B,Sq,H,hd), k/v (B,Sk,KH,hd) -> (B,Sq,H,hd).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
HD_SUPPORTED = tuple(range(16, 129, 16)) + (256,)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# Launches of the CUDA kernel since the last reset (kernels/ops.py reads it).
launches = 0


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          window: Optional[int] = None, block_q: int = 512,
                          block_k: int = 1024, q_offset: int = 0):
    """Online-softmax attention in torch; ``q_offset`` is q[0]'s position."""
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    rep = h // kh
    scale = 1.0 / math.sqrt(hd)
    block_q, block_k = min(block_q, sq), min(block_k, sk)
    dev = q.device
    qf = q.float().permute(0, 2, 1, 3).reshape(b, kh, rep, sq, hd)
    kf = k.float().permute(0, 2, 1, 3)                    # (B,KH,Sk,hd)
    vf = v.float().permute(0, 2, 1, 3)
    out = torch.empty((b, kh, rep, sq, hd), dtype=torch.float32, device=dev)
    for q0 in range(0, sq, block_q):
        q1 = min(q0 + block_q, sq)
        qb = qf[:, :, :, q0:q1]
        q_pos = q_offset + torch.arange(q0, q1, device=dev)
        lo = max(0, q_offset + q0 - window + 1) if window is not None else 0
        hi = min(sk, q_offset + q1) if causal else sk
        m = torch.full(qb.shape[:-1], NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qb)
        for k0 in range(lo - lo % block_k, hi, block_k):
            k1 = min(k0 + block_k, sk)
            s = torch.einsum("bgrqd,bgkd->bgrqk", qb, kf[:, :, k0:k1]) * scale
            k_pos = torch.arange(k0, k1, device=dev)
            mask = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool, device=dev)
            if causal:
                mask &= k_pos[None, :] <= q_pos[:, None]
            if window is not None:
                mask &= k_pos[None, :] > q_pos[:, None] - window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bgrqk,bgkd->bgrqd", p, vf[:, :, k0:k1])
            m = m_new
        out[:, :, :, q0:q1] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, h, sq, hd).permute(0, 2, 1, 3).to(q.dtype)


def _check(q, k, v, window):
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention_cuda: q, k, v must be on one CUDA device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_cuda: dtypes {q.dtype}/{k.dtype}/"
                         f"{v.dtype}; need one of float32, bfloat16")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention_cuda: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[2]:
        raise ValueError(f"flash_attention_cuda: k/v {tuple(k.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if hd not in HD_SUPPORTED:
        raise ValueError(f"flash_attention_cuda: head dim {hd} not in "
                         f"{HD_SUPPORTED}")
    if sq < 1 or k.shape[1] < 1 or b * h > 65535:
        raise ValueError("flash_attention_cuda: need Sq, Sk >= 1 and "
                         "B*H <= 65535")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention_cuda: inputs must be contiguous")
    # TMA (bf16) and the 16-byte vector loads (f32) need a 16-byte-aligned
    # base and row strides in multiples of 16 bytes; contiguous rows are
    # hd * itemsize apart
    if (any(t.data_ptr() % 16 for t in (q, k, v))
            or hd * q.element_size() % 16):
        raise ValueError("flash_attention_cuda: inputs must be 16-byte "
                         "aligned with 16-byte row strides")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention_cuda: window {window} < 1")


def _entry():
    fn = _build.load("flash_attention").repro_flash_attention_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
    return fn


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: Optional[int] = None):
    """Launch the Hopper kernel on q's current stream; raises on any input
    it does not take and on a failed launch."""
    global launches
    _check(q, k, v, window)
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    fn = _entry()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, sq, sk, h, kh, hd, 1.0 / math.sqrt(hd), int(causal),
                 int(window or 0), _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error "
                           f"{err} at q {tuple(q.shape)} k {tuple(k.shape)} "
                           f"{q.dtype}")
    launches += 1
    return out
