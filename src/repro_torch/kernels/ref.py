"""Naive torch oracles for the port's kernels (the allclose targets).

Counterpart of ``repro/kernels/ref.py``: materialise the full score matrix,
slow but obviously correct, for the kernel test sweeps; the butterfly
combine written as its definition; the RG-LRU recurrence as a sequential
fp32 carry; the mLSTM cell run sequentially over a chunk.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True, window=None):
    """q (B,Sq,H,hd), k/v (B,Sk,KH,hd) -> (B,Sq,H,hd). GQA by head repeat."""
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    rep = h // kh
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.where(mask[None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def group_average_ref(w, recv, inv_s: float):
    """Butterfly combine step: (w + recv) * inv_s in fp32, back to w.dtype."""
    return ((w.float() + recv.float()) * inv_s).to(w.dtype)


def rglru_scan_ref(a, x, h0=None):
    """Sequential linear recurrence h_t = a_t*h_{t-1} + x_t; a,x (B,S,W)."""
    b, s, w = x.shape
    h = (torch.zeros((b, w), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    out = torch.empty_like(x)
    for t in range(s):
        h = a[:, t].float() * h + x[:, t].float()
        out[:, t] = h                   # each h_t cast to x's dtype
    return out


def mlstm_chunk_ref(q, k, v, i_pre, f_pre):
    """Sequential mLSTM (``models/xlstm.py`` ``mlstm_step``, one a token).

    q,k,v (B,S,H,dh); i_pre,f_pre (B,S,H). Returns h (B,S,H,dh) fp32.
    """
    from repro_torch.models.xlstm import mlstm_init_state, mlstm_step
    b, s, h, dh = q.shape
    state = mlstm_init_state(b, h, dh, q.device)
    hs = []
    for t in range(s):
        state, ht = mlstm_step(state, (q[:, t], k[:, t], v[:, t],
                                       i_pre[:, t], f_pre[:, t]))
        hs.append(ht)
    return torch.stack(hs, dim=1)
