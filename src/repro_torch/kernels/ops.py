"""Dispatch to the hand-written kernels by the device of the input.

A CUDA tensor goes to the kernel, which raises if it cannot be built or
launched; a CPU tensor goes to the kernel's plain torch version.  There is
no fallback from one to the other.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import group_average as _ga
from repro_torch.kernels import rglru_scan as _rg


def _device_kind(t) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def _refuse_grad(name: str, *ts) -> None:
    """The kernels are forward only, as the JAX package's: with grad enabled
    and an input that requires grad, raise on either device, since a CUDA
    output would carry no gradient."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in ts):
        raise RuntimeError(
            f"{name} has no backward: call it under torch.no_grad() or with "
            f"inputs that do not require grad")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, block_q: int = 512,
                    block_k: int = 1024, q_offset: int = 0):
    """q (B,Sq,H,hd), k/v (B,Sk,KH,hd) -> (B,Sq,H,hd).

    ``block_q``/``block_k`` tile the plain version only; the kernel uses its
    own tiles.  ``q_offset`` (q[0]'s position) is taken on the CPU only: the
    serving slice never asks the kernel for it.  Forward only, as the JAX
    package's kernel: with grad enabled and an input that requires grad it
    raises on either device, since the kernel's output carries no gradient
    (training attention is ``models.common.differentiable_blocked_attention``).
    """
    _refuse_grad("flash_attention", q, k, v)
    if _device_kind(q) == "cuda":
        if q_offset:
            raise NotImplementedError(
                "flash_attention kernel: q_offset != 0 is not supported")
        return _fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
    return _fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                     block_q=block_q, block_k=block_k,
                                     q_offset=q_offset)


def group_average_combine(w, recv, inv_s: float, *, out=None):
    """((w + recv) in fp32 * inv_s) in w's dtype; any shape, f32 or bf16 on
    the card.  An empty input returns ``w``.  ``out`` may be ``w``."""
    if w.numel() == 0:
        return w
    if _device_kind(w) == "cuda":
        return _ga.group_average_combine_cuda(w, recv, inv_s, out=out)
    return _ga.group_average_combine_plain(w, recv, inv_s, out=out)


def group_average_combine_multi(ws: Sequence, rs: Sequence, inv_s: float, *,
                                outs: Optional[Sequence] = None
                                ) -> List[torch.Tensor]:
    """K1 on a list of ragged same-dtype pairs with one shared ``inv_s``, in
    one launch; a single pair goes to K1, as in the JAX package.
    ``ValueError`` on mismatched or empty lists and on mixed dtypes."""
    if len(ws) != len(rs) or not ws or (outs is not None
                                        and len(outs) != len(ws)):
        raise ValueError("need matching, non-empty bucket lists")
    dtype = ws[0].dtype
    if any(w.dtype != dtype or r.dtype != dtype for w, r in zip(ws, rs)):
        raise ValueError("multi-bucket combine needs one dtype per launch")
    if len(ws) == 1:
        return [group_average_combine(ws[0], rs[0], inv_s,
                                      out=outs[0] if outs else None)]
    if _device_kind(ws[0]) == "cuda":
        return _ga.group_average_combine_multi_cuda(ws, rs, inv_s, outs=outs)
    return _ga.group_average_combine_multi_plain(ws, rs, inv_s, outs=outs)


def rglru_scan(a, x, h0=None):
    """h_t = a_t * h_{t-1} + x_t over a, x (B,S,W) with an fp32 carry from
    h0 (B,W) or 0; returns h (B,S,W) in x's dtype.  Forward only: with grad
    enabled and an input that requires grad it raises on either device
    (training calls :func:`rglru_scan_train`)."""
    _refuse_grad("rglru_scan", a, x, h0)
    if _device_kind(x) == "cuda":
        return _rg.rglru_scan_cuda(a, x, h0)
    return _rg.rglru_scan_plain(a, x, h0)


def rglru_scan_train(a, x, h0=None):
    """:func:`rglru_scan` with a gradient for a, x and h0: the forward scan
    and the backward scan (the same recurrence reversed in time) are both
    K4 on CUDA tensors and both the plain loop on CPU tensors; each K4
    launch is counted as :func:`rglru_scan`'s are."""
    scan = (_rg.rglru_scan_cuda if _device_kind(x) == "cuda"
            else _rg.rglru_scan_plain)
    return _rg.rglru_scan_train(a, x, h0, scan=scan)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {"flash_attention": _fa.launches,
            "group_average_combine": _ga.launches,
            "group_average_combine_multi": _ga.multi_launches,
            "rglru_scan": _rg.launches,
            "rglru_scan_tma": _rg.route_launches["tma"],
            "rglru_scan_walk": _rg.route_launches["walk"]}


def reset_launch_counts() -> None:
    _fa.launches = 0
    _rg.launches = 0
    _rg.route_launches.update(tma=0, walk=0)
    _ga.launches = 0
    _ga.multi_launches = 0
