"""Butterfly combine ``out = (w + recv) * inv_s``: the Hopper kernels K1/K2
and their plain versions.

The arithmetic half of a WAGMA butterfly stage (paper Alg. 2 line 11):
after the exchange delivers the partner's weights, each replica combines
its buffer with the received one, in fp32, written back in the storage
dtype.

``group_average_combine_cuda`` launches ``csrc/group_average.cu``'s single
pair kernel, the replacement of ``repro/kernels/group_average.py::
group_average_combine`` (K1); ``group_average_combine_multi_cuda`` its table
kernel, the replacement of ``group_average_combine_multi`` (K2): one launch
for a list of ragged same-dtype pairs with one shared ``inv_s`` and no
joining copy (see the source's note for the design and what bounds it).
The ``_plain`` versions compute the same function in torch; every result
of the kernels is bit-identical to them.  ``out`` may be ``w`` itself: the
averaging plan never reads an accumulator after its combine.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# Launches of each CUDA kernel since the last reset (kernels/ops.py reads them).
launches = 0
multi_launches = 0


def group_average_combine_plain(w, recv, inv_s: float, *, out=None):
    """((w + recv) in fp32 * inv_s) cast back to w's dtype; any shape."""
    res = ((w.float() + recv.float()) * inv_s).to(w.dtype)
    if out is None:
        return res
    return out.copy_(res)


def group_average_combine_multi_plain(ws, rs, inv_s: float, *, outs=None):
    """K1's plain version on each pair."""
    outs = outs or [None] * len(ws)
    return [group_average_combine_plain(w, r, inv_s, out=o)
            for w, r, o in zip(ws, rs, outs)]


def _check_pair(w, r, out, who: str):
    if not (w.is_cuda and r.device == w.device and out.device == w.device):
        raise ValueError(f"{who}: tensors must be on one CUDA device")
    if w.dtype not in _DTYPE_CODE or r.dtype != w.dtype or out.dtype != w.dtype:
        raise ValueError(f"{who}: dtypes {w.dtype}/{r.dtype}/{out.dtype}; "
                         f"need one of float32, bfloat16")
    if r.numel() != w.numel() or out.numel() != w.numel():
        raise ValueError(f"{who}: sizes {w.numel()}/{r.numel()}/{out.numel()}")
    if not (w.is_contiguous() and r.is_contiguous() and out.is_contiguous()):
        raise ValueError(f"{who}: tensors must be contiguous")


def _lib():
    lib = _build.load("group_average")
    if lib.repro_group_average_combine.argtypes is None:
        lib.repro_group_average_combine.restype = ctypes.c_int
        lib.repro_group_average_combine.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_float,
                                     ctypes.c_int, ctypes.c_void_p])
        lib.repro_group_average_combine_multi.restype = ctypes.c_int
        lib.repro_group_average_combine_multi.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_float,
                                     ctypes.c_int, ctypes.c_void_p])
        lib.repro_group_average_max_pairs.restype = ctypes.c_int
        lib.repro_group_average_max_pairs.argtypes = []
    return lib


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def group_average_combine_cuda(w, recv, inv_s: float, *, out=None):
    """Launch K1 on w's current stream; an empty input returns ``w``.
    Raises on any input it does not take and on a failed launch."""
    global launches
    if out is None:
        out = torch.empty_like(w)
    _check_pair(w, recv, out, "group_average_combine_cuda")
    if w.numel() == 0:
        return w
    lib = _lib()
    with torch.cuda.device(w.device):
        err = lib.repro_group_average_combine(
            w.data_ptr(), recv.data_ptr(), out.data_ptr(), w.numel(),
            float(inv_s), _DTYPE_CODE[w.dtype], _stream(w.device))
    if err != 0:
        raise RuntimeError(f"group_average_combine kernel launch failed: CUDA "
                           f"error {err} at n={w.numel()} {w.dtype}")
    launches += 1
    return out


def group_average_combine_multi_cuda(ws: Sequence, rs: Sequence, inv_s: float,
                                     *, outs: Optional[Sequence] = None
                                     ) -> List[torch.Tensor]:
    """Launch K2 over the non-empty pairs (one launch per table of up to
    ``repro_group_average_max_pairs()`` pairs); empty pairs return ``w``."""
    global multi_launches
    outs = list(outs) if outs is not None else [torch.empty_like(w) for w in ws]
    for w, r, o in zip(ws, rs, outs):
        _check_pair(w, r, o, "group_average_combine_multi_cuda")
    live = [i for i, w in enumerate(ws) if w.numel()]
    dtype, device = ws[0].dtype, ws[0].device
    if any(w.device != device or w.dtype != dtype for w in ws):
        raise ValueError("group_average_combine_multi_cuda: pairs of "
                         "different devices or dtypes")
    lib = _lib()
    cap = lib.repro_group_average_max_pairs()
    for start in range(0, len(live), cap):
        idx = live[start:start + cap]
        ptrs = lambda ts: (ctypes.c_void_p * len(idx))(
            *(ts[i].data_ptr() for i in idx))
        ns = (ctypes.c_longlong * len(idx))(*(ws[i].numel() for i in idx))
        with torch.cuda.device(device):
            err = lib.repro_group_average_combine_multi(
                ptrs(ws), ptrs(rs), ptrs(outs), ns, len(idx), float(inv_s),
                _DTYPE_CODE[dtype], _stream(device))
        if err != 0:
            raise RuntimeError(
                f"group_average_combine_multi kernel launch failed: CUDA error "
                f"{err} at {len(idx)} pairs {[ws[i].numel() for i in idx]} "
                f"{dtype}")
        multi_launches += 1
    return [outs[i] if ws[i].numel() else ws[i] for i in range(len(ws))]
