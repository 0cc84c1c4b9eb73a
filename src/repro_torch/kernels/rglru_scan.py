"""RG-LRU linear recurrence ``h_t = a_t * h_{t-1} + x_t``: the Hopper kernel
K4 and its plain version.

``rglru_scan_cuda`` launches ``csrc/rglru_scan.cu``, the hand-written
replacement of ``repro/kernels/rglru_scan.py::rglru_scan`` (see the
source's note for the design and what bounds it), on one of two routes
that :func:`route` picks from the shape, the dtypes and the pointers: the
TMA route (a producer warp feeds a shared-memory ring by TMA; the prefill)
or the walk route (one thread walks a channel from global memory; decode's
single step, ragged widths, misaligned views).  ``rglru_scan_plain``
computes the same function in torch, a loop over time with an fp32 carry;
every result of either route is bit-identical to it.

Both take a, x (B,S,W), each float32 or bfloat16, and an optional h0 (B,W)
(the carry before step 0), and return h (B,S,W) in x's dtype.  Channels are
independent; time is sequential.  The kernel carries no gradient:
:func:`rglru_scan_train` differentiates the recurrence with a second scan,
run backwards in time through the same kernel (the JAX package has no
backward kernel, so none is written here).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ROUTE_CODE = {"walk": 0, "tma": 1}

# The TMA route's time steps per shared-memory slot: csrc/rglru_scan.cu's
# kT, which the library reports (repro_rglru_scan_tma_steps).
TMA_STEPS = 32

# Launches of the CUDA kernel since the last reset, in all and by route
# (kernels/ops.py reads them).
launches = 0
route_launches = {"tma": 0, "walk": 0}


def route(s: int, w: int, a_dtype, x_dtype, ptrs) -> str:
    """The kernel's route for a (B, s, w) scan: ``"tma"`` where the TMA
    route takes it (at least ``TMA_STEPS`` steps, rows of a and x a
    multiple of 16 bytes, every pointer in ``ptrs`` -- a, x, out --
    16-byte aligned), else ``"walk"``."""
    rows_ok = all(w * d.itemsize % 16 == 0 for d in (a_dtype, x_dtype))
    if s >= TMA_STEPS and rows_ok and all(p % 16 == 0 for p in ptrs):
        return "tma"
    return "walk"


def rglru_scan_plain(a, x, h0=None):
    """The recurrence as a loop over t in fp32, each h_t cast to x's dtype:
    the oracle ``ref.rglru_scan_ref`` (torch multiplies and adds in separate
    kernels, so nothing is contracted into an FMA)."""
    return ref.rglru_scan_ref(a, x, h0)


def _check(a, x, h0):
    if not (x.is_cuda and a.device == x.device
            and (h0 is None or h0.device == x.device)):
        raise ValueError("rglru_scan_cuda: a, x, h0 must be on one CUDA device")
    if a.dtype not in _DTYPE_CODE or x.dtype not in _DTYPE_CODE:
        raise ValueError(f"rglru_scan_cuda: dtypes {a.dtype}/{x.dtype}; need "
                         f"float32 or bfloat16")
    if x.dim() != 3 or a.shape != x.shape:
        raise ValueError(f"rglru_scan_cuda: shapes {tuple(a.shape)}, "
                         f"{tuple(x.shape)}; need two equal (B,S,W)")
    b, s, w = x.shape
    if min(b, s, w) < 1 or b > 65535:
        raise ValueError(f"rglru_scan_cuda: (B,S,W) = {(b, s, w)}; need each "
                         f">= 1 and B <= 65535")
    if h0 is not None and (h0.dtype != torch.float32 or h0.shape != (b, w)):
        raise ValueError(f"rglru_scan_cuda: h0 {h0.dtype} {tuple(h0.shape)}; "
                         f"need float32 {(b, w)}")
    if not all(t.is_contiguous() for t in (a, x) + ((h0,) if h0 is not None
                                                     else ())):
        raise ValueError("rglru_scan_cuda: inputs must be contiguous")


def _entry():
    lib = _build.load("rglru_scan")
    fn = lib.repro_rglru_scan
    if fn.argtypes is None:
        steps = lib.repro_rglru_scan_tma_steps()
        if steps != TMA_STEPS:
            raise RuntimeError(f"rglru_scan library takes {steps} steps a "
                               f"slot, the route rule {TMA_STEPS}")
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
    return fn


def rglru_scan_cuda(a, x, h0=None, *, via=None):
    """Launch K4 on x's current stream, on route ``via`` (``"tma"`` or
    ``"walk"``; by default the one :func:`route` picks).  Raises on any
    input it does not take, on a TMA request the shape cannot take and on
    a failed launch."""
    global launches
    _check(a, x, h0)
    b, s, w = x.shape
    out = torch.empty_like(x)
    if via is None:
        via = route(s, w, a.dtype, x.dtype,
                    (a.data_ptr(), x.data_ptr(), out.data_ptr()))
    if via not in _ROUTE_CODE:
        raise ValueError(f"rglru_scan_cuda: route {via!r}; need one of "
                         f"{sorted(_ROUTE_CODE)}")
    fn = _entry()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(a.data_ptr(), x.data_ptr(),
                 h0.data_ptr() if h0 is not None else None, out.data_ptr(),
                 b, s, w, _DTYPE_CODE[a.dtype], _DTYPE_CODE[x.dtype],
                 _ROUTE_CODE[via], stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed on the {via} "
                           f"route: CUDA error {err} at {(b, s, w)} a "
                           f"{a.dtype} x {x.dtype}")
    launches += 1
    route_launches[via] += 1
    return out


def reverse_inputs(a, dh):
    """The backward scan's inputs, reversed in time: ``flip(a_next)``, where
    ``a_next[:, t] = a[:, t+1]`` and its last step is 0, and ``flip(dh)``."""
    a_rev = torch.cat([torch.zeros_like(a[:, :1]), a[:, 1:].flip(1)], dim=1)
    return a_rev, dh.flip(1)


class _ScanTrain(torch.autograd.Function):
    """h = scan(a, x, h0) with the gradient of the linear recurrence: the
    total gradient g_t = dh_t + a_{t+1} g_{t+1} is the same recurrence
    backwards in time, ``g = flip(scan(flip(a_next), flip(dh)))``; then
    dx = g, da_t = g_t * h_{t-1} (h_{-1} = h0 or 0), dh0 = a_0 * g_0."""

    @staticmethod
    def forward(ctx, a, x, h0, scan):
        h = scan(a, x, h0)
        ctx.scan = scan
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h, h0 = ctx.saved_tensors
        g = ctx.scan(*reverse_inputs(a, dh)).flip(1)
        da = dh0 = None
        if ctx.needs_input_grad[0]:
            da = torch.empty_like(g)
            torch.mul(g[:, 1:], h[:, :-1], out=da[:, 1:])
            da[:, 0] = g[:, 0] * h0 if h0 is not None else 0.0
            da = da.to(a.dtype)
        if h0 is not None and ctx.needs_input_grad[2]:
            dh0 = (a[:, 0] * g[:, 0]).to(h0.dtype)
        return da, g if ctx.needs_input_grad[1] else None, dh0, None


def rglru_scan_train(a, x, h0=None, *, scan):
    """The recurrence with autograd: forward ``scan(a, x, h0)`` and the
    backward scan through the same ``scan`` (:func:`rglru_scan_cuda` or
    :func:`rglru_scan_plain`, which ``kernels.ops`` picks by device)."""
    return _ScanTrain.apply(a, x, h0, scan)
