// RG-LRU linear recurrence for Hopper (sm_90a): h_t = a_t * h_{t-1} + x_t.
//
// Replaces repro/kernels/rglru_scan.py::rglru_scan (the Pallas TPU kernel
// _rglru_kernel behind repro.kernels.ops.rglru_scan).  Same function: a and
// x (B, S, W) contiguous, each float32 or bfloat16, widened to fp32; the
// carry h is fp32, starts at h0 (B, W) fp32 or at 0; every h_t is written in
// x's type (bfloat16 rounded to nearest even, as .to() does).  The step is
// __fadd_rn(__fmul_rn(a, h), x): no FMA contraction, so every result is
// bit-identical to the plain torch loop, which runs the multiply and the
// add as two kernels.
//
// Translation from the TPU kernel.  There the grid is (batch tile, channel
// tile, time block) with time innermost and sequential, the carry held in
// VMEM scratch between time blocks, and the wrapper pads B, S and W to the
// block sizes.  Blocks on the GPU run in no order, so one thread owns one
// (batch, channel) pair and walks all of time in a loop with h in a
// register.  Adjacent threads take adjacent channels, so each time step's
// loads of a_t and x_t and the store of h_t are coalesced 128-byte lines per
// warp.  Ragged W and S are masked in the kernel; nothing is padded.
//
// What bounds it on the H100.  It does 2 flops per element against 8-12
// bytes (a, x read once, h written once), so the least time is bytes over
// HBM (3.35 TB/s): 0.110 ms at the serving slice's prefill shape (4, 3000,
// 2560) in fp32.  But it has only B*W threads (10,240 there, ~2.4 warps per
// SM) for a sequential walk, so it is bound by memory latency, not by
// bandwidth.  The design hides what it can with instruction-level
// parallelism: the time loop is unrolled by kUnroll, all loads of a chunk
// are issued before the chain of dependent steps that consumes them, and
// each block is one warp so the warps spread over every SM.  A chunked
// two-pass scan (more threads per channel) is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 32;   // one warp per block: spread over all SMs
constexpr int kUnroll = 16;    // time steps whose loads are in flight at once

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename TA, typename TX>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const TA* __restrict__ a, const TX* __restrict__ x,
                  const float* __restrict__ h0, TX* __restrict__ out, int S,
                  int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const int b = blockIdx.y;
  const size_t base = static_cast<size_t>(b) * S * W + w;
  float h = h0 != nullptr ? h0[static_cast<size_t>(b) * W + w] : 0.f;
  for (int t0 = 0; t0 < S; t0 += kUnroll) {
    float av[kUnroll];
    float xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      const size_t i = base + static_cast<size_t>(t) * W;
      av[u] = t < S ? widen(a[i]) : 0.f;
      xv[u] = t < S ? widen(x[i]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      h = __fadd_rn(__fmul_rn(av[u], h), xv[u]);
      if (t < S) put(out + base + static_cast<size_t>(t) * W, h);
    }
  }
}

template <typename TA, typename TX>
cudaError_t launch(const void* a, const void* x, const void* h0, void* out,
                   int B, int S, int W, cudaStream_t stream) {
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<TA, TX><<<grid, kThreads, 0, stream>>>(
      static_cast<const TA*>(a), static_cast<const TX*>(x),
      static_cast<const float*>(h0), static_cast<TX*>(out), S, W);
  return cudaGetLastError();
}

}  // namespace

// C entry for ctypes.  a_dtype, x_dtype: 0 = float32, 1 = bfloat16; out has
// x's type; h0 is float32 or null.  Returns cudaGetLastError() after the
// launch (0 on success); the kernel runs asynchronously on `stream`.
extern "C" int repro_rglru_scan(const void* a, const void* x, const void* h0,
                                void* out, int B, int S, int W, int a_dtype,
                                int x_dtype, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || W < 1 || (a_dtype != 0 && a_dtype != 1) ||
      (x_dtype != 0 && x_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (a_dtype == 0 && x_dtype == 0)
    err = launch<float, float>(a, x, h0, out, B, S, W, s);
  else if (a_dtype == 0)
    err = launch<float, __nv_bfloat16>(a, x, h0, out, B, S, W, s);
  else if (x_dtype == 0)
    err = launch<__nv_bfloat16, float>(a, x, h0, out, B, S, W, s);
  else
    err = launch<__nv_bfloat16, __nv_bfloat16>(a, x, h0, out, B, S, W, s);
  return static_cast<int>(err);
}
