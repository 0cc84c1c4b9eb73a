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
// (batch, channel) pair and walks all of time in order with h in a
// register: the recurrence is never reassociated.  Ragged W and S are
// masked in the kernel; nothing is padded.
//
// What bounds it on the H100.  It does 2 flops per element against 8-12
// bytes (a, x read once, h written once), so the least time is bytes over
// HBM (3.35 TB/s): 0.110 ms at the serving slice's prefill shape (4, 3000,
// 2560) in fp32.  The walk itself is short: a step is a multiply and an
// add (~8 cycles), 3000 steps ~13 us, against the ~66 cycles a step that
// the byte bound leaves each channel.  So the kernel is bound by how many
// bytes it keeps in flight, not by the dependent chain.  There are only
// B*W channels (10,240 at the prefill shape, ~2.4 warps per SM), so each
// warp has to keep far more than one step's loads in flight.  Two routes,
// chosen by the wrapper (rglru_scan.py::route) and passed in; the entry
// refuses a TMA request on a shape it cannot take, and nothing retries on
// the other route.
//
// * TMA route (S >= kT, W * itemsize a multiple of 16 for a and x, a, x
//   and out 16-byte aligned; the prefill): a block owns kC = 64 channels
//   of one batch row and runs two roles.  One elected thread of a producer
//   warp issues TMA loads (cp.async.bulk.tensor over 3-D maps (W, S, B),
//   box (kC, kT, 1): 256-byte rows in fp32, 128-byte in bf16) of a and x
//   into a ring of kStages slots guarded by full and empty mbarriers, so
//   kStages * kT steps of every channel are in flight at once (5 MB
//   card-wide at the prefill shape, against ~3 MB that Little's law asks
//   for at 3.35 TB/s).  Two consumer warps, one thread a channel, each walk
//   one column of a slot from shared memory (consecutive threads on
//   consecutive words: no bank conflict) and write h_t with coalesced
//   stores, one 128-byte line per warp a step.  The TMA zero-fills a box
//   past S and W; those steps and channels are never stored.  Tuned on the
//   card (H100 80GB HBM3 at 700 W): kC 64, kT 32, kStages 2 beat deeper
//   rings and longer slots (more bytes in flight read slower), and the
//   direct stores beat staging h in shared memory for a TMA store.
// * Walk route (everything else: decode's S = 1, where there is nothing to
//   pipeline; W = 1001; a misaligned view): one warp a block, one thread a
//   channel; the loads of kUnroll steps are issued before the chain that
//   consumes them.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 32;   // walk route: one warp per block
constexpr int kUnroll = 16;    // walk route: steps whose loads are in flight

constexpr int kC = 64;         // TMA route: channels per block
constexpr int kT = 32;         // time steps per slot
constexpr int kStages = 2;     // slots in the ring

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ float step(float a, float h, float x) {
  return __fadd_rn(__fmul_rn(a, h), x);
}

// ---------------------------------------------------------------------------
// Walk route
// ---------------------------------------------------------------------------

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
      h = step(av[u], h, xv[u]);
      if (t < S) put(out + base + static_cast<size_t>(t) * W, h);
    }
  }
}

// ---------------------------------------------------------------------------
// TMA route
// ---------------------------------------------------------------------------

// Shared memory: the ring (slot s: a's box, then x's), then the full and
// empty barriers; 128 B to align the base.
template <typename TA, typename TX>
struct TmaTile {
  static constexpr uint32_t A_BYTES = kT * kC * sizeof(TA);
  static constexpr uint32_t SLOT = A_BYTES + kT * kC * sizeof(TX);
  static constexpr uint32_t BAR_OFF = kStages * SLOT;
  static constexpr size_t SMEM = 128 + BAR_OFF + 16 * kStages;
};

template <typename TA, typename TX>
__global__ void __launch_bounds__(kC + 32)
rglru_scan_tma_kernel(const __grid_constant__ CUtensorMap tm_a,
                      const __grid_constant__ CUtensorMap tm_x,
                      const float* __restrict__ h0, TX* __restrict__ out,
                      int S, int W) {
  using L = TmaTile<TA, TX>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 127u) & ~127u) - raw);
  const uint32_t base = smem_u32(smem);
  const uint32_t bar = base + L::BAR_OFF;
  auto full = [&](int s) { return bar + 8 * s; };
  auto empty = [&](int s) { return bar + 8 * (kStages + s); };
  const int w0 = blockIdx.x * kC;
  const int b = blockIdx.y;
  const int n_tiles = (S + kT - 1) / kT;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);             // the producer's expect_tx
      mbar_init(empty(s), kC / 32);      // every consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kC) {
    // Producer warp: one thread keeps the ring full.
    if (threadIdx.x == kC) {
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const uint32_t slot = base + s * L::SLOT;
        mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), L::SLOT);   // whole boxes, zero fill included
        tma_load(slot, &tm_a, full(s), w0, i * kT, b);
        tma_load(slot + L::A_BYTES, &tm_x, full(s), w0, i * kT, b);
      }
    }
    return;
  }

  // Consumer thread c walks channel w0 + c through every slot in order.
  const int c = threadIdx.x;
  const int w = w0 + c;
  const bool live = w < W;
  float h = h0 != nullptr && live ? h0[static_cast<size_t>(b) * W + w] : 0.f;
  TX* o = out + static_cast<size_t>(b) * S * W + w;
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const int t0 = i * kT;
    const TA* sa = reinterpret_cast<const TA*>(smem + s * L::SLOT) + c;
    const TX* sx = reinterpret_cast<const TX*>(smem + s * L::SLOT + L::A_BYTES) + c;
    mbar_wait(full(s), (i / kStages) & 1);
    TX* op = o + static_cast<size_t>(t0) * W;
    if (t0 + kT <= S) {
#pragma unroll
      for (int u = 0; u < kT; ++u) {
        h = step(widen(sa[u * kC]), h, widen(sx[u * kC]));
        if (live) put(op, h);
        op += W;
      }
    } else {
      for (int u = 0; u < S - t0; ++u) {
        h = step(widen(sa[u * kC]), h, widen(sx[u * kC]));
        if (live) put(op, h);
        op += W;
      }
    }
    __syncwarp();
    if ((c & 31) == 0) mbar_arrive(empty(s));
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename T>
constexpr CUtensorMapDataType tma_type() {
  return sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// A (B, S, W) tensor as the 3-D map (W, S, B) whose box is kC channels of
// kT steps of one batch row, unswizzled, zero-filled past the edges.
template <typename T>
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int W) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t row = static_cast<cuuint64_t>(W) * sizeof(T);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {row, row * S};
  const cuuint32_t box[3] = {kC, kT, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, tma_type<T>(), 3, const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename TA, typename TX>
cudaError_t launch_tma(const void* a, const void* x, const void* h0, void* out, int B, int S,
                       int W, cudaStream_t stream) {
  using L = TmaTile<TA, TX>;
  if (S < kT || (static_cast<size_t>(W) * sizeof(TA)) % 16 != 0 ||
      (static_cast<size_t>(W) * sizeof(TX)) % 16 != 0 || !aligned16(a) || !aligned16(x) ||
      !aligned16(out))
    return cudaErrorInvalidValue;
  static std::atomic<uint64_t> opted{0};
  cudaError_t err = allow_smem(rglru_scan_tma_kernel<TA, TX>, L::SMEM, opted);
  if (err != cudaSuccess) return err;
  CUtensorMap tm_a, tm_x;
  if (!make_map<TA>(&tm_a, a, B, S, W) || !make_map<TX>(&tm_x, x, B, S, W))
    return cudaErrorInvalidValue;
  const dim3 grid((W + kC - 1) / kC, B);
  rglru_scan_tma_kernel<TA, TX><<<grid, kC + 32, L::SMEM, stream>>>(
      tm_a, tm_x, static_cast<const float*>(h0), static_cast<TX*>(out), S, W);
  return cudaGetLastError();
}

template <typename TA, typename TX>
cudaError_t launch(const void* a, const void* x, const void* h0, void* out,
                   int B, int S, int W, int route, cudaStream_t stream) {
  if (route == 1) return launch_tma<TA, TX>(a, x, h0, out, B, S, W, stream);
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<TA, TX><<<grid, kThreads, 0, stream>>>(
      static_cast<const TA*>(a), static_cast<const TX*>(x),
      static_cast<const float*>(h0), static_cast<TX*>(out), S, W);
  return cudaGetLastError();
}

}  // namespace

// C entry for ctypes.  a_dtype, x_dtype: 0 = float32, 1 = bfloat16; out has
// x's type; h0 is float32 or null.  route: 0 = walk, 1 = TMA (refused with
// cudaErrorInvalidValue where the TMA route's conditions fail).  Returns
// cudaGetLastError() after the launch (0 on success); the kernel runs
// asynchronously on `stream`.
extern "C" int repro_rglru_scan(const void* a, const void* x, const void* h0,
                                void* out, int B, int S, int W, int a_dtype,
                                int x_dtype, int route, void* stream) {
  if (B < 1 || B > 65535 || S < 1 || W < 1 || (a_dtype != 0 && a_dtype != 1) ||
      (x_dtype != 0 && x_dtype != 1) || (route != 0 && route != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (a_dtype == 0 && x_dtype == 0)
    err = launch<float, float>(a, x, h0, out, B, S, W, route, s);
  else if (a_dtype == 0)
    err = launch<float, __nv_bfloat16>(a, x, h0, out, B, S, W, route, s);
  else if (x_dtype == 0)
    err = launch<__nv_bfloat16, float>(a, x, h0, out, B, S, W, route, s);
  else
    err = launch<__nv_bfloat16, __nv_bfloat16>(a, x, h0, out, B, S, W, route, s);
  return static_cast<int>(err);
}

// The TMA route's time steps per slot: the least S it takes.
extern "C" int repro_rglru_scan_tma_steps() { return kT; }
