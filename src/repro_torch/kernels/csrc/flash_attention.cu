// Flash attention forward for Hopper (sm_90a): blockwise online softmax.
//
// Replaces repro/kernels/flash_attention.py::_attn_kernel (the Pallas TPU
// kernel behind repro.kernels.ops.flash_attention).  Same function: causal
// and sliding-window masks, GQA with query head h reading KV head
// h / (H / KH) (no repeat materialised), fp32 running max m, denominator l
// and accumulator acc, P rounded to the input type before the PV product
// (as the Pallas kernel rounds p to v's dtype), output = acc / max(l, 1e-30)
// cast to the input type, so a row that sees no key gives 0.
//
// Layouts are the JAX package's: q/o (B, Sq, H, hd), k/v (B, Sk, KH, hd),
// contiguous.  f32 and bf16 inputs; hd a multiple of 16 up to 128, or 256.
//
// Translation from the TPU kernel.  There the K dimension is the innermost,
// sequential grid axis and m/l/acc persist in VMEM scratch across grid steps.
// Blocks on the GPU run in no order, so one block owns a tile of query rows
// of one (batch, head) and walks the KV tiles in a loop, with m/l/acc in
// registers.  Causal masking stops the loop at the diagonal tile; a window
// starts it at the first tile the window reaches.  Ragged Sq/Sk edges are
// handled in the kernel, so the wrapper pads nothing.  A masked score
// contributes an exact 0.
//
// What bounds it on the H100.  At the serving shapes (tinyllama prefill,
// H = 32, hd = 64, L up to 2k; recurrentgemma, hd = 256, window 2048)
// attention does ~L/2 operations per byte of q/k/v/o, so the bf16
// tensor-core rate (989 TFLOP/s), not the 3.35 TB/s of HBM, is the bound.
// Two kernels:
//
// * bf16 (the serving paths): attn_fwd_wgmma, built the Hopper way, for
//   every head dim: the template's width HD is the head dim padded to 64,
//   128 or 256, and the TMA's out-of-bounds zero fill supplies the padding
//   columns (they add 0 to every score and are never stored).
//   - A block is three warpgroups: two consumers, each owning 64 query
//     rows (128 a block), and one producer.  One producer thread loads the
//     block's Q tile once, then K and V tiles into a ring of shared-memory
//     stages (4 at HD 64, 2 above) with TMA: cp.async.bulk.tensor over 4-D
//     maps (hd, heads, S, B), so one map per tensor covers every (batch,
//     head), and the out-of-bounds zero fill also takes the ragged Sq and
//     Sk edges.  K and V of a stage each have a full and an empty
//     mbarrier, so a K slot is refilled as soon as its S product is done.
//     Tiles are 64-column boxes with the 128-byte swizzle (a box's inner
//     dimension is at most 64 bf16 values, so HD 256 is four boxes).
//   - The consumers run both products on wgmma.  S = Q K^T reads Q and K
//     from shared memory (both K-major).  O += P V takes P from the S
//     accumulator, rounded to bf16 (for m64nNk16 the accumulator layout of
//     two adjacent 8-key column tiles is the A-fragment layout), and reads
//     V in place as a transposed (MN-major) operand, so V is never
//     transposed by hand.  Tile i's S product is issued before tile i-1's
//     PV product and waited for alone, so tile i's softmax runs while the
//     tensor cores do tile i-1's PV.  setmaxnreg moves registers from the
//     producer (24) to the consumers (240): at HD 256 the O accumulator
//     alone is 128 fp32 registers a thread, with S (32) and P (16) beside
//     it.
//   - The softmax runs in base 2, scale * log2(e) folded into one FMA
//     before exp2f; the mask is applied only on tiles that cross the
//     diagonal, the window's edge or the end of Sk.
//   - Blocks are launched heaviest query tile first, so the long causal
//     rows do not form the tail.  Rows are written with plain stores,
//     masked at Sq.  Shared memory: HD 256 is Q 64 KB + 2 stages x (K 32
//     KB + V 32 KB) = 192 KB; HD 64 is Q 16 KB + 4 x 32 KB.
//   What bounds it now: at (4, 3000, 10, 1, 256) window 2048 it reaches
//   about half the bf16 tensor-core peak; the rest goes to the softmax
//   (exp2 and the max and sum shuffles, not hidden behind the products of
//   the other warpgroup), the waits of each warpgroup on its own products,
//   and the masked edge tiles.  At tinyllama's L = 1024 the grid is 256
//   blocks of at most 8 tiles, so filling the card and the serial
//   prologue of each block dominate.
// * float32: scalar fp32 FMAs (tensor cores would round to TF32).  SPLIT
//   threads share a query row, each owning every SPLIT-th 16-byte vector of
//   hd, so the threads of a row read neighbouring vectors of a shared-memory
//   K/V row (no bank conflict) and the parts of a dot product meet by
//   shuffles.  At hd 256 a row is split over 4 threads, 32 rows a block,
//   and a K/V tile holds 16 keys so that the static 32 KB of sk/sv stays
//   under 48 KB.
//
// The TMA tensor maps are encoded on the host at each launch
// (cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint so the
// library links nothing beyond the CUDA runtime) and passed as
// __grid_constant__ parameters.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cmath>
#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int THREADS = 128;  // 4 warps (f32 kernel)
constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// float32: scalar FMAs
// ---------------------------------------------------------------------------

template <int HD>
struct F32Tile {
  static constexpr int SPLIT = HD > 128 ? 4 : 2;      // threads per query row
  static constexpr int BQ = THREADS / SPLIT;          // query rows per block
  static constexpr int BK = HD > 128 ? 16 : 32;       // keys per shared tile
};

template <int HD>
__global__ void __launch_bounds__(THREADS)
attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int Sq,
             int Sk, int H, int KH, float scale, int causal, int window) {
  constexpr int SPLIT = F32Tile<HD>::SPLIT;
  constexpr int BQ = F32Tile<HD>::BQ;
  constexpr int BK = F32Tile<HD>::BK;
  constexpr int PART = HD / SPLIT;  // dims of q and acc a thread owns
  constexpr int NV = PART / 4;      // its 16-byte vectors: SPLIT*i + part
  __shared__ __align__(16) float sk[BK][HD];
  __shared__ __align__(16) float sv[BK][HD];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kh = h / (H / KH);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int row = tid / SPLIT;
  const int part = tid % SPLIT;
  const int qi = q0 + row;
  const bool q_valid = qi < Sq;

  float qr[PART];
  float acc[PART];
  {
    const float4* qp = reinterpret_cast<const float4*>(
        q + ((static_cast<size_t>(b) * Sq + (q_valid ? qi : 0)) * H + h) * HD);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const float4 qq = q_valid ? qp[SPLIT * i + part] : make_float4(0.f, 0.f, 0.f, 0.f);
      qr[4 * i + 0] = qq.x;
      qr[4 * i + 1] = qq.y;
      qr[4 * i + 2] = qq.z;
      qr[4 * i + 3] = qq.w;
    }
#pragma unroll
    for (int d = 0; d < PART; ++d) acc[d] = 0.f;
  }
  float m = NEG_INF;
  float l = 0.f;

  // KV range this block of query rows can see (uniform over the block).
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin -= k_begin % BK;

  const size_t row_stride = static_cast<size_t>(KH) * HD;
  const float* kb = k + static_cast<size_t>(b) * Sk * row_stride + static_cast<size_t>(kh) * HD;
  const float* vb = v + static_cast<size_t>(b) * Sk * row_stride + static_cast<size_t>(kh) * HD;

  for (int kt = k_begin; kt < k_end; kt += BK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = tid; idx < BK * HD; idx += THREADS) {
      const int r = idx / HD;
      const int c = idx - r * HD;
      const int kr = kt + r;
      const bool in = kr < Sk;
      sk[r][c] = in ? kb[kr * row_stride + c] : 0.f;
      sv[r][c] = in ? vb[kr * row_stride + c] : 0.f;
    }
    __syncthreads();

    float s[BK];
    unsigned ok_bits = 0u;
    float tile_max = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float4* kr4 = reinterpret_cast<const float4*>(&sk[j][0]);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float4 kk = kr4[SPLIT * i + part];
        dot = fmaf(qr[4 * i + 0], kk.x, dot);
        dot = fmaf(qr[4 * i + 1], kk.y, dot);
        dot = fmaf(qr[4 * i + 2], kk.z, dot);
        dot = fmaf(qr[4 * i + 3], kk.w, dot);
      }
      // the row's SPLIT lanes are adjacent; every lane ends with one sum
#pragma unroll
      for (int off = 1; off < SPLIT; off <<= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      const int kp = kt + j;
      bool ok = kp < Sk;
      if (causal) ok = ok && kp <= qi;
      if (window > 0) ok = ok && kp > qi - window;
      s[j] = ok ? dot * scale : NEG_INF;
      ok_bits |= ok ? (1u << j) : 0u;
      tile_max = fmaxf(tile_max, s[j]);
    }

    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] = ((ok_bits >> j) & 1u) ? expf(s[j] - m_new) : 0.f;
      psum += s[j];
    }
    l = l * corr + psum;
#pragma unroll
    for (int d = 0; d < PART; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float4* vr4 = reinterpret_cast<const float4*>(&sv[j][0]);
      const float p = s[j];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float4 vv = vr4[SPLIT * i + part];
        acc[4 * i + 0] = fmaf(p, vv.x, acc[4 * i + 0]);
        acc[4 * i + 1] = fmaf(p, vv.y, acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(p, vv.z, acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(p, vv.w, acc[4 * i + 3]);
      }
    }
    m = m_new;
  }

  if (q_valid) {
    const float denom = fmaxf(l, 1e-30f);
    float4* op = reinterpret_cast<float4*>(
        o + ((static_cast<size_t>(b) * Sq + qi) * H + h) * HD);
#pragma unroll
    for (int i = 0; i < NV; ++i)
      op[SPLIT * i + part] = make_float4(acc[4 * i + 0] / denom, acc[4 * i + 1] / denom,
                                         acc[4 * i + 2] / denom, acc[4 * i + 3] / denom);
  }
}

// ---------------------------------------------------------------------------
// bf16: TMA ring + wgmma, warp-specialised
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// HD is the head dim padded to a multiple of 64 (64, 128 or 256); the
// TMA's out-of-bounds fill zeroes the columns past the real head dim.
template <int HD>
struct WgTile {
  static constexpr int NWG = 2;                    // consumer warpgroups
  static constexpr int THREADS = 128 * (NWG + 1);  // and one producer warpgroup
  static constexpr int BQ = 64 * NWG;              // query rows per block
  static constexpr int BK = HD > 128 ? 64 : 128;   // keys per stage
  static constexpr int STAGES = HD > 64 ? 2 : 4;
  static constexpr int BOXES = HD / 64;            // 64-column (128-byte) boxes
  static constexpr uint32_t Q_BYTES = BQ * HD * 2;
  static constexpr uint32_t KV_BYTES = BK * HD * 2;  // K or V of one stage
  static constexpr uint32_t BAR_OFF = Q_BYTES + STAGES * 2 * KV_BYTES;
  // + 1 KB to align the tiles to the 1024-byte period of the swizzle;
  // barriers: full and empty of K and of V for each stage, and Q's
  static constexpr size_t SMEM = 1024 + BAR_OFF + 8 * (4 * STAGES + 1);
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (each >> 4), layout type 1.
// K-major (Q, K): rows 128 bytes apart, 8-row groups at sbo = 1024, lbo
// unused; a 16-deep step advances the start by 32 bytes inside the row.
// MN-major (V read as the transposed B): 8-key groups at sbo = 1024, the
// next 64-column box at lbo.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32 | static_cast<uint64_t>(1) << 62;
}

// wgmma.mma_async m64nNk16, bf16 in, fp32 accumulators d (N/2 a thread):
// ss() with A and B from shared memory, both K-major; rs() with A from
// registers (the mma.sync m16n8k16 A-fragment layout, per warp) and B
// MN-major (transposed).  scale_d = 0 overwrites d.
#define WG_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                 "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "l"(da), "l"(db), "r"(scale_d));
  }
  __device__ __forceinline__ static void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void ss(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56)
      : "l"(da), "l"(db), "r"(scale_d));
  }
  __device__ __forceinline__ static void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<256> {
  __device__ __forceinline__ static void rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db, int scale_d) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56), WG_D8(64), WG_D8(72), WG_D8(80), WG_D8(88), WG_D8(96), WG_D8(104), WG_D8(112), WG_D8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

#undef WG_D8

// One tile's online-softmax step for a thread's two rows r0 and r0 + 8
// (BK / 2 scores in the wgmma accumulator layout): the mask, only on a
// tile that crosses the diagonal, the window's edge or the end of Sk; the
// new row maxima m of the raw scores; p = 2^(s * scale * log2 e - m) in
// place of the scores; the sums l; and in c the factors by which the
// earlier output rows are to be scaled.  A row that has seen no key yet
// keeps max -inf, so its offset is 0 and its p and c are exactly 0.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sacc)[BK / 2], int kt, int Sk, int r0,
                                             int c2, int row_lo, int row_hi, int causal,
                                             int window, float scale_log2, float (&m)[2],
                                             float (&l)[2], float (&c)[2]) {
  if (kt + BK > Sk || (causal && kt + BK - 1 > row_lo) || (window > 0 && kt <= row_hi - window)) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt + 8 * j + c2 + (e & 1);
        const int row = r0 + (e < 2 ? 0 : 8);
        if (key >= Sk || (causal && key > row) || (window > 0 && key <= row - window))
          sacc[4 * j + e] = -INFINITY;
      }
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(sacc[4 * j], sacc[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
  }
  float ms[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    ms[r] = mx[r] == -INFINITY ? 0.f : mx[r] * scale_log2;
    c[r] = exp2f(m[r] * scale_log2 - ms[r]);
    m[r] = mx[r];
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sacc[4 * j + e] = exp2f(fmaf(sacc[4 * j + e], scale_log2, -ms[e / 2]));
      sum[e / 2] += sacc[4 * j + e];
    }
  }
  l[0] = l[0] * c[0] + sum[0];
  l[1] = l[1] * c[1] + sum[1];
}

template <int HD>
__global__ void __launch_bounds__(WgTile<HD>::THREADS, 1)
attn_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               __nv_bfloat16* __restrict__ o, int BH, int Sq, int Sk, int H,
               int KH, int hd, float scale_log2, int causal, int window,
               int n_qt) {
  using T = WgTile<HD>;
  constexpr int BQ = T::BQ;
  constexpr int BK = T::BK;
  constexpr int STAGES = T::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;  // box c at c * BQ * 128
  const uint32_t sKV = sQ + T::Q_BYTES;   // stage s: K at 2 s KV_BYTES, V after it
  // Barriers of stage s: K full at 8 s, V full at 8 (STAGES + s), K empty
  // at 8 (2 STAGES + s), V empty at 8 (3 STAGES + s); then Q's.
  const uint32_t bar = sQ + T::BAR_OFF;
  const uint32_t q_bar = bar + 32 * STAGES;
  auto k_full = [&](int s) { return bar + 8 * s; };
  auto v_full = [&](int s) { return bar + 8 * (STAGES + s); };
  auto k_empty = [&](int s) { return bar + 8 * (2 * STAGES + s); };
  auto v_empty = [&](int s) { return bar + 8 * (3 * STAGES + s); };

  // Heaviest query tiles first: block i takes tile n_qt - 1 - i / BH.
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / BH) * BQ;
  const int b = bh / H;
  const int h = bh % H;
  const int kh = h / (H / KH);
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin -= k_begin % BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);                // the producer's expect_tx
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 4 * T::NWG);      // every consumer warp
      mbar_init(v_empty(s), 4 * T::NWG);
    }
    mbar_init(q_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * T::NWG) {
    // Producer warpgroup: one thread keeps the rings full.  A K slot frees
    // when S = Q K^T of its tile is done, a V slot when O += P V is.
    regs_dec<24>();
    if (threadIdx.x == 128 * T::NWG && n_tiles > 0) {
      mbar_expect_tx(q_bar, T::Q_BYTES);
#pragma unroll
      for (int c = 0; c < T::BOXES; ++c)
        tma_load(sQ + c * BQ * 128, &tm_q, q_bar, 64 * c, h, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        const uint32_t free_parity = ((i / STAGES) & 1) ^ 1;
        const uint32_t sk = sKV + 2 * s * T::KV_BYTES;
        const int kt = k_begin + i * BK;
        mbar_wait(k_empty(s), free_parity);
        mbar_expect_tx(k_full(s), T::KV_BYTES);
#pragma unroll
        for (int c = 0; c < T::BOXES; ++c)
          tma_load(sk + c * BK * 128, &tm_k, k_full(s), 64 * c, kh, kt, b);
        mbar_wait(v_empty(s), free_parity);
        mbar_expect_tx(v_full(s), T::KV_BYTES);
#pragma unroll
        for (int c = 0; c < T::BOXES; ++c)
          tma_load(sk + T::KV_BYTES + c * BK * 128, &tm_v, v_full(s), 64 * c, kh, kt, b);
      }
    }
  } else {
    // Consumer warpgroup wg: query rows q0 + 64 wg .. + 63.  Tile i's
    // S = Q K^T is issued before tile i-1's O += P V, so the softmax of
    // tile i runs while the tensor cores do the PV product.
    regs_inc<240>();
    const int wg = threadIdx.x / 128;
    const int lane = threadIdx.x % 32;
    const int row_lo = q0 + 64 * wg;
    const int row_hi = row_lo + 63;
    const int r0 = row_lo + 16 * ((threadIdx.x / 32) % 4) + lane / 4;  // rows r0, r0 + 8
    const int c2 = 2 * (lane % 4);                 // its columns in an 8-wide tile
    const uint32_t sq = sQ + 64 * 128 * wg;

    float oacc[HD / 2];
    float sacc[BK / 2];
    uint32_t pa[BK / 16][4];  // P of the previous tile, bf16 A fragments
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) oacc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running row maxima of raw scores
    float l[2] = {0.f, 0.f};              // this thread's share of the sums
    float c[2];

    // S = Q K^T over HD / 16 steps of 16, Q and K both K-major.
    auto issue_qk = [&](int s) {
      const uint32_t sk = sKV + 2 * s * T::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;  // bytes into the 128-byte row
        Wgmma<BK>::ss(sacc, sw128_desc(sq + (kk / 4) * BQ * 128 + col, 16, 1024),
                      sw128_desc(sk + (kk / 4) * BK * 128 + col, 16, 1024), kk > 0);
      }
      wgmma_commit();
    };
    // O += P V, V the MN-major (transposed) B.
    auto issue_pv = [&](int s) {
      const uint32_t sv = sKV + 2 * s * T::KV_BYTES + T::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Wgmma<HD>::rs(oacc, pa[kk], sw128_desc(sv + kk * 16 * 128, BK * 128, 1024), 1);
      wgmma_commit();
    };
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        pa[kk][0] = pack_bf16(sacc[8 * kk], sacc[8 * kk + 1]);
        pa[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
        pa[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
        pa[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
      }
    };
    // This warp is done with a slot.
    auto release = [&](uint32_t empty) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty);
    };

    if (n_tiles > 0) {
      mbar_wait(q_bar, 0);
      mbar_wait(k_full(0), 0);
      wgmma_fence();
      issue_qk(0);
      wgmma_wait<0>();
      fence_regs(sacc);
      release(k_empty(0));
      softmax_tile<BK>(sacc, k_begin, Sk, r0, c2, row_lo, row_hi, causal, window, scale_log2,
                       m, l, c);
      pack_p();
      for (int i = 1; i < n_tiles; ++i) {
        const int s = i % STAGES;
        const int sp = (i - 1) % STAGES;
        mbar_wait(k_full(s), (i / STAGES) & 1);
        fence_regs(oacc);
        wgmma_fence();
        issue_qk(s);
        mbar_wait(v_full(sp), ((i - 1) / STAGES) & 1);
        issue_pv(sp);
        wgmma_wait<1>();  // S of tile i is in; P V of tile i-1 may run on
        fence_regs(sacc);
        release(k_empty(s));
        softmax_tile<BK>(sacc, k_begin + i * BK, Sk, r0, c2, row_lo, row_hi, causal, window,
                         scale_log2, m, l, c);
        wgmma_wait<0>();
        fence_regs(oacc);
        release(v_empty(sp));
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          oacc[4 * n] *= c[0];
          oacc[4 * n + 1] *= c[0];
          oacc[4 * n + 2] *= c[1];
          oacc[4 * n + 3] *= c[1];
        }
        pack_p();
      }
      const int s = (n_tiles - 1) % STAGES;
      mbar_wait(v_full(s), ((n_tiles - 1) / STAGES) & 1);
      fence_regs(oacc);
      wgmma_fence();
      issue_pv(s);
      wgmma_wait<0>();
      fence_regs(oacc);
      release(v_empty(s));
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = fmaxf(l[r], 1e-30f);
    }
    const size_t os = static_cast<size_t>(H) * hd;
    __nv_bfloat16* ob = o + static_cast<size_t>(b) * Sq * os + static_cast<size_t>(h) * hd + c2;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      if (8 * n >= hd) continue;  // padding columns
      if (r0 < Sq)
        *reinterpret_cast<uint32_t*>(ob + r0 * os + 8 * n) =
            pack_bf16(oacc[4 * n] / l[0], oacc[4 * n + 1] / l[0]);
      if (r0 + 8 < Sq)
        *reinterpret_cast<uint32_t*>(ob + (r0 + 8) * os + 8 * n) =
            pack_bf16(oacc[4 * n + 2] / l[1], oacc[4 * n + 3] / l[1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// A bf16 (B, S, heads, hd) tensor as the 4-D map (hd, heads, S, B) whose
// box is 64 columns of `rows` rows of one (batch, head), 128-byte swizzled.
bool make_map(CUtensorMap* map, const void* ptr, int batch, int seq, int heads, int hd,
              int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {row, row * heads, row * heads * seq};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                         int Sq, int Sk, int H, int KH, int hd, float scale, int causal,
                         int window, cudaStream_t stream) {
  using T = WgTile<HD>;
  static std::atomic<uint64_t> opted{0};
  cudaError_t err = allow_smem(attn_fwd_wgmma<HD>, T::SMEM, opted);
  if (err != cudaSuccess) return err;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map(&tm_q, q, B, Sq, H, hd, T::BQ) || !make_map(&tm_k, k, B, Sk, KH, hd, T::BK) ||
      !make_map(&tm_v, v, B, Sk, KH, hd, T::BK))
    return cudaErrorInvalidValue;
  const int n_qt = (Sq + T::BQ - 1) / T::BQ;
  const long long blocks = static_cast<long long>(n_qt) * B * H;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  attn_fwd_wgmma<HD><<<static_cast<unsigned>(blocks), T::THREADS, T::SMEM, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), B * H, Sq, Sk, H, KH, hd,
      scale * 1.4426950408889634f, causal, window, n_qt);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B,
                       int Sq, int Sk, int H, int KH, float scale, int causal,
                       int window, cudaStream_t stream) {
  constexpr int BQ = F32Tile<HD>::BQ;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  attn_fwd_f32<HD><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, H, KH,
      scale, causal, window);
  return cudaGetLastError();
}

}  // namespace

// C entry for ctypes.  dtype: 0 = float32, 1 = bfloat16 (pointers 16-byte
// aligned).  window <= 0 means no window.  Returns cudaGetLastError() after
// the launch (0 on success); the kernel runs asynchronously on `stream`.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k,
                                         const void* v, void* o, int B, int Sq,
                                         int Sk, int H, int KH, int hd,
                                         float scale, int causal, int window,
                                         int dtype, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KH < 1 || H % KH != 0 || B * H > 65535 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    if (hd < 16 || hd % 16 != 0 || (hd > 128 && hd != 256))
      return static_cast<int>(cudaErrorInvalidValue);
    if (hd <= 64)
      return static_cast<int>(launch_wgmma<64>(q, k, v, o, B, Sq, Sk, H, KH, hd, scale, causal, window, s));
    if (hd <= 128)
      return static_cast<int>(launch_wgmma<128>(q, k, v, o, B, Sq, Sk, H, KH, hd, scale, causal, window, s));
    return static_cast<int>(launch_wgmma<256>(q, k, v, o, B, Sq, Sk, H, KH, hd, scale, causal, window, s));
  }
  switch (hd) {
#define REPRO_HD_CASE(N) \
  case N:                \
    return static_cast<int>(launch_f32<N>(q, k, v, o, B, Sq, Sk, H, KH, scale, causal, window, s));
    REPRO_HD_CASE(16)
    REPRO_HD_CASE(32)
    REPRO_HD_CASE(48)
    REPRO_HD_CASE(64)
    REPRO_HD_CASE(80)
    REPRO_HD_CASE(96)
    REPRO_HD_CASE(112)
    REPRO_HD_CASE(128)
    REPRO_HD_CASE(256)
#undef REPRO_HD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
