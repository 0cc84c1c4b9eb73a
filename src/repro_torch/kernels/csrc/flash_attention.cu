// Flash attention forward for Hopper (sm_90a): blockwise online softmax.
//
// Replaces repro/kernels/flash_attention.py::_attn_kernel (the Pallas TPU
// kernel behind repro.kernels.ops.flash_attention).  Same function: causal
// and sliding-window masks, GQA with query head h reading KV head
// h / (H / KH) (no repeat materialised), fp32 running max m, denominator l
// and accumulator acc, output = acc / max(l, 1e-30) cast to the input type.
//
// Layouts are the JAX package's: q/o (B, Sq, H, hd), k/v (B, Sk, KH, hd),
// contiguous.  f32 and bf16 inputs; hd a multiple of 16 up to 128, or 256.
//
// Translation from the TPU kernel.  There the K dimension is the innermost,
// sequential grid axis and m/l/acc persist in VMEM scratch across grid steps.
// Blocks on the GPU run in no order, so one block owns a tile of query rows
// (64 in bf16; 64 or 32 in f32) of one (batch, head) and walks the KV tiles
// in a loop, with
// m/l/acc in registers.  Causal masking stops the loop at the diagonal tile;
// a window starts it at the first tile the window reaches.  Ragged Sq/Sk
// edges are masked in the kernel, so the wrapper pads nothing.  A masked
// score contributes an exact 0, so a row that sees no key gives 0.
//
// What bounds it on the H100.  At the serving shapes (tinyllama prefill,
// H = 32, hd = 64, L up to 2k) attention does ~L/2 operations per byte of
// q/k/v/o, so from L ~ 600 on the bf16 tensor-core rate (989 TFLOP/s), not
// the 3.35 TB/s of HBM, is the bound.  Two kernels:
//
// * bf16 (the serving path): the products run on the tensor cores with
//   mma.sync m16n8k16 (bf16 in, fp32 accumulate).  Each of the 4 warps owns
//   16 query rows; its S = QK^T tile stays in registers, is turned into P
//   there (the accumulator layout of two adjacent 8-column tiles is the
//   A-operand layout of one 16-deep product), and P is rounded to bf16 for
//   the PV product, as the Pallas kernel rounds p to v's dtype.  K tiles sit
//   in shared memory row-major and V tiles transposed, each row padded by 8
//   elements so that the fragment loads hit 32 distinct banks.  No cp.async
//   pipeline, no TMA, no wgmma yet: loads and products of a tile do not
//   overlap, which is the next step.  Shared memory is dynamic.
// * float32: scalar fp32 FMAs (tensor cores would round to TF32).  SPLIT
//   threads share a query row, each owning every SPLIT-th 16-byte vector of
//   hd, so the threads of a row read neighbouring vectors of a shared-memory
//   K/V row (no bank conflict) and the parts of a dot product meet by
//   shuffles.
//
// Head dim 256 (recurrentgemma-2b: 10 heads, 1 KV head, window 2048).  In
// bf16 the Q fragments (HD/16 x 4 registers) and the output accumulators
// (HD/8 x 4) would take 192 registers before the S tile, so above hd 128
// the block's Q tile waits in shared memory (row-padded like K) and each
// 16-deep chunk's A fragment is read from there once per KV tile; sK, sVt
// and sQ take 104 KB, above the 48 KB static limit, so the kernel opts in to
// the larger dynamic size.  In f32 a row is split over 4 threads (64 floats
// each of q and acc a thread) instead of 2, 32 rows a block, and a K/V tile
// holds 16 keys so that the static 32 KB of sk/sv stays under 48 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int THREADS = 128;  // 4 warps
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
// bf16: tensor cores through mma.sync m16n8k16
// ---------------------------------------------------------------------------

constexpr int BQ_BF16 = 64;   // query rows per block: 16 per warp
constexpr int BK_BF16 = 64;   // keys per shared-memory tile

// Dynamic shared memory of the bf16 kernel: sK, sVt and, above hd 128, the
// block's Q tile.
template <int HD>
struct Bf16Tile {
  static constexpr bool Q_IN_SMEM = HD > 128;
  static constexpr int KSTRIDE = HD + 8;       // sK/sQ row, padded
  static constexpr int VSTRIDE = BK_BF16 + 8;  // sVt row, padded
  static constexpr size_t SMEM =
      sizeof(__nv_bfloat16) * (BK_BF16 * KSTRIDE + HD * VSTRIDE +
                               (Q_IN_SMEM ? BQ_BF16 * KSTRIDE : 0));
};

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a (16x16, row) * b (16x8, col); bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
attn_fwd_bf16(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ o, int Sq, int Sk, int H, int KH,
              float scale, int causal, int window) {
  constexpr int BQ = BQ_BF16;
  constexpr int BK = BK_BF16;
  constexpr bool Q_IN_SMEM = Bf16Tile<HD>::Q_IN_SMEM;
  constexpr int KSTRIDE = Bf16Tile<HD>::KSTRIDE;  // conflict-free fragments
  constexpr int VSTRIDE = Bf16Tile<HD>::VSTRIDE;
  constexpr int KC = HD / 16;       // 16-deep chunks of the QK^T product
  constexpr int NO = HD / 8;        // 8-wide column tiles of the output
  constexpr int VEC = HD / 8;       // 16-byte vectors per Q/K/V row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sVt = sK + BK * KSTRIDE;
  __nv_bfloat16* sQ = sVt + HD * VSTRIDE;   // Q_IN_SMEM only

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kh = h / (H / KH);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;          // fragment row (and B-fragment column)
  const int t = lane & 3;           // fragment column pair
  const int row0 = q0 + warp * 16 + g;
  const int row1 = row0 + 8;

  // Q as A fragments (rows row0/row1, zero past Sq) in registers, or the
  // block's Q tile in shared memory (zero past Sq); the first barrier of the
  // KV loop publishes it.
  uint32_t qa[Q_IN_SMEM ? 1 : KC][4];
  {
    const size_t qs = static_cast<size_t>(H) * HD;
    const __nv_bfloat16* qb = q + static_cast<size_t>(b) * Sq * qs + static_cast<size_t>(h) * HD;
    if constexpr (Q_IN_SMEM) {
      for (int idx = tid; idx < BQ * VEC; idx += THREADS) {
        const int r = idx / VEC;
        const int c = (idx - r * VEC) * 8;
        uint4 qv = make_uint4(0u, 0u, 0u, 0u);
        if (q0 + r < Sq) qv = *reinterpret_cast<const uint4*>(qb + (q0 + r) * qs + c);
        *reinterpret_cast<uint4*>(&sQ[r * KSTRIDE + c]) = qv;
      }
    } else {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        const int d = kc * 16 + 2 * t;
        qa[kc][0] = row0 < Sq ? ld32(qb + row0 * qs + d) : 0u;
        qa[kc][1] = row1 < Sq ? ld32(qb + row1 * qs + d) : 0u;
        qa[kc][2] = row0 < Sq ? ld32(qb + row0 * qs + d + 8) : 0u;
        qa[kc][3] = row1 < Sq ? ld32(qb + row1 * qs + d + 8) : 0u;
      }
    }
  }
  float oacc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF;   // running max of rows row0, row1
  float l0 = 0.f, l1 = 0.f;           // this thread's share of the denominators

  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  k_begin -= k_begin % BK;

  const size_t rs = static_cast<size_t>(KH) * HD;
  const __nv_bfloat16* kb = k + static_cast<size_t>(b) * Sk * rs + static_cast<size_t>(kh) * HD;
  const __nv_bfloat16* vb = v + static_cast<size_t>(b) * Sk * rs + static_cast<size_t>(kh) * HD;

  for (int kt = k_begin; kt < k_end; kt += BK) {
    __syncthreads();  // every warp is done with the previous tile
    for (int idx = tid; idx < BK * VEC; idx += THREADS) {
      const int r = idx / VEC;
      const int c = (idx - r * VEC) * 8;
      const int key = kt + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (key < Sk) {
        kv = *reinterpret_cast<const uint4*>(kb + key * rs + c);
        vv = *reinterpret_cast<const uint4*>(vb + key * rs + c);
      }
      *reinterpret_cast<uint4*>(&sK[r * KSTRIDE + c]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int i = 0; i < 8; ++i) sVt[(c + i) * VSTRIDE + r] = ve[i];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys; each s[j]
    // sums its 16-deep chunks in order kc = 0, 1, ...
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t a[4];
      if constexpr (Q_IN_SMEM) {
        const __nv_bfloat16* qr = &sQ[(warp * 16 + g) * KSTRIDE + kc * 16 + 2 * t];
        a[0] = ld32(qr);
        a[1] = ld32(qr + 8 * KSTRIDE);
        a[2] = ld32(qr + 8);
        a[3] = ld32(qr + 8 * KSTRIDE + 8);
      } else {
        a[0] = qa[kc][0];
        a[1] = qa[kc][1];
        a[2] = qa[kc][2];
        a[3] = qa[kc][3];
      }
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const __nv_bfloat16* kr = &sK[(8 * j + g) * KSTRIDE + kc * 16 + 2 * t];
        mma_bf16(s[j], a, ld32(kr), ld32(kr + 8));
      }
    }

    // Mask, scale and the tile's row maxima (a row lives in 4 lanes).
    uint32_t ok = 0u;
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt + 8 * j + 2 * t + (e & 1);
        const int row = e < 2 ? row0 : row1;
        bool in = key < Sk;
        if (causal) in = in && key <= row;
        if (window > 0) in = in && key > row - window;
        s[j][e] = in ? s[j][e] * scale : NEG_INF;
        ok |= in ? (1u << (4 * j + e)) : 0u;
        if (e < 2) mx0 = fmaxf(mx0, s[j][e]);
        else mx1 = fmaxf(mx1, s[j][e]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float c0 = expf(m0 - mn0);
    const float c1 = expf(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ((ok >> (4 * j + e)) & 1u)
                            ? expf(s[j][e] - (e < 2 ? mn0 : mn1)) : 0.f;
        s[j][e] = p;
        if (e < 2) sum0 += p;
        else sum1 += p;
      }
    }
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      oacc[n][0] *= c0;
      oacc[n][1] *= c0;
      oacc[n][2] *= c1;
      oacc[n][3] *= c1;
    }

    // O += P V: two adjacent 8-key accumulator tiles form one A fragment.
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const __nv_bfloat16* vr = &sVt[(8 * n + g) * VSTRIDE + kc * 16 + 2 * t];
        mma_bf16(oacc[n], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f);
  const float d1 = fmaxf(l1, 1e-30f);
  const size_t os = static_cast<size_t>(H) * HD;
  __nv_bfloat16* ob = o + static_cast<size_t>(b) * Sq * os + static_cast<size_t>(h) * HD + 2 * t;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if (row0 < Sq)
      *reinterpret_cast<uint32_t*>(ob + row0 * os + 8 * n) =
          pack_bf16(oacc[n][0] / d0, oacc[n][1] / d0);
    if (row1 < Sq)
      *reinterpret_cast<uint32_t*>(ob + row1 * os + 8 * n) =
          pack_bf16(oacc[n][2] / d1, oacc[n][3] / d1);
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int Sq, int Sk, int H, int KH, float scale, int causal,
                   int window, int dtype, cudaStream_t stream) {
  if (dtype == 0) {
    constexpr int BQ = F32Tile<HD>::BQ;
    const dim3 grid((Sq + BQ - 1) / BQ, B * H);
    attn_fwd_f32<HD><<<grid, THREADS, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, H, KH,
        scale, causal, window);
  } else {
    constexpr size_t smem = Bf16Tile<HD>::SMEM;
    if (smem > 48 * 1024) {  // above the static limit: opt in, once per device
      static std::atomic<uint64_t> opted{0};  // bit d: device d has opted in
      int dev = 0;
      cudaError_t err = cudaGetDevice(&dev);
      if (err != cudaSuccess) return err;
      const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;  // 0: always
      if (!(opted.load(std::memory_order_relaxed) & bit)) {
        err = cudaFuncSetAttribute(attn_fwd_bf16<HD>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(smem));
        if (err != cudaSuccess) return err;
        opted.fetch_or(bit, std::memory_order_relaxed);
      }
    }
    const dim3 grid((Sq + BQ_BF16 - 1) / BQ_BF16, B * H);
    attn_fwd_bf16<HD><<<grid, THREADS, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
        Sq, Sk, H, KH, scale, causal, window);
  }
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
  switch (hd) {
#define REPRO_HD_CASE(N) \
  case N:                \
    return static_cast<int>(launch<N>(q, k, v, o, B, Sq, Sk, H, KH, scale, causal, window, dtype, s));
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
