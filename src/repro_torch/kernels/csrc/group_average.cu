// Butterfly combine for Hopper (sm_90a): out = (w + recv) * inv_s.
//
// Replaces repro/kernels/group_average.py: K1 group_average_combine
// (_combine_kernel through _tiled_combine) and K2
// group_average_combine_multi (the same pallas_call over concatenated
// buckets).  Same function: each element is read in its storage type,
// widened to fp32, added, scaled by inv_s, and written back in the storage
// type (float32, or bfloat16 rounded to nearest even as astype/.to do).
// __fadd_rn then __fmul_rn keep the compiler from contracting the two into
// an FMA, so every result is bit-identical to the plain torch version.
//
// What bounds it on the H100: it does 2 flops per element against
// 3 * itemsize bytes (two reads, one write), far below the card's ~20 flops
// per byte, so it is bound by HBM bandwidth (3.35 TB/s); the least time for
// n elements is 3 * n * itemsize / 3.35e12 s.  The design moves each byte
// once, as 16-byte vectors (float4, or 8 bf16 as uint4) with neighbouring
// threads on neighbouring addresses, and issues every load of a thread
// before its first store.  out may alias w (the butterfly combines in
// place), so the compiler may not hoist a later load above an earlier
// store: a loop of load, load, store keeps one vector pair a thread in
// flight.  Each thread instead loads all kVecsPerThread of its vector
// pairs into registers, then combines and stores them (legal in place:
// each element is read and written by one thread only).  Stores stream
// (__stcs): nothing written is read again.  Loads are plain: streaming
// loads (__ldcs) made the time bimodal on the card, a few percent slower
// in some timings, out of place and in place alike.
//
// Translation from the TPU kernel.  There a (rows, 128)-lane view of a
// lane-padded flat buffer is walked tile by tile; K2 concatenates the
// buckets into one buffer first.  Here a block covers spans of kThreads *
// kVecsPerThread consecutive vectors of the flat buffer (no padding: a
// scalar tail covers n % vector width, and a pointer that is not 16-byte
// aligned takes the scalar path).  K1's grid has one block a span.  K2
// walks a table of (w, recv, out, n, first block) entries passed by
// value as a __grid_constant__ parameter: each block finds its pair and
// runs the same spans over that pair's blocks, so no joining copy is made
// and one launch covers up to kMaxPairs ragged pairs.
//
// Measured at the training slice's 553,648,128-element bucket (f32, H100
// 80GB HBM3 at 700 W): 91.7% of the HBM bound, 0.7% under torch.add out
// of place and 0.6% in place.  One vector pair a thread tied 16; 4 or 8
// were within 0.3%; a thread that stores each vector before it loads the
// next (over 4 or 16) was 2-4% slower; persistent grids of 2-8 blocks an
// SM were 3.6-6.3% slower (timed with streaming loads) and a ring of 1-D
// bulk copies (cp.async.bulk) into shared memory 4.3% slower, so none of
// those was kept.  What still bounds it: the 2:1 mix of
// reads and writes at the HBM rate, which torch.add's kernel meets at the
// same share.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVecsPerThread = 16;         // vector pairs in flight a thread
constexpr int kMaxPairs = 64;              // table entries per K2 launch

__device__ __forceinline__ float combine1(float w, float r, float inv_s) {
  return __fmul_rn(__fadd_rn(w, r), inv_s);
}

template <typename T>
struct Traits;

template <>
struct Traits<float> {
  static constexpr int kVec = 4;
  using Vec = float4;
  __device__ static float load(const float* p, int64_t i) { return p[i]; }
  __device__ static void store(float* p, int64_t i, float v) { p[i] = v; }
  __device__ static float4 combine(float4 a, float4 b, float inv_s) {
    return make_float4(combine1(a.x, b.x, inv_s), combine1(a.y, b.y, inv_s),
                       combine1(a.z, b.z, inv_s), combine1(a.w, b.w, inv_s));
  }
};

template <>
struct Traits<__nv_bfloat16> {
  static constexpr int kVec = 8;
  using Vec = uint4;
  __device__ static float load(const __nv_bfloat16* p, int64_t i) {
    return __bfloat162float(p[i]);
  }
  __device__ static void store(__nv_bfloat16* p, int64_t i, float v) {
    p[i] = __float2bfloat16_rn(v);
  }
  __device__ static uint4 combine(uint4 a, uint4 b, float inv_s) {
    const __nv_bfloat16* ah = reinterpret_cast<const __nv_bfloat16*>(&a);
    const __nv_bfloat16* bh = reinterpret_cast<const __nv_bfloat16*>(&b);
    uint4 c;
    __nv_bfloat16* ch = reinterpret_cast<__nv_bfloat16*>(&c);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      ch[j] = __float2bfloat16_rn(
          combine1(__bfloat162float(ah[j]), __bfloat162float(bh[j]), inv_s));
    return c;
  }
};

// One pair's spans blk, blk + nblk, ... of kThreads * kVecsPerThread
// vectors: 16-byte vectors when all three pointers are aligned, every load
// of a span issued before its first store, then the scalar tail; scalars
// throughout otherwise.
template <typename T>
__device__ __forceinline__ void combine_span(const T* w, const T* r, T* o,
                                             int64_t n, int64_t blk,
                                             int64_t nblk, float inv_s) {
  using Vec = typename Traits<T>::Vec;
  constexpr int V = Traits<T>::kVec;
  constexpr int K = kVecsPerThread;
  constexpr int64_t kSpan = static_cast<int64_t>(kThreads) * K;
  const bool aligned = ((reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(r) |
                         reinterpret_cast<uintptr_t>(o)) & 15) == 0;
  int64_t scalar_from = 0;
  if (aligned) {
    const Vec* wv = reinterpret_cast<const Vec*>(w);
    const Vec* rv = reinterpret_cast<const Vec*>(r);
    Vec* ov = reinterpret_cast<Vec*>(o);
    const int64_t nvec = n / V;
    for (int64_t v0 = blk * kSpan + threadIdx.x; v0 < nvec; v0 += nblk * kSpan) {
      Vec a[K], b[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int64_t v = v0 + k * kThreads;
        if (v < nvec) {
          a[k] = wv[v];
          b[k] = rv[v];
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int64_t v = v0 + k * kThreads;
        if (v < nvec) __stcs(ov + v, Traits<T>::combine(a[k], b[k], inv_s));
      }
    }
    scalar_from = nvec * V;
  }
  for (int64_t i = scalar_from + blk * kThreads + threadIdx.x; i < n;
       i += nblk * kThreads)
    Traits<T>::store(o, i, combine1(Traits<T>::load(w, i),
                                    Traits<T>::load(r, i), inv_s));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
group_average_combine_kernel(const T* w, const T* r, T* o, int64_t n,
                             float inv_s) {
  combine_span<T>(w, r, o, n, blockIdx.x, gridDim.x, inv_s);
}

struct Pair {
  const void* w;
  const void* r;
  void* o;
  long long n;
  long long first_block;   // prefix sum of the blocks of the pairs before
};

struct Table {
  Pair pairs[kMaxPairs];
  int count;
  long long blocks;        // total blocks: first_block of a pair past the end
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
group_average_combine_multi_kernel(const __grid_constant__ Table table,
                                   float inv_s) {
  const long long b = blockIdx.x;
  int p = 0;
  while (p + 1 < table.count && b >= table.pairs[p + 1].first_block) ++p;
  const Pair& pair = table.pairs[p];
  const long long end = p + 1 < table.count ? table.pairs[p + 1].first_block
                                            : table.blocks;
  combine_span<T>(static_cast<const T*>(pair.w), static_cast<const T*>(pair.r),
                  static_cast<T*>(pair.o), pair.n, b - pair.first_block,
                  end - pair.first_block, inv_s);
}

// Blocks for n elements: one a span of kThreads * kVecsPerThread vectors,
// at least one, and within the grid's x limit.
long long blocks_for(long long n, int vec) {
  const long long per_block = static_cast<long long>(kThreads) * kVecsPerThread * vec;
  long long b = (n + per_block - 1) / per_block;
  if (b < 1) b = 1;
  if (b > (1LL << 30)) b = 1LL << 30;
  return b;
}

template <typename T>
cudaError_t launch_k1(const void* w, const void* r, void* o, long long n, float inv_s,
                      cudaStream_t stream) {
  const long long blocks = blocks_for(n, Traits<T>::kVec);
  group_average_combine_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(w), static_cast<const T*>(r), static_cast<T*>(o), n, inv_s);
  return cudaGetLastError();
}

}  // namespace

// C entries for ctypes.  dtype: 0 = float32, 1 = bfloat16.  Each returns
// cudaGetLastError() after the launch (0 on success); the kernel runs
// asynchronously on `stream`.

extern "C" int repro_group_average_combine(const void* w, const void* r,
                                           void* o, long long n, float inv_s,
                                           int dtype, void* stream) {
  if (n < 1 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == 0 ? launch_k1<float>(w, r, o, n, inv_s, s)
                                     : launch_k1<__nv_bfloat16>(w, r, o, n, inv_s, s));
}

extern "C" int repro_group_average_max_pairs() { return kMaxPairs; }

// ws/rs/os/ns: host arrays of `count` (1 <= count <= kMaxPairs) pairs, each
// n >= 1, all of one dtype.
extern "C" int repro_group_average_combine_multi(
    const void* const* ws, const void* const* rs, void* const* os,
    const long long* ns, int count, float inv_s, int dtype, void* stream) {
  if (count < 1 || count > kMaxPairs || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = dtype == 0 ? Traits<float>::kVec : Traits<__nv_bfloat16>::kVec;
  Table table;
  table.count = count;
  long long blocks = 0;
  for (int i = 0; i < count; ++i) {
    if (ns[i] < 1) return static_cast<int>(cudaErrorInvalidValue);
    table.pairs[i] = Pair{ws[i], rs[i], os[i], ns[i], blocks};
    blocks += blocks_for(ns[i], vec);
  }
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  table.blocks = blocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (dtype == 0)
    group_average_combine_multi_kernel<float><<<grid, kThreads, 0, s>>>(table, inv_s);
  else
    group_average_combine_multi_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(table, inv_s);
  return static_cast<int>(cudaGetLastError());
}
