// One-pass grouped (segmented) reductions for Hopper (sm_90a): the CUDA
// counterparts of the two Pallas kernels in spark_tpu/ops/pallas_agg.py.
//
//   seg_sum_launch    replaces pallas_agg.py:_kernel (via pallas_seg_sum).
//                     Three modes: the grouped count of live rows (int64;
//                     the engine's count(*), count(col) and group-present
//                     tests), the exact grouped int64 sum (decimal and
//                     integer sums; the reference sums int64 as float64
//                     limbs, spark_tpu/physical/kernels.py:seg_sum), and
//                     the grouped float32 sum.
//   seg_minmax_launch replaces pallas_agg.py:_minmax_kernel (via
//                     pallas_seg_minmax): grouped float32 min or max.
//
// Semantics (the reference's): row i adds to group seg[i] when mask[i] is
// true and 0 <= seg[i] < K; other rows add nothing. An empty group sums to
// 0, counts 0, and has min +inf / max -inf. A group that holds a NaN has
// min and max NaN (jnp.minimum/jnp.maximum propagate NaN). int64 sums wrap
// in two's complement, as index_add_ on int64 does.
//
// Bound on an H100 SXM (3.35 TB/s): each row is read once, 5 bytes for a
// count (int32 seg, bool mask), 9 for a float32 sum or min/max, 13 for an
// int64 sum: 1.5, 2.7 and 3.9 us per million rows. The work per row is a
// few integer operations and one shared-memory atomic, far below the
// compute peak: bandwidth bounds them.
//
// Design of the count, int64-sum and min/max modes (seg_atomic_kernel):
//
//   - One launch. The wrapper's output is zeroed by cudaMemsetAsync; each
//     block merges its partials into it with global atomics, which are
//     order-free for these modes. No partials buffer, no second kernel.
//   - Each block keeps `copies` privatized K-entry accumulators in shared
//     memory (one per warp while 8 copies fit in 32 KB; the int64 mode at
//     K = 1024 keeps 4, one per two warps), updated with native shared
//     atomics: atomicAdd on uint32 (counts) or uint64 (int64 sums), and
//     atomicMax on an order-preserving uint32 code of the float (min/max).
//     No __match_any_sync and no leader loop in the hot loop.
//   - A thread first combines runs of equal consecutive group ids in
//     registers (masked rows do not break a run), so skewed inputs do not
//     serialize every row on one shared address.
//   - Each lane issues all its loads of a step before it touches shared
//     memory: 16-byte loads of seg and data and 4-byte loads of mask, 16
//     rows a lane (8 for int64 data), so an SM holds tens of KB in flight.
//     Rows of one load instruction are contiguous across the warp.
//   - The grid is the occupancy of the kernel at its shared-memory size
//     times the SM count (cached per device, mode and K), one resident
//     wave that strides over the rows.
//
// The min/max code: NaN (any sign or payload) encodes to 0xffffffff, which
// wins every atomicMax; the empty group stays at 0 and decodes to +inf
// (min) or -inf (max). Real values encode to [0x007fffff, 0xff800000], so
// a group of only +inf rows decodes to +inf and is never taken for empty.
// The code orders -0.0 below +0.0, so a group holding both gives -0.0 for
// min and +0.0 for max on every run. The last block to finish (a counter
// after the output, __threadfence, zeroed by the memset) decodes the codes
// to floats in place. Every mode's result is bit-identical from run to run
// without any fixed combine order: integer addition and max are exact.
//
// The float32 sum (seg_sum_f32_kernel) may not use float atomics, so it
// keeps the warp-match design: each warp owns a K-entry shared accumulator,
// lanes of one group meet through __match_any_sync and the lowest adds its
// peers in lane order; each block folds its warps in order into a (G, K)
// partials buffer and the last block folds the G partials in block order.
// G depends only on the row count (at most kSumBlocks), so a layout always
// gives the same bits. One launch; the engine has no caller for this mode.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerLoad = 4;           // one 16-byte load of int32 seg
constexpr int kMaxK = 1024;
constexpr int kSmemBudget = 32 * 1024;    // privatized accumulators a block
constexpr int kSumBlocks = 264;           // float32-sum grid: 2 per H100 SM
constexpr int kMaxDevices = 16;

enum Mode { kCount = 0, kSumI64 = 1, kMin = 2, kMax = 3, kSumF32 = 4 };

// Runs of each kernel on the device, by mode: block 0 of every launch adds
// one, so a launch a CUDA graph replays counts as one made directly.
__device__ unsigned long long g_runs[5];

// In: the data type read per row; T: the shared accumulator; G: the output
// word the blocks merge into; kLoads: 16-byte seg loads per lane per step.
template <int M> struct Traits;
template <> struct Traits<kCount> {
  using In = unsigned char;  // data is not read
  using T = unsigned int;
  using G = unsigned long long;
  static constexpr int kLoads = 4;
};
template <> struct Traits<kSumI64> {
  using In = long long;
  using T = unsigned long long;
  using G = unsigned long long;
  static constexpr int kLoads = 2;
};
template <> struct Traits<kMin> {
  using In = float;
  using T = unsigned int;
  using G = unsigned int;
  static constexpr int kLoads = 4;
};
template <> struct Traits<kMax> : Traits<kMin> {};
template <> struct Traits<kSumF32> {  // loads only: see seg_sum_f32_kernel
  using In = float;
  static constexpr int kLoads = 4;
};

// kRows: rows a lane takes per step; kChunk: rows a warp takes per step.
template <int M> struct Shape {
  static constexpr int kRows = Traits<M>::kLoads * kRowsPerLoad;
  static constexpr int kChunk = 32 * kRows;
};

// ---- min/max code -------------------------------------------------------

template <int M>
__device__ __forceinline__ unsigned encode(float v) {
  if (v != v) return 0xffffffffu;  // NaN wins
  const unsigned b = __float_as_uint(v);
  const unsigned up = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return M == kMax ? up : ~up;  // larger code = better candidate
}

template <int M>
__device__ __forceinline__ float decode(unsigned e) {
  if (e == 0u) return __uint_as_float(M == kMax ? 0xff800000u : 0x7f800000u);
  if (e == 0xffffffffu) return __uint_as_float(0x7fc00000u);
  const unsigned up = M == kMax ? e : ~e;
  return __uint_as_float((up & 0x80000000u) ? (up & 0x7fffffffu) : ~up);
}

// ---- per-mode arithmetic ------------------------------------------------

template <int M>
__device__ __forceinline__ typename Traits<M>::T value(
    typename Traits<M>::In x) {
  if constexpr (M == kCount) return 1u;
  else if constexpr (M == kSumI64) return (unsigned long long)x;
  else if constexpr (M == kMin || M == kMax) return encode<M>(x);
  else return x;
}

template <int M>
__device__ __forceinline__ typename Traits<M>::T combine(
    typename Traits<M>::T a, typename Traits<M>::T b) {
  if constexpr (M == kMin || M == kMax) return a > b ? a : b;
  else return a + b;
}

template <int M>
__device__ __forceinline__ void shared_update(typename Traits<M>::T* p,
                                              typename Traits<M>::T x) {
  if constexpr (M == kMin || M == kMax) atomicMax(p, x);
  else atomicAdd(p, x);
}

template <int M>
__device__ __forceinline__ void global_update(typename Traits<M>::G* p,
                                              typename Traits<M>::T x) {
  if constexpr (M == kMin || M == kMax) atomicMax(p, x);
  else atomicAdd(p, (unsigned long long)x);
}

// ---- loads --------------------------------------------------------------

// The rows of one warp step starting at `base`: load j of lane l covers
// rows base + (j * 32 + l) * 4 .. +3, so each load instruction reads
// contiguous memory across the warp. All loads are issued before any row
// is used. Rows past n are dead.
template <int M>
__device__ __forceinline__ void load_step(
    const typename Traits<M>::In* __restrict__ data,
    const int* __restrict__ seg, const unsigned char* __restrict__ mask,
    long long base, long long n, int lane, bool vec,
    int (&s)[Shape<M>::kRows], bool (&live)[Shape<M>::kRows],
    typename Traits<M>::In (&v)[Shape<M>::kRows]) {
  constexpr int kLoads = Traits<M>::kLoads;
  constexpr bool kData = M != kCount;
  if (vec && base + Shape<M>::kChunk <= n) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const long long r = base + (long long)(j * 32 + lane) * kRowsPerLoad;
      const int4 s4 = *reinterpret_cast<const int4*>(seg + r);
      const uchar4 m4 = *reinterpret_cast<const uchar4*>(mask + r);
      s[4 * j] = s4.x; s[4 * j + 1] = s4.y;
      s[4 * j + 2] = s4.z; s[4 * j + 3] = s4.w;
      live[4 * j] = m4.x; live[4 * j + 1] = m4.y;
      live[4 * j + 2] = m4.z; live[4 * j + 3] = m4.w;
      if constexpr (M == kSumI64) {
        const longlong2* p = reinterpret_cast<const longlong2*>(data + r);
        const longlong2 a = p[0], b = p[1];
        v[4 * j] = a.x; v[4 * j + 1] = a.y;
        v[4 * j + 2] = b.x; v[4 * j + 3] = b.y;
      } else if constexpr (kData) {
        const float4 d4 = *reinterpret_cast<const float4*>(data + r);
        v[4 * j] = d4.x; v[4 * j + 1] = d4.y;
        v[4 * j + 2] = d4.z; v[4 * j + 3] = d4.w;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
#pragma unroll
      for (int i = 0; i < kRowsPerLoad; ++i) {
        const long long r =
            base + (long long)(j * 32 + lane) * kRowsPerLoad + i;
        const bool in = r < n;
        s[4 * j + i] = in ? seg[r] : -1;
        live[4 * j + i] = in && mask[r];
        if constexpr (kData) v[4 * j + i] = in ? data[r] : 0;
      }
    }
  }
}

// ---- count, int64 sum, min/max ------------------------------------------

template <int M>
__global__ void __launch_bounds__(kThreads)
seg_atomic_kernel(const typename Traits<M>::In* __restrict__ data,
                  const int* __restrict__ seg,
                  const unsigned char* __restrict__ mask, long long n, int K,
                  int copies, int vec, typename Traits<M>::G* __restrict__ out,
                  unsigned int* __restrict__ done) {
  using T = typename Traits<M>::T;
  constexpr int kRows = Shape<M>::kRows;
  constexpr int kChunk = Shape<M>::kChunk;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&g_runs[M], 1ull);
  T* hist = reinterpret_cast<T*>(smem_raw);  // [copies][K]
  for (int i = threadIdx.x; i < copies * K; i += kThreads) hist[i] = T(0);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T* mine = hist + (warp % copies) * K;

  int run_key = -1;  // open run of equal group ids, kept in registers
  T run = T(0);
  const long long stride = (long long)gridDim.x * kWarps * kChunk;
  for (long long base = ((long long)blockIdx.x * kWarps + warp) * kChunk;
       base < n; base += stride) {
    int s[kRows];
    bool live[kRows];
    typename Traits<M>::In v[kRows] = {};  // not read in count mode
    load_step<M>(data, seg, mask, base, n, lane, vec, s, live, v);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (!live[i] || (unsigned)s[i] >= (unsigned)K) continue;
      const T x = value<M>(v[i]);
      if (s[i] == run_key) {
        run = combine<M>(run, x);
      } else {
        if (run_key >= 0) shared_update<M>(mine + run_key, run);
        run_key = s[i];
        run = x;
      }
    }
  }
  if (run_key >= 0) shared_update<M>(mine + run_key, run);
  __syncthreads();

  for (int k = threadIdx.x; k < K; k += kThreads) {
    T acc = hist[k];
    for (int c = 1; c < copies; ++c) acc = combine<M>(acc, hist[c * K + k]);
    if (acc != T(0)) global_update<M>(out + k, acc);
  }
  if constexpr (M == kMin || M == kMax) {
    __shared__ bool last;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(done, 1u) == gridDim.x - 1;
    __syncthreads();
    if (last) {
      __threadfence();
      float* res = reinterpret_cast<float*>(out);
      for (int k = threadIdx.x; k < K; k += kThreads)
        res[k] = decode<M>(__ldcg(out + k));
    }
  }
}

// ---- float32 sum ----------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
seg_sum_f32_kernel(const float* __restrict__ data, const int* __restrict__ seg,
                   const unsigned char* __restrict__ mask, long long n, int K,
                   int vec, float* __restrict__ partials,
                   float* __restrict__ out, unsigned int* __restrict__ done) {
  constexpr int kRows = Shape<kSumF32>::kRows;
  constexpr int kChunk = Shape<kSumF32>::kChunk;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* hist = reinterpret_cast<float*>(smem_raw);  // [kWarps][K]
  __shared__ float stage[kWarps][32];
  __shared__ bool last;
  if (blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(&g_runs[kSumF32], 1ull);
  for (int i = threadIdx.x; i < kWarps * K; i += kThreads) hist[i] = 0.0f;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* mine = hist + warp * K;

  const long long stride = (long long)gridDim.x * kWarps * kChunk;
  for (long long base = ((long long)blockIdx.x * kWarps + warp) * kChunk;
       base < n; base += stride) {  // uniform across the warp
    int s[kRows];
    bool live[kRows];
    float v[kRows];
    load_step<kSumF32>(data, seg, mask, base, n, lane, vec, s, live, v);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int key = (live[i] && (unsigned)s[i] < (unsigned)K) ? s[i] : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, key);
      stage[warp][lane] = v[i];
      __syncwarp();
      if (key >= 0 && lane == __ffs(peers) - 1) {
        float acc = mine[key];
        for (unsigned p = peers; p; p &= p - 1)
          acc += stage[warp][__ffs(p) - 1];
        mine[key] = acc;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += kThreads) {
    float acc = hist[k];
    for (int w = 1; w < kWarps; ++w) acc += hist[w * K + k];
    partials[(long long)blockIdx.x * K + k] = acc;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last) {
    __threadfence();
    for (int k = threadIdx.x; k < K; k += kThreads) {
      float acc = 0.0f;
      for (unsigned g = 0; g < gridDim.x; ++g)
        acc += __ldcg(partials + (long long)g * K + k);
      out[k] = acc;
    }
  }
}

// ---- host side -------------------------------------------------------------

// Block-steps that cover n rows (n < 2^31, checked by the wrapper).
int steps_for(long long n, int rows_per_block) {
  const long long g = (n + rows_per_block - 1) / rows_per_block;
  return (int)(g < 1 ? 1 : g);
}

// Blocks of one resident wave for mode M at K groups, cached per device:
// occupancy at the kernel's shared-memory size times the SM count.
template <int M>
cudaError_t wave_blocks(int K, size_t smem, int* blocks) {
  static int cache[kMaxDevices][kMaxK + 1];  // 0 = not computed yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cache[dev][K] > 0) {
    *blocks = cache[dev][K];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, seg_atomic_kernel<M>, kThreads, smem);
  if (err != cudaSuccess) return err;
  *blocks = (per_sm < 1 ? 1 : per_sm) * sms;
  if (dev < kMaxDevices) cache[dev][K] = *blocks;
  return cudaSuccess;
}

bool aligned(const void* seg, const void* mask, const void* data) {
  const uintptr_t a16 = reinterpret_cast<uintptr_t>(seg) |
                        reinterpret_cast<uintptr_t>(data);
  return a16 % 16 == 0 && reinterpret_cast<uintptr_t>(mask) % 4 == 0;
}

template <int M>
int launch_atomic(const void* data, const int* seg, const unsigned char* mask,
                  long long n, int K, void* out, void* stream) {
  using T = typename Traits<M>::T;
  if (K < 1 || K > kMaxK || n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  int copies = kSmemBudget / (K * (int)sizeof(T));
  copies = copies < 1 ? 1 : (copies > kWarps ? kWarps : copies);
  const size_t smem = (size_t)copies * K * sizeof(T);
  int grid = 0;
  cudaError_t err = wave_blocks<M>(K, smem, &grid);
  if (err != cudaSuccess) return (int)err;
  const int steps = steps_for(n, kWarps * Shape<M>::kChunk);
  grid = grid < steps ? grid : steps;
  constexpr bool kMinMax = M == kMin || M == kMax;
  auto* g = reinterpret_cast<typename Traits<M>::G*>(out);
  // the output, then (min/max) the finished-block counter after it
  const size_t bytes = (size_t)K * sizeof(*g) + (kMinMax ? sizeof(int) : 0);
  err = cudaMemsetAsync(out, 0, bytes, st);
  if (err != cudaSuccess) return (int)err;
  seg_atomic_kernel<M><<<grid, kThreads, smem, st>>>(
      reinterpret_cast<const typename Traits<M>::In*>(data), seg, mask, n, K,
      copies, aligned(seg, mask, data), g,
      kMinMax ? reinterpret_cast<unsigned int*>(g + K) : nullptr);
  return (int)cudaGetLastError();
}

int launch_sum_f32(const float* data, const int* seg,
                   const unsigned char* mask, long long n, int K,
                   void* partials, void* out, void* stream) {
  if (K < 1 || K > kMaxK || n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  int grid = steps_for(n, kWarps * Shape<kSumF32>::kChunk);
  grid = grid < kSumBlocks ? grid : kSumBlocks;
  float* res = reinterpret_cast<float*>(out);
  cudaError_t err = cudaMemsetAsync(res + K, 0, sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)kWarps * K * sizeof(float);
  seg_sum_f32_kernel<<<grid, kThreads, smem, st>>>(
      data, seg, mask, n, K, aligned(seg, mask, data),
      reinterpret_cast<float*>(partials), res,
      reinterpret_cast<unsigned int*>(res + K));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks of the float32 sum at most: the wrapper sizes its partials
// buffer as float32[seg_sum_f32_blocks() * K].
int seg_sum_f32_blocks() { return kSumBlocks; }

// mode 0: count of live rows; out is int64[K]; data is not read (may be
//         null); partials unused.
// mode 1: float32 sum; data float32[n]; out is float32[K + 1] (the last
//         word is scratch); partials float32[seg_sum_f32_blocks() * K].
// mode 2: int64 sum; data int64[n]; out is int64[K]; partials unused.
int seg_sum_launch(const void* data, const int* seg, const unsigned char* mask,
                   long long n, int K, int mode, void* partials, void* out,
                   void* stream) {
  switch (mode) {
    case 0:
      return launch_atomic<kCount>(data, seg, mask, n, K, out, stream);
    case 1:
      return launch_sum_f32(reinterpret_cast<const float*>(data), seg, mask,
                            n, K, partials, out, stream);
    case 2:
      return launch_atomic<kSumI64>(data, seg, mask, n, K, out, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// data float32[n]; out is float32[K + 1] (the last word is scratch).
int seg_minmax_launch(const float* data, const int* seg,
                      const unsigned char* mask, long long n, int K,
                      int is_max, void* out, void* stream) {
  if (is_max) return launch_atomic<kMax>(data, seg, mask, n, K, out, stream);
  return launch_atomic<kMin>(data, seg, mask, n, K, out, stream);
}

// The device's run counts (unsigned long long[5], indexed count, int64 sum,
// min, max, float32 sum) on the current device; waits for the device.
int seg_agg_runs(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_runs, sizeof(g_runs));
}

}  // extern "C"
