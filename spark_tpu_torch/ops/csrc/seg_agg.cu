// One-pass grouped (segmented) reductions for Hopper (sm_90a): the CUDA
// counterparts of the two Pallas kernels in spark_tpu/ops/pallas_agg.py.
//
//   seg_sum_launch    replaces pallas_agg.py:_kernel (via pallas_seg_sum):
//                     grouped float32 sum, or, with exact_int, the grouped
//                     count of live rows as int64 (the engine's only use:
//                     count(*), count(col) and the group-present test).
//   seg_minmax_launch replaces pallas_agg.py:_minmax_kernel (via
//                     pallas_seg_minmax): grouped float32 min or max.
//
// Semantics (the reference's): row i adds to group seg[i] when mask[i] is
// true and 0 <= seg[i] < K; other rows add nothing. An empty group sums to
// 0, counts 0, and has min +inf / max -inf. A group that holds a NaN has
// min and max NaN (jnp.minimum/jnp.maximum propagate NaN).
//
// Bound on an H100 SXM (3.35 TB/s): each row is read once, 9 bytes for a
// float sum or min/max (f32 data, int32 seg, bool mask), 5 bytes for a
// count (seg and mask only), so about 2.7 us per million rows for a sum
// and 1.5 us for a count. The work per row is a handful of integer and
// float operations, far below the compute peak: bandwidth bounds them.
//
// Design. The TPU kernel walks its grid in order and carries one (K, 128)
// accumulator in VMEM across grid steps. Blocks on Hopper run in parallel
// and in no order, so the reduction is reorganised in two passes:
//
//   1. Each block walks a grid-stride range of 128-row warp chunks; each
//      lane reads its 4 rows with 16-byte loads of seg and data (4-byte
//      loads of mask). Every warp owns a private K-entry accumulator in
//      shared memory (8 warps * K * 4 bytes <= 32 KB for K <= 1024). Lanes
//      that hold the same group in one step find each other with
//      __match_any_sync; the lowest such lane adds its peers' values in
//      lane order. No atomics: each accumulator has one writer, and every
//      sum is taken in an order fixed by the row layout and the grid size,
//      so float sums are bit-identical from run to run. At the end the
//      block folds its warps' accumulators in warp order and writes one
//      partial per group to a (K, G) buffer.
//   2. One block per group folds that group's G partials in a fixed tree.
//
// G depends only on the row count (seg_agg_grid), so a layout always
// gives the same bits. Counts are exact integers in any order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerLane = 4;
constexpr int kChunk = 32 * kRowsPerLane;  // rows per warp step
constexpr int kMaxBlocks = 132 * 4;        // 4 blocks on each SM
constexpr int kMaxK = 1024;

enum Mode { kSum = 0, kCount = 1, kMin = 2, kMax = 3 };

template <int M>
struct Acc {
  using T = float;  // per-block partial
  using W = float;  // final value
};
template <>
struct Acc<kCount> {
  using T = unsigned int;
  using W = unsigned long long;
};

template <int M>
__device__ __forceinline__ float identity_f() {
  if constexpr (M == kMin) return __int_as_float(0x7f800000);  // +inf
  if constexpr (M == kMax) return __int_as_float(0xff800000);  // -inf
  return 0.0f;
}

template <int M>
__device__ __forceinline__ float combine(float a, float b) {
  if constexpr (M == kSum) {
    return a + b;
  } else {
    if (a != a || b != b) return __int_as_float(0x7fc00000);  // NaN wins
    return M == kMin ? fminf(a, b) : fmaxf(a, b);
  }
}

template <int M>
__global__ void __launch_bounds__(kThreads)
seg_partial_kernel(const float* __restrict__ data,
                   const int* __restrict__ seg,
                   const unsigned char* __restrict__ mask, long long n,
                   int K, int vec, typename Acc<M>::T* __restrict__ partials) {
  using T = typename Acc<M>::T;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* hist = reinterpret_cast<T*>(smem_raw);  // [kWarps][K]
  __shared__ float stage[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kWarps * K; i += kThreads) {
    if constexpr (M == kCount) {
      hist[i] = 0;
    } else {
      hist[i] = identity_f<M>();
    }
  }
  __syncthreads();
  T* mine = hist + warp * K;

  const long long stride = (long long)gridDim.x * kWarps * kChunk;
  for (long long base = ((long long)blockIdx.x * kWarps + warp) * kChunk;
       base < n; base += stride) {  // uniform across the warp
    const long long r0 = base + (long long)lane * kRowsPerLane;
    int s[kRowsPerLane];
    float v[kRowsPerLane];
    bool live[kRowsPerLane];
    if (vec && base + kChunk <= n) {
      const int4 s4 = *reinterpret_cast<const int4*>(seg + r0);
      const uchar4 m4 = *reinterpret_cast<const uchar4*>(mask + r0);
      s[0] = s4.x; s[1] = s4.y; s[2] = s4.z; s[3] = s4.w;
      live[0] = m4.x; live[1] = m4.y; live[2] = m4.z; live[3] = m4.w;
      if constexpr (M != kCount) {
        const float4 v4 = *reinterpret_cast<const float4*>(data + r0);
        v[0] = v4.x; v[1] = v4.y; v[2] = v4.z; v[3] = v4.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kRowsPerLane; ++j) {
        const bool in = r0 + j < n;
        s[j] = in ? seg[r0 + j] : -1;
        live[j] = in && mask[r0 + j];
        if constexpr (M != kCount) v[j] = in ? data[r0 + j] : 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < kRowsPerLane; ++j) {
      const int key = (live[j] && s[j] >= 0 && s[j] < K) ? s[j] : -1;
      const unsigned peers = __match_any_sync(0xffffffffu, key);
      const bool leader = lane == __ffs(peers) - 1;
      if constexpr (M == kCount) {
        if (key >= 0 && leader) mine[key] += __popc(peers);
      } else {
        stage[warp][lane] = v[j];
        __syncwarp();
        if (key >= 0 && leader) {
          float acc = mine[key];
          for (unsigned p = peers; p; p &= p - 1)
            acc = combine<M>(acc, stage[warp][__ffs(p) - 1]);
          mine[key] = acc;
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += kThreads) {
    T acc = hist[k];
    for (int w = 1; w < kWarps; ++w) {
      if constexpr (M == kCount) {
        acc += hist[w * K + k];
      } else {
        acc = combine<M>(acc, hist[w * K + k]);
      }
    }
    partials[(long long)k * gridDim.x + blockIdx.x] = acc;
  }
}

template <int M>
__global__ void __launch_bounds__(kThreads)
seg_final_kernel(const typename Acc<M>::T* __restrict__ partials, int G,
                 typename Acc<M>::W* __restrict__ out) {
  using W = typename Acc<M>::W;
  __shared__ W red[kThreads];
  const int k = blockIdx.x;
  const typename Acc<M>::T* row = partials + (long long)k * G;
  W acc;
  if constexpr (M == kCount) {
    acc = 0;
    for (int g = threadIdx.x; g < G; g += kThreads) acc += row[g];
  } else {
    acc = identity_f<M>();
    for (int g = threadIdx.x; g < G; g += kThreads)
      acc = combine<M>(acc, row[g]);
  }
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      if constexpr (M == kCount) {
        red[threadIdx.x] += red[threadIdx.x + s];
      } else {
        red[threadIdx.x] = combine<M>(red[threadIdx.x], red[threadIdx.x + s]);
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) out[k] = red[0];
}

int grid_for(long long n) {
  const long long g = (n + (long long)kWarps * kChunk - 1) /
                      ((long long)kWarps * kChunk);
  return (int)(g < 1 ? 1 : (g > kMaxBlocks ? kMaxBlocks : g));
}

template <int M>
int launch(const float* data, const int* seg, const unsigned char* mask,
           long long n, int K, void* partials, void* out, void* stream) {
  if (K < 1 || K > kMaxK || n < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int grid = grid_for(n);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(seg) |
                         reinterpret_cast<uintptr_t>(mask) |
                         (M == kCount ? 0 : reinterpret_cast<uintptr_t>(data));
  const int vec = (addr % 16) == 0;
  const size_t smem = (size_t)kWarps * K * sizeof(typename Acc<M>::T);
  seg_partial_kernel<M><<<grid, kThreads, smem, st>>>(
      data, seg, mask, n, K, vec,
      reinterpret_cast<typename Acc<M>::T*>(partials));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  seg_final_kernel<M><<<K, kThreads, 0, st>>>(
      reinterpret_cast<const typename Acc<M>::T*>(partials), grid,
      reinterpret_cast<typename Acc<M>::W*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of blocks of the first pass for n rows: the wrapper sizes the
// (K, G) partials buffer with it.
int seg_agg_grid(long long n) { return grid_for(n); }

// exact_int == 0: out is float32[K], partials float32[K * G], data f32[n].
// exact_int != 0: out is int64[K] (counts of live rows), partials
//                 uint32[K * G], data is not read (may be null).
int seg_sum_launch(const float* data, const int* seg,
                   const unsigned char* mask, long long n, int K,
                   int exact_int, void* partials, void* out, void* stream) {
  if (exact_int)
    return launch<kCount>(data, seg, mask, n, K, partials, out, stream);
  return launch<kSum>(data, seg, mask, n, K, partials, out, stream);
}

// out is float32[K], partials float32[K * G].
int seg_minmax_launch(const float* data, const int* seg,
                      const unsigned char* mask, long long n, int K,
                      int is_max, void* partials, void* out, void* stream) {
  if (is_max)
    return launch<kMax>(data, seg, mask, n, K, partials, out, stream);
  return launch<kMin>(data, seg, mask, n, K, partials, out, stream);
}

}  // extern "C"
