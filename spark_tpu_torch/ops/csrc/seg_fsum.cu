// Deterministic grouped float sum for Hopper (sm_90a): the port's kernel for
// the float branch of the reference's grouped sum, jax.ops.segment_sum over
// float data (spark_tpu/physical/kernels.py:seg_sum, lines 219-228). XLA's
// segment_sum has no Pallas kernel; on the card PyTorch's counterpart,
// index_add_, adds floats with atomics whose order changes from run to run,
// so its bits change too. Here the bits of each group's sum depend only on
// the set of live values in the group: not on the launch, the order of the
// rows, the positions of dead rows or the order of the atomics.
//
//   seg_fsum_launch   float64 or float32 data, int32 group ids, bool mask,
//                     any K >= 1; out is float64[K] or float32[K].
//
// Semantics: row i adds to group seg[i] when mask[i] is true and
// 0 <= seg[i] < K. A group holding a NaN, or both +inf and -inf, sums to
// NaN; else a group holding +inf (-inf) sums to +inf (-inf); an empty group
// sums to 0.0; a sum past DBL_MAX is +-inf.
//
// Design: a two-pass fixed-point sum.
//
//   1. fsum_exponent_kernel: per group, the largest exponent e_g over its
//      live finite values, with |x| < 2^e_g read from the exponent field
//      (an integer atomicMax), and an OR of NaN / +inf / -inf flags.
//   2. fsum_limb_kernel: each live finite x is scaled by 2^(30 - e_g), a
//      power of two and so exact, and split into three 30-bit integer limbs
//      (trunc and subtract, exact). The limbs are added into int64
//      accumulators: integer adds commute, so any order gives the same
//      bits. 90 bits below the group's largest value and N < 2^31 rows keep
//      each limb's sum below 2^61. The last block to finish (a counter
//      after the accumulators, __threadfence) carries the limbs, rebuilds
//      each group's value in float64 with round-to-nearest intrinsics
//      (never contracted into an FMA), and rounds to float32 for float32
//      data. The error is a few ulps of the exact sum; values more than 90
//      bits below the group's largest drop out.
//
// seg_fsum_plain (ops/seg_agg.py) does the same arithmetic in torch ops, so
// the two agree bit for bit.
//
// Each pass reads every row once: 13 bytes a row for float64 (int32 id,
// bool mask, the value), 9 for float32; about 7.8 us per million float64
// rows for both passes at 3.35 TB/s on an H100 SXM. Both passes load 16
// bytes of ids a lane, contiguous across the warp, as seg_agg.cu does.
// Per step each lane merges runs of equal ids over its rows in registers,
// then the warp merges equal ids across lanes (a segmented shuffle scan)
// before one atomic per run: sorted ids (the sorted aggregate path, K past
// 1024) then cost about one global atomic per warp step. For K <= 1024 the
// accumulators are privatized in shared memory (one copy per warp while
// they fit in 32 KB) and merged into the output once per block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerLoad = 4;            // one 16-byte load of int32 ids
constexpr int kSharedMaxK = 1024;          // groups kept in shared memory
constexpr int kSmemBudget = 32 * 1024;     // privatized limb accumulators
constexpr int kExpBias = 1100;             // stored code e + kExpBias > 0
constexpr int kNaN = 1, kPosInf = 2, kNegInf = 4;
constexpr double kTwo30 = 1073741824.0;
constexpr double kTwoM30 = 1.0 / 1073741824.0;
constexpr int kMaxDevices = 16;

// kRows: rows a lane takes per step (16 float32 or 8 float64 values);
// kChunk: rows a warp takes per step.
template <typename In> struct Shape {
  static constexpr int kLoads = sizeof(In) == 8 ? 2 : 4;
  static constexpr int kRows = kLoads * kRowsPerLoad;
  static constexpr int kChunk = 32 * kRows;
};

struct Limbs {
  long long l0, l1, l2;
};

__device__ __forceinline__ double pow2(int e) {  // -1022 <= e <= 1023
  return __longlong_as_double((long long)(e + 1023) << 52);
}

// The code of the least e with |x| < 2^e, from the exponent field alone:
// a subnormal or zero takes e = -1021.
__device__ __forceinline__ int exponent_code(double x) {
  const int field = (int)((__double_as_longlong(x) >> 52) & 0x7ff);
  return (field < 1 ? 1 : field) - 1022 + kExpBias;
}

// x * 2^(30 - e) in three 30-bit limbs, from the most significant down;
// each limb has x's sign. The scale is split in two powers of two so that
// each is a normal double.
__device__ __forceinline__ Limbs split(double x, int code) {
  const int sh = 30 - (code - kExpBias);
  const int a = sh >> 1, b = sh - a;
  const double y = __dmul_rn(__dmul_rn(x, pow2(a)), pow2(b));
  const double l0 = trunc(y);
  double r = __dmul_rn(__dsub_rn(y, l0), kTwo30);
  const double l1 = trunc(r);
  r = __dmul_rn(__dsub_rn(r, l1), kTwo30);
  const double l2 = trunc(r);
  return {(long long)l0, (long long)l1, (long long)l2};
}

// One group's sum from its limb sums, exponent code and flags.
__device__ __forceinline__ double compose(long long l0, long long l1,
                                          long long l2, int code, int flags) {
  if ((flags & kNaN) || (flags & (kPosInf | kNegInf)) == (kPosInf | kNegInf))
    return __longlong_as_double(0x7ff8000000000000LL);
  if (flags & kPosInf) return __longlong_as_double(0x7ff0000000000000LL);
  if (flags & kNegInf) return __longlong_as_double((long long)0xfff0000000000000ULL);
  if (code == 0) return 0.0;
  long long c = l2 >> 30;  // carry so that l1, l2 lie in [0, 2^30)
  l2 -= c * (1LL << 30);
  l1 += c;
  c = l1 >> 30;
  l1 -= c * (1LL << 30);
  l0 += c;
  double t = __dmul_rn(__ll2double_rn(l2), kTwoM30);
  t = __dadd_rn(__ll2double_rn(l1), t);
  t = __dmul_rn(t, kTwoM30);
  const double v = __dadd_rn(__ll2double_rn(l0), t);
  const int es = code - kExpBias - 30;
  const int a = es >> 1, b = es - a;
  return __dmul_rn(__dmul_rn(v, pow2(a)), pow2(b));
}

// ---- warp merge ------------------------------------------------------------

__device__ __forceinline__ int shfl_up(int x, int d) {
  return __shfl_up_sync(0xffffffffu, x, d);
}
__device__ __forceinline__ Limbs shfl_up(Limbs x, int d) {
  return {__shfl_up_sync(0xffffffffu, x.l0, d),
          __shfl_up_sync(0xffffffffu, x.l1, d),
          __shfl_up_sync(0xffffffffu, x.l2, d)};
}
__device__ __forceinline__ int combine(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ Limbs combine(Limbs a, Limbs b) {
  return {a.l0 + b.l0, a.l1 + b.l1, a.l2 + b.l2};
}

// Consecutive lanes holding one key form a segment. Each lane's x becomes
// its segment's combination up to it; returns true on each segment's last
// lane, which then holds the whole segment's. All 32 lanes take part.
template <typename T>
__device__ __forceinline__ bool segment_reduce(int key, T& x, int lane) {
  const int prev = __shfl_up_sync(0xffffffffu, key, 1);
  const unsigned heads = __ballot_sync(0xffffffffu, lane == 0 || prev != key);
  const int start = 31 - __clz(heads & (0xffffffffu >> (31 - lane)));
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T other = shfl_up(x, d);
    if (lane - d >= start) x = combine(x, other);
  }
  return lane == 31 || ((heads >> (lane + 1)) & 1u);
}

__device__ __forceinline__ void add_limbs(unsigned long long* p, Limbs x) {
  atomicAdd(p, (unsigned long long)x.l0);
  atomicAdd(p + 1, (unsigned long long)x.l1);
  atomicAdd(p + 2, (unsigned long long)x.l2);
}

// ---- loads -----------------------------------------------------------------

// The rows of one warp step starting at `base`: load j of lane l covers
// rows base + (j * 32 + l) * 4 .. +3, so each load instruction reads
// contiguous memory across the warp. Rows past n are dead.
template <typename In>
__device__ __forceinline__ void load_step(
    const In* __restrict__ data, const int* __restrict__ seg,
    const unsigned char* __restrict__ mask, long long base, long long n,
    int lane, bool vec, int (&s)[Shape<In>::kRows],
    bool (&live)[Shape<In>::kRows], double (&v)[Shape<In>::kRows]) {
  constexpr int kLoads = Shape<In>::kLoads;
  if (vec && base + Shape<In>::kChunk <= n) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const long long r = base + (long long)(j * 32 + lane) * kRowsPerLoad;
      const int4 s4 = *reinterpret_cast<const int4*>(seg + r);
      const uchar4 m4 = *reinterpret_cast<const uchar4*>(mask + r);
      s[4 * j] = s4.x; s[4 * j + 1] = s4.y;
      s[4 * j + 2] = s4.z; s[4 * j + 3] = s4.w;
      live[4 * j] = m4.x; live[4 * j + 1] = m4.y;
      live[4 * j + 2] = m4.z; live[4 * j + 3] = m4.w;
      if constexpr (sizeof(In) == 8) {
        const double2* p = reinterpret_cast<const double2*>(data + r);
        const double2 a = p[0], b = p[1];
        v[4 * j] = a.x; v[4 * j + 1] = a.y;
        v[4 * j + 2] = b.x; v[4 * j + 3] = b.y;
      } else {
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
        v[4 * j + i] = in ? (double)data[r] : 0.0;
      }
    }
  }
}

// ---- pass 1: exponents and flags -------------------------------------------

template <typename In>
__global__ void __launch_bounds__(kThreads)
fsum_exponent_kernel(const In* __restrict__ data, const int* __restrict__ seg,
                     const unsigned char* __restrict__ mask, long long n,
                     int K, int vec, int* __restrict__ emax,
                     int* __restrict__ flags) {
  constexpr int kRows = Shape<In>::kRows;
  constexpr int kChunk = Shape<In>::kChunk;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const bool shared = K <= kSharedMaxK;
  int* s_emax = reinterpret_cast<int*>(smem_raw);  // [K] when shared
  int* s_flags = s_emax + K;                       // [K]
  if (shared)
    for (int i = threadIdx.x; i < 2 * K; i += kThreads) s_emax[i] = 0;
  __syncthreads();
  int* t_emax = shared ? s_emax : emax;
  int* t_flags = shared ? s_flags : flags;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const long long stride = (long long)gridDim.x * kWarps * kChunk;
  for (long long base = ((long long)blockIdx.x * kWarps + warp) * kChunk;
       base < n; base += stride) {  // uniform across the warp
    int s[kRows];
    bool live[kRows];
    double v[kRows];
    load_step<In>(data, seg, mask, base, n, lane, vec, s, live, v);
    int key = -1, run = 0;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (!live[i] || (unsigned)s[i] >= (unsigned)K) continue;
      if (!isfinite(v[i])) {
        atomicOr(t_flags + s[i],
                 isnan(v[i]) ? kNaN : (v[i] > 0 ? kPosInf : kNegInf));
        continue;
      }
      const int c = exponent_code(v[i]);
      if (s[i] == key) {
        run = combine(run, c);
      } else {
        if (key >= 0) atomicMax(t_emax + key, run);
        key = s[i];
        run = c;
      }
    }
    if (segment_reduce(key, run, lane) && key >= 0) atomicMax(t_emax + key, run);
  }
  if (shared) {
    __syncthreads();
    for (int k = threadIdx.x; k < K; k += kThreads) {
      if (s_emax[k]) atomicMax(emax + k, s_emax[k]);
      if (s_flags[k]) atomicOr(flags + k, s_flags[k]);
    }
  }
}

// ---- pass 2: limbs, then the last block composes ---------------------------

template <typename In>
__global__ void __launch_bounds__(kThreads)
fsum_limb_kernel(const In* __restrict__ data, const int* __restrict__ seg,
                 const unsigned char* __restrict__ mask, long long n, int K,
                 int copies, int vec, const int* __restrict__ emax,
                 const int* __restrict__ flags,
                 unsigned long long* __restrict__ limbs,
                 unsigned int* __restrict__ done, In* __restrict__ out) {
  constexpr int kRows = Shape<In>::kRows;
  constexpr int kChunk = Shape<In>::kChunk;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ bool last;
  const bool shared = copies > 0;
  // [copies][K][3] privatized limb sums, then the exponent codes [K]
  unsigned long long* hist = reinterpret_cast<unsigned long long*>(smem_raw);
  int* s_e = reinterpret_cast<int*>(hist + (size_t)copies * K * 3);
  if (shared) {
    for (int i = threadIdx.x; i < copies * K * 3; i += kThreads) hist[i] = 0;
    for (int k = threadIdx.x; k < K; k += kThreads) s_e[k] = emax[k];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int* e_tab = shared ? s_e : emax;
  unsigned long long* acc =
      shared ? hist + (size_t)(warp % copies) * K * 3 : limbs;

  const long long stride = (long long)gridDim.x * kWarps * kChunk;
  for (long long base = ((long long)blockIdx.x * kWarps + warp) * kChunk;
       base < n; base += stride) {  // uniform across the warp
    int s[kRows];
    bool live[kRows];
    double v[kRows];
    load_step<In>(data, seg, mask, base, n, lane, vec, s, live, v);
    int key = -1;
    Limbs run = {0, 0, 0};
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (!live[i] || (unsigned)s[i] >= (unsigned)K || !isfinite(v[i]))
        continue;
      const Limbs q = split(v[i], e_tab[s[i]]);
      if (s[i] == key) {
        run = combine(run, q);
      } else {
        if (key >= 0) add_limbs(acc + 3 * (size_t)key, run);
        key = s[i];
        run = q;
      }
    }
    if (segment_reduce(key, run, lane) && key >= 0)
      add_limbs(acc + 3 * (size_t)key, run);
  }
  if (shared) {
    __syncthreads();
    for (int i = threadIdx.x; i < K * 3; i += kThreads) {
      unsigned long long x = hist[i];
      for (int c = 1; c < copies; ++c) x += hist[(size_t)c * K * 3 + i];
      if (x) atomicAdd(limbs + i, x);
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last) {
    __threadfence();
    const long long* l = reinterpret_cast<const long long*>(limbs);
    for (int k = threadIdx.x; k < K; k += kThreads) {
      const double x = compose(__ldcg(l + 3 * (size_t)k),
                               __ldcg(l + 3 * (size_t)k + 1),
                               __ldcg(l + 3 * (size_t)k + 2), emax[k],
                               flags[k]);
      if constexpr (sizeof(In) == 8) out[k] = x;
      else out[k] = __double2float_rn(x);
    }
  }
}

// ---- host side -------------------------------------------------------------

int steps_for(long long n, int rows_per_block) {
  const long long g = (n + rows_per_block - 1) / rows_per_block;
  return (int)(g < 1 ? 1 : g);
}

// Blocks of one resident wave of `kernel` at `smem` bytes: occupancy times
// the SM count, cached per device, kernel slot and K (K past kSharedMaxK
// uses no shared memory and shares one entry).
template <typename Kernel>
cudaError_t wave_blocks(Kernel kernel, int slot, int K, size_t smem,
                        int* blocks) {
  constexpr int kSlots = 4;
  static int cache[kMaxDevices][kSlots][kSharedMaxK + 1];  // 0 = not yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int k_slot = K <= kSharedMaxK ? K : 0;
  int* hit = dev < kMaxDevices ? &cache[dev][slot][k_slot] : nullptr;
  if (hit && *hit > 0) {
    *blocks = *hit;
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  *blocks = (per_sm < 1 ? 1 : per_sm) * sms;
  if (hit) *hit = *blocks;
  return cudaSuccess;
}

bool aligned(const void* seg, const void* mask, const void* data) {
  const uintptr_t a16 = reinterpret_cast<uintptr_t>(seg) |
                        reinterpret_cast<uintptr_t>(data);
  return a16 % 16 == 0 && reinterpret_cast<uintptr_t>(mask) % 4 == 0;
}

template <typename In>
int launch_fsum(const In* data, const int* seg, const unsigned char* mask,
                long long n, int K, long long* scratch, In* out,
                cudaStream_t st) {
  if (K < 1 || n < 0) return (int)cudaErrorInvalidValue;
  // scratch, zeroed here: limb sums [K][3], exponent codes [K] and flags
  // [K] (int32), then the finished-block counter
  auto* limbs = reinterpret_cast<unsigned long long*>(scratch);
  int* emax = reinterpret_cast<int*>(scratch + 3LL * K);
  int* flags = emax + K;
  auto* done = reinterpret_cast<unsigned int*>(scratch + 4LL * K);
  cudaError_t err = cudaMemsetAsync(scratch, 0, (4 * (size_t)K + 1) * 8, st);
  if (err != cudaSuccess) return (int)err;

  const bool shared = K <= kSharedMaxK;
  int copies = 0;
  if (shared) {
    copies = kSmemBudget / (K * 24);
    copies = copies < 1 ? 1 : (copies > kWarps ? kWarps : copies);
  }
  const size_t smem1 = shared ? (size_t)K * 8 : 0;
  const size_t smem2 = shared ? (size_t)copies * K * 24 + (size_t)K * 4 : 0;
  const int steps = steps_for(n, kWarps * Shape<In>::kChunk);
  const int slot = sizeof(In) == 8 ? 0 : 2;
  int grid1 = 0, grid2 = 0;
  err = wave_blocks(fsum_exponent_kernel<In>, slot, K, smem1, &grid1);
  if (err != cudaSuccess) return (int)err;
  err = wave_blocks(fsum_limb_kernel<In>, slot + 1, K, smem2, &grid2);
  if (err != cudaSuccess) return (int)err;
  grid1 = grid1 < steps ? grid1 : steps;
  grid2 = grid2 < steps ? grid2 : steps;
  const int vec = aligned(seg, mask, data);
  fsum_exponent_kernel<In><<<grid1, kThreads, smem1, st>>>(
      data, seg, mask, n, K, vec, emax, flags);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fsum_limb_kernel<In><<<grid2, kThreads, smem2, st>>>(
      data, seg, mask, n, K, copies, vec, emax, flags, limbs, done, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// data float64[n] (is_f64) or float32[n]; out float64[K] or float32[K];
// scratch int64[4 * K + 1], zeroed here. Two kernels and one memset on
// `stream`; returns a cudaError_t.
int seg_fsum_launch(const void* data, int is_f64, const int* seg,
                    const unsigned char* mask, long long n, int K,
                    void* scratch, void* out, void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  auto* sc = reinterpret_cast<long long*>(scratch);
  if (is_f64)
    return launch_fsum(reinterpret_cast<const double*>(data), seg, mask, n,
                       K, sc, reinterpret_cast<double*>(out), st);
  return launch_fsum(reinterpret_cast<const float*>(data), seg, mask, n, K,
                     sc, reinterpret_cast<float*>(out), st);
}

}  // extern "C"
