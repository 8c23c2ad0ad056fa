// Exact, correctly rounded grouped float sum for Hopper (sm_90a): the
// port's kernel for the float branch of the reference's grouped sum,
// jax.ops.segment_sum over float data (spark_tpu/physical/kernels.py:seg_sum,
// lines 219-228). XLA's segment_sum has no Pallas kernel; on the card
// PyTorch's counterpart, index_add_, adds floats with atomics whose order
// changes from run to run, so its bits change too. Here each group's sum is
// exact until one final rounding, so its bits depend only on the multiset of
// the group's live values: not on the launch, the row order, the positions
// of dead rows or the order of the atomics.
//
//   seg_fsum_launch   float64 or float32 data, int32 group ids, bool mask,
//                     any K >= 1; out is float64[K] or float32[K].
//
// Semantics: row i adds to group seg[i] when mask[i] is true and
// 0 <= seg[i] < K. A group holding a NaN, or both +inf and -inf, sums to
// NaN; else a group holding +inf (-inf) sums to +inf (-inf). Otherwise the
// result is the exact sum of the group's finite values rounded once, to
// nearest with ties to even, into the data's type (float32 data is rounded
// straight to float32, never through float64), +-inf past the largest
// finite value; an empty group, or one whose values sum to exactly zero,
// gives +0.0. No value is dropped, however far below the group's largest.
//
// Design: a long (Kulisch) accumulator of 32-bit digits at absolute
// positions, one read of the input.
//
//   A finite x is m * 2^(q - Q) with m < 2^P an integer, q = max(e - 1, 0)
//   from the biased exponent field e, and Q the exponent of the type's
//   smallest subnormal (float64: P = 53, Q = 1074, q in [0, 2045]; float32:
//   P = 24, Q = 149, q in [0, 253]). m << (q mod 32), below 2^84 (float32
//   2^55), lies in 32-bit digits d = q >> 5 and up: 3 digits for float64
//   (d + 2 <= 65), 2 for float32 (d + 1 <= 8). So a group needs D = 66
//   int64 digit words for float64 and D = 9 for float32. Every row adds at
//   most one chunk below 2^32 to each word, so with N < 2^31 rows each
//   word's sum stays below 2^63, and its int64 adds are exact and commute.
//   The sum of N values needs at most 31 bits above the top digit (float64:
//   below 2^2129, float32 2^308): the carry out of word D - 1, below 2^31,
//   is kept in a register by the finish and never stored.
//
//   1. fsum_digit_kernel reads every row once. Each block takes one
//      contiguous chunk of at most 2^15 rows, loading 16 bytes of ids a
//      lane, contiguous across the warp, as seg_agg.cu does. Up to 1024
//      groups are privatized in shared memory (one copy per warp while they
//      fit; past 1024 groups, the id range from the block's first row's id,
//      which covers the chunk when ids are sorted): per group a window of
//      12 16-bit half-digits in 32-bit words (a 64-bit shared add is a
//      compare-and-swap loop on this card, a 32-bit one is native), its
//      base fixed by the group's first deposit in the block, one digit below
//      it. A word takes one chunk below 2^16 a row, so it stays below 2^31.
//      Chunks the window does not hold go to the global [D][K] digit array
//      with 64-bit atomics; since every add is exact, where a chunk is added
//      never changes the result.
//      - Scattered ids: each value's 16-bit chunks, with its sign, are added
//        to its group's window (6 native shared atomics a row).
//      - Sorted ids (the ids of a warp step's first load run non-decreasing
//        across the warp, and 28 or more lanes find their 4 consecutive
//        rows in one group; a hot group in unsorted ids fails the first
//        test): where a load's 4 rows lie
//        in one group at digits dmin and dmin + 1, the lane sums them as one
//        128-bit integer in units of digit dmin, the warp merges the sums
//        of lanes holding one group and dmin (a segmented shuffle scan), and
//        one lane deposits each merged sum; the other loads' values are
//        deposited one by one.
//      NaN / +inf / -inf flags are ORed into a per-group word. Each block
//      adds its nonzero window words into the global array once, at its end.
//   2. fsum_finish_kernel, one thread a group, reads only the K x D digit
//      words and flags: it propagates the carries (once to find the sum's
//      sign, once more on the negated words when negative), keeps the top
//      nonzero digit, the two below it and a sticky bit, rounds to
//      nearest-even from there, handles subnormal results and overflow, and
//      writes out.
//
// seg_fsum_plain (ops/seg_agg.py) builds the same digits and finishes with
// the same steps in torch ops: every representation of the exact sum has
// one normalized form, so the two agree bit for bit.
//
// Bound: one read, 13 bytes a row for float64 (int32 id, bool mask, the
// value) and 9 for float32, and each group's result written once: 0.0233
// ms at N = 5,997,568, K = 168 float64 on an H100 SXM (3.35 TB/s). The
// digit array's memset and the finish's read (2 x K x D x 8 bytes) are
// this design's overhead, not part of the bound. A call is a memset and
// two kernels; only the first kernel reads the input. The digit kernel's
// integer work per row (the value's digits and chunks, its window's base,
// 6 shared atomics) keeps it above the bound (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerLoad = 4;          // one 16-byte load of int32 ids
constexpr int kLoads = 2;                // loads of ids a lane takes a step
constexpr int kRows = kLoads * kRowsPerLoad;  // rows a lane takes a step
constexpr int kChunk = 32 * kRows;       // rows a warp takes a step
constexpr int kWin = 12;                 // half-digits a group's window keeps
constexpr int kPrivMax = 1024;           // groups privatized in a block
constexpr int kCopyGroups = 256;         // per-warp copies while they fit

// Runs of the digit kernel on the device (float64, float32): block 0 of
// every launch adds one, so a launch a CUDA graph replays counts as one
// made directly.
__device__ unsigned long long g_runs[2];
constexpr int kStride = kWin + 1;        // odd: groups spread over the banks
constexpr int kGroupBytes = kStride * 4 + 8;  // window, base and flags
constexpr int kBlockRows = 1 << 15;      // rows a block takes at most
constexpr int kFinishThreads = 128;
constexpr int kNaN = 1, kPosInf = 2, kNegInf = 4;
constexpr int kMaxDevices = 16;
constexpr u64 kLow32 = 0xffffffffull;

template <typename In> struct Fmt;
template <> struct Fmt<double> {
  using Bits = u64;
  static constexpr int kMant = 52, kExpMax = 0x7ff, kDigits = 66;
  static constexpr u64 kSign = 1ull << 63, kInf = 0x7ffull << 52,
                       kQNaN = 0x7ff8ull << 48;
};
template <> struct Fmt<float> {
  using Bits = unsigned int;
  static constexpr int kMant = 23, kExpMax = 0xff, kDigits = 9;
  static constexpr u64 kSign = 1ull << 31, kInf = 0xffull << 23,
                       kQNaN = 0x7fc00000ull;
};

// ---- digits of one value ---------------------------------------------------

// The flag of a non-finite x (bits), else 0.
template <typename In>
__device__ __forceinline__ int nonfinite(u64 bits) {
  constexpr int M = Fmt<In>::kMant;
  if (((int)(bits >> M) & Fmt<In>::kExpMax) != Fmt<In>::kExpMax) return 0;
  if (bits & ((1ull << M) - 1)) return kNaN;
  return bits & Fmt<In>::kSign ? kNegInf : kPosInf;
}

// x (bits) as m << (q mod 32) at digit d = q >> 5, with its sign:
// |x| / 2^-Q = lo:hi * 2^(32 d), lo:hi below 2^84. Returns whether x is
// finite and nonzero. Branch-free.
template <typename In>
__device__ __forceinline__ bool magnitude(u64 bits, int& d, u64& lo, u64& hi,
                                          bool& neg) {
  constexpr int M = Fmt<In>::kMant;
  const int e = (int)(bits >> M) & Fmt<In>::kExpMax;
  const u64 frac = bits & ((1ull << M) - 1);
  const u64 m = e ? frac | (1ull << M) : frac;
  const int q = e ? e - 1 : 0;
  const int o = q & 31;
  d = q >> 5;
  lo = m << o;
  hi = (m >> 1) >> (63 - o);  // m >> (64 - o), 0 for o = 0
  neg = (bits & Fmt<In>::kSign) != 0;
  return e != Fmt<In>::kExpMax && m != 0;
}

// ---- warp merge ------------------------------------------------------------

__device__ __forceinline__ void add128(u64& lo, u64& hi, u64 blo, u64 bhi) {
  lo += blo;
  hi += bhi + (lo < blo);
}

// Consecutive lanes holding one id form a segment. Each lane's 128-bit
// lo:hi becomes its segment's sum up to it; returns true on each segment's
// last lane, which then holds the whole segment's. All 32 lanes take part.
__device__ __forceinline__ bool segment_reduce(long long id, u64& lo, u64& hi,
                                               int lane) {
  const long long prev = __shfl_up_sync(0xffffffffu, id, 1);
  const unsigned heads = __ballot_sync(0xffffffffu, lane == 0 || prev != id);
  if (heads != 0xffffffffu) {  // some lane shares its id with the one before
    const int start = 31 - __clz(heads & (0xffffffffu >> (31 - lane)));
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const u64 olo = __shfl_up_sync(0xffffffffu, lo, d);
      const u64 ohi = __shfl_up_sync(0xffffffffu, hi, d);
      if (lane - d >= start) add128(lo, hi, olo, ohi);
    }
  }
  return lane == 31 || ((heads >> (lane + 1)) & 1u);
}

// ---- adding digits ---------------------------------------------------------

// Shared memory by 32-bit address: the native 32-bit shared atomics (a
// 64-bit shared add is a compare-and-swap loop on this card).
__device__ __forceinline__ unsigned smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ int shared_ld(unsigned a) {
  int x;
  asm volatile("ld.volatile.shared.s32 %0, [%1];" : "=r"(x) : "r"(a));
  return x;
}
// Adds x when c is nonzero, predicated inside the asm: an `if` around an
// asm statement compiles to a branch.
__device__ __forceinline__ void shared_add_if(unsigned a, int x, int c) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.s32 p, %2, 0;\n\t"
      "@p red.shared.add.s32 [%0], %1;\n\t}" ::"r"(a),
      "r"(x), "r"(c));
}
__device__ __forceinline__ void shared_or(unsigned a, int x) {
  asm volatile("red.shared.or.b32 [%0], %1;" ::"r"(a), "r"(x));
}
__device__ __forceinline__ int shared_cas(unsigned a, int want, int x) {
  int old;
  asm volatile("atom.shared.cas.b32 %0, [%1], %2, %3;"
               : "=r"(old) : "r"(a), "r"(want), "r"(x));
  return old;
}

// Where a warp's digits go: its copy of the privatized groups [lo, lo +
// priv) in shared memory (32-bit addresses of its windows, their bases and
// flags), else the global [D][K] digit array and flags. A group's window
// holds kWin 16-bit half-digits from half-digit 2 * base in 32-bit words.
struct Sink {
  unsigned win, bases, flags;  // [priv][kStride], [priv] (-1: unset), [priv]
  int lo, priv, K;
  u64* acc;
  int* gflags;
};

// Signed chunks c[0..3], each below 2^32, at digit d and up of the global
// array, for the group whose column `acc` points at.
__device__ __noinline__ void add_global(u64* acc, int K, int d, long long c0,
                                        long long c1, long long c2,
                                        long long c3) {
  const long long c[4] = {c0, c1, c2, c3};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (c[j]) atomicAdd(acc + (size_t)(d + j) * K, (u64)c[j]);
}

// A magnitude's signed 16-bit chunks x[0..N) at half-digit 2 * d and up
// into group `key`: into its window when the window holds them, else into
// the global array in 32-bit chunks. The window's base is fixed by the
// group's first deposit in the block, one digit below it (clamped into
// [0, D - kWin / 2]). A deposit adds less than 2^16 to a window word and
// holds at least one row, and a block takes at most kBlockRows = 2^15
// rows, so a word stays below 2^31.
template <int D, int N>
__device__ __forceinline__ void deposit(const Sink& s, int key, int d,
                                        const int (&x)[N]) {
  const int p = key - s.lo;
  if ((unsigned)p < (unsigned)s.priv) {
    constexpr int kTop = D - kWin / 2;
    int b = shared_ld(s.bases + 4 * p);
    if (b < 0) {
      const int want = d < 1 ? 0 : (d - 1 > kTop ? kTop : d - 1);
      const int old = shared_cas(s.bases + 4 * p, -1, want);
      b = old < 0 ? want : old;
    }
    const int w = d - b;
    if ((unsigned)w <= (unsigned)((kWin - N) / 2)) {
      const unsigned q = s.win + 4 * (p * kStride + 2 * w);
#pragma unroll
      for (int j = 0; j < N; ++j) shared_add_if(q + 4 * j, x[j], x[j]);
      return;
    }
  }
  long long c[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    c[j] = 2 * j < N ? x[2 * j] + (long long)x[2 * j + 1] * 65536 : 0;
  add_global(s.acc + key, s.K, d, c[0], c[1], c[2], c[3]);
}

// The signed 16-bit chunks of +-lo:hi.
template <int N>
__device__ __forceinline__ void chunks(u64 lo, u64 hi, bool neg, int (&x)[N]) {
  const int isg = neg ? -1 : 0;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int c = (int)(((j < 4 ? lo : hi) >> (16 * (j & 3))) & 0xffff);
    x[j] = (c ^ isg) - isg;
  }
}

// ---- loads -----------------------------------------------------------------

// The rows of one warp step starting at `base`: load j of lane l covers
// rows base + (j * 32 + l) * 4 .. +3, so each load instruction reads
// contiguous memory across the warp. Rows past n are dead. v holds each
// value's bits.
template <typename In>
__device__ __forceinline__ void load_step(
    const typename Fmt<In>::Bits* __restrict__ data,
    const int* __restrict__ seg, const unsigned char* __restrict__ mask,
    long long base, long long n, int lane, bool vec, int (&s)[kRows],
    bool (&live)[kRows], u64 (&v)[kRows]) {
  if (vec && base + kChunk <= n) {
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
        const ulonglong2* p = reinterpret_cast<const ulonglong2*>(data + r);
        const ulonglong2 a = p[0], b = p[1];
        v[4 * j] = a.x; v[4 * j + 1] = a.y;
        v[4 * j + 2] = b.x; v[4 * j + 3] = b.y;
      } else {
        const uint4 d4 = *reinterpret_cast<const uint4*>(data + r);
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
        v[4 * j + i] = in ? (u64)data[r] : 0;
      }
    }
  }
}

// ---- kernel 1: digits ------------------------------------------------------

template <typename In>
__global__ void __launch_bounds__(kThreads)
fsum_digit_kernel(const typename Fmt<In>::Bits* __restrict__ data,
                  const int* __restrict__ seg,
                  const unsigned char* __restrict__ mask, long long n, int K,
                  int priv, int copies, int chunk_steps, int vec,
                  u64* __restrict__ acc, int* __restrict__ flags) {
  constexpr int D = Fmt<In>::kDigits;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int s_lo;
  // [copies][priv][kStride] window half-digits, then [copies][priv] window
  // bases, then [copies][priv] flags
  const int groups = copies * priv;
  int* win = reinterpret_cast<int*>(smem_raw);
  int* bases = win + (size_t)groups * kStride;
  int* s_flags = bases + groups;
  const long long first = (long long)blockIdx.x * chunk_steps * kWarps * kChunk;
  if (blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(&g_runs[sizeof(In) == 8 ? 0 : 1], 1ull);
  for (int i = threadIdx.x; i < groups * kStride; i += kThreads) win[i] = 0;
  for (int i = threadIdx.x; i < groups; i += kThreads) {
    bases[i] = -1;
    s_flags[i] = 0;
  }
  if (threadIdx.x == 0) {  // the privatized ids: [lo, lo + priv)
    int lo = 0;
    if (K > priv && first < n) {
      const int s0 = seg[first];
      lo = s0 < 0 ? 0 : (s0 > K - priv ? K - priv : s0);
    }
    s_lo = lo;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int copy = (warp % copies) * priv;
  const Sink sink = {smem(win + (size_t)copy * kStride), smem(bases + copy),
                     smem(s_flags + copy), s_lo, priv, K, acc, flags};

  for (int step = 0; step < chunk_steps; ++step) {
    const long long row0 = first + ((long long)step * kWarps + warp) * kChunk;
    if (row0 >= n) break;  // uniform across the warp
    int s[kRows];
    bool live[kRows];
    u64 v[kRows];
    load_step<In>(data, seg, mask, row0, n, lane, vec, s, live, v);
    bool odd = false;  // a live non-finite value
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int e = (int)(v[i] >> Fmt<In>::kMant) & Fmt<In>::kExpMax;
      odd |= live[i] && (unsigned)s[i] < (unsigned)K &&
             e == Fmt<In>::kExpMax;
    }
    // Sorted ids: the first load's 128 ids run non-decreasing across the
    // warp and 28 or more lanes hold one id. Unsorted ids with a hot group
    // match within many lanes but are not monotone across the warp.
    const int prev = __shfl_up_sync(0xffffffffu, s[kRowsPerLoad - 1], 1);
    const bool rising = (lane == 0 || prev <= s[0]) && s[0] <= s[1] &&
                        s[1] <= s[2] && s[2] <= s[3];
    if (__all_sync(0xffffffffu, rising) &&
        __popc(__ballot_sync(0xffffffffu, s[0] == s[kRowsPerLoad - 1])) >=
            28) {
      // Sorted ids. The 4 rows of one load are consecutive. Where they lie
      // in one group and at digits dmin and dmin + 1, the lane sums them as
      // one 128-bit integer in units of digit dmin, the warp merges the sums
      // of lanes holding one group and dmin, and one lane deposits each
      // merged sum. The lane deposits each value of its other loads.
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        const int key = s[4 * j];
        int dmin = D, dmax = -1;
        bool uniform = true;
#pragma unroll
        for (int i = 4 * j; i < 4 * j + 4; ++i) {
          const int e = (int)(v[i] >> Fmt<In>::kMant) & Fmt<In>::kExpMax;
          const bool ok = live[i] && (unsigned)s[i] < (unsigned)K &&
                          e != Fmt<In>::kExpMax && (v[i] & ~Fmt<In>::kSign);
          const int d = (e ? e - 1 : 0) >> 5;
          dmin = ok && d < dmin ? d : dmin;
          dmax = ok && d > dmax ? d : dmax;
          uniform = uniform && s[i] == key;
        }
        const bool sum = uniform && dmax - dmin <= 1;
        u64 lo = 0, hi = 0;
#pragma unroll
        for (int i = 4 * j; i < 4 * j + 4; ++i) {
          int d;
          u64 xlo, xhi;
          bool neg;
          const bool ok = magnitude<In>(v[i], d, xlo, xhi, neg) && live[i] &&
                          (unsigned)s[i] < (unsigned)K;
          if (sum) {
            if (d > dmin) {
              xhi = (xhi << 32) | (xlo >> 32);
              xlo <<= 32;
            }
            if (neg) {  // two's complement
              xlo = ~xlo + 1;
              xhi = ~xhi + (xlo == 0);
            }
            add128(lo, hi, ok ? xlo : 0, ok ? xhi : 0);
          } else if (ok) {
            int x[6];
            chunks(xlo, xhi, neg, x);
            deposit<D>(sink, s[i], d, x);
          }
        }
        // at most 128 values below 2^116 each: below 2^123
        const bool mine = sum && dmin < D;
        const long long id = mine ? ((long long)key << 8) | dmin : -1 - lane;
        if (segment_reduce(id, lo, hi, lane) && mine) {
          const bool neg = (long long)hi < 0;
          if (neg) {
            lo = ~lo + 1;
            hi = ~hi + (lo == 0);
          }
          int x[8];
          chunks(lo, hi, neg, x);
          deposit<D>(sink, key, dmin, x);
        }
      }
    } else {  // scattered ids: each value's own chunks
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        int d;
        u64 lo, hi;
        bool neg;
        const bool ok = magnitude<In>(v[i], d, lo, hi, neg) && live[i] &&
                        (unsigned)s[i] < (unsigned)K;
        if (ok) {
          int x[6];
          chunks(lo, hi, neg, x);
          deposit<D>(sink, s[i], d, x);
        }
      }
    }
    if (__any_sync(0xffffffffu, odd)) {  // NaN / +inf / -inf flags
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int f = live[i] && (unsigned)s[i] < (unsigned)K
                          ? nonfinite<In>(v[i])
                          : 0;
        if (!f) continue;
        const int p = s[i] - s_lo;
        if ((unsigned)p < (unsigned)priv)
          shared_or(sink.flags + 4 * p, f);
        else
          atomicOr(flags + s[i], f);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < groups; i += kThreads) {
    const int key = s_lo + i % priv;
    if (s_flags[i]) atomicOr(flags + key, s_flags[i]);
    const int b = bases[i];
    if (b < 0) continue;
#pragma unroll
    for (int j = 0; j < kWin / 2; ++j) {  // two half-digits a digit
      const long long w = win[(size_t)i * kStride + 2 * j] +
                          (long long)win[(size_t)i * kStride + 2 * j + 1] * 65536;
      if (w) atomicAdd(acc + (size_t)(b + j) * K + key, (u64)w);
    }
  }
}

// ---- kernel 2: carry, round, write -----------------------------------------

// One group's bits from its digit words acc[i * K] (i < D) and flags.
template <typename In>
__device__ __forceinline__ u64 finish(const long long* __restrict__ acc,
                                      int K, int f) {
  constexpr int D = Fmt<In>::kDigits;
  constexpr int P = Fmt<In>::kMant + 1;
  if ((f & kNaN) || (f & (kPosInf | kNegInf)) == (kPosInf | kNegInf))
    return Fmt<In>::kQNaN;
  if (f & kPosInf) return Fmt<In>::kInf;
  if (f & kNegInf) return Fmt<In>::kSign | Fmt<In>::kInf;
  long long a[D];
  long long c = 0;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    a[i] = __ldcg(acc + (size_t)i * K);
  }
#pragma unroll
  for (int i = 0; i < D; ++i) c = (a[i] + c) >> 32;
  const bool neg = c < 0;  // the sum's sign: the carry out of the top word
  // normalized digits r_0..r_D of |sum|, r_i in [0, 2^32); keep the top
  // nonzero one (h0 at index top), the two below it and whether any lower
  // digit is nonzero
  c = 0;
  int top = -1;
  u64 h0 = 0, h1 = 0, h2 = 0, p1 = 0, p2 = 0;
  bool below = false, lower = false;
#pragma unroll
  for (int i = 0; i <= D; ++i) {
    u64 r;
    if (i < D) {
      const long long t = (neg ? -a[i] : a[i]) + c;
      r = (u64)t & kLow32;
      c = t >> 32;
    } else {
      r = (u64)c;
    }
    if (r) {
      top = i;
      h0 = r; h1 = p1; h2 = p2;
      below = lower;
    }
    lower |= p2 != 0;
    p2 = p1;
    p1 = r;
  }
  if (top < 0) return 0;  // an exact zero is +0.0
  const int nb = 64 - __clzll(h0);  // bits of h0, 1..32
  const int L = 32 * top + nb;      // bits of |sum| / 2^-Q
  const int sh = 32 - nb;           // left-align h0:h1:h2 to 96 bits
  const u64 a0 = ((h0 << sh) | (h1 >> (32 - sh))) & kLow32;
  const u64 a1 = ((h1 << sh) | (h2 >> (32 - sh))) & kLow32;
  const u64 a2 = (h2 << sh) & kLow32;
  const u64 top64 = (a0 << 32) | a1;
  const u64 m = top64 >> (64 - P);  // the leading P bits
  const u64 rnd = (top64 >> (63 - P)) & 1;
  const bool sticky = (top64 & ((1ull << (63 - P)) - 1)) || a2 || below;
  u64 bits;
  if (L <= P) {  // exact: a subnormal, or the smallest normal binade
    bits = m >> (P - L);
  } else {
    const int ex = L - P < Fmt<In>::kExpMax - 1 ? L - P : Fmt<In>::kExpMax - 1;
    bits = ((u64)ex << (P - 1)) + m + (rnd & (u64)(sticky || (m & 1)));
    if (bits > Fmt<In>::kInf) bits = Fmt<In>::kInf;
  }
  return neg ? bits | Fmt<In>::kSign : bits;
}

template <typename In>
__global__ void __launch_bounds__(kFinishThreads)
fsum_finish_kernel(const long long* __restrict__ acc,
                   const int* __restrict__ flags, int K,
                   typename Fmt<In>::Bits* __restrict__ out) {
  const int k = blockIdx.x * kFinishThreads + threadIdx.x;
  if (k < K)
    out[k] = (typename Fmt<In>::Bits)finish<In>(acc + k, K, flags[k]);
}

// ---- host side -------------------------------------------------------------

int steps_for(long long n, int rows_per_block) {
  const long long g = (n + rows_per_block - 1) / rows_per_block;
  return (int)(g < 1 ? 1 : g);
}

// Blocks of one resident wave of `kernel` at `smem` bytes: occupancy times
// the SM count, cached per device, kernel slot and privatized group count.
// The first call on a device lets the kernel take `max_smem` bytes of
// dynamic shared memory (past the default 48 KB).
template <typename Kernel>
cudaError_t wave_blocks(Kernel kernel, int slot, int priv, size_t smem,
                        size_t max_smem, int* blocks) {
  constexpr int kSlots = 2;
  static int cache[kMaxDevices][kSlots][kPrivMax + 1];  // 0 = not yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int* hit = dev < kMaxDevices ? &cache[dev][slot][priv] : nullptr;
  if (hit && *hit > 0) {
    *blocks = *hit;
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)max_smem);
  if (err != cudaSuccess) return err;
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
  using Bits = typename Fmt<In>::Bits;
  constexpr size_t D = Fmt<In>::kDigits;
  if (K < 1 || n < 0) return (int)cudaErrorInvalidValue;
  // scratch, zeroed here: digit words [D][K], then flags [K] (int32)
  auto* acc = reinterpret_cast<u64*>(scratch);
  int* flags = reinterpret_cast<int*>(scratch + D * K);
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, (D * K + ((size_t)K + 1) / 2) * 8, st);
  if (err != cudaSuccess) return (int)err;

  const int priv = K < kPrivMax ? K : kPrivMax;
  int copies = K <= kPrivMax ? kCopyGroups / priv : 1;
  copies = copies < 1 ? 1 : (copies > kWarps ? kWarps : copies);
  const size_t smem = (size_t)copies * priv * kGroupBytes;
  const size_t max_smem = (size_t)kPrivMax * kGroupBytes;
  int grid = 0;
  err = wave_blocks(fsum_digit_kernel<In>, sizeof(In) == 8 ? 0 : 1, priv,
                    smem, max_smem, &grid);
  if (err != cudaSuccess) return (int)err;
  const int steps = steps_for(n, kWarps * kChunk);
  grid = grid < steps ? grid : steps;
  int chunk_steps = (steps + grid - 1) / grid;
  if (chunk_steps > kBlockRows / (kWarps * kChunk))
    chunk_steps = kBlockRows / (kWarps * kChunk);
  grid = (steps + chunk_steps - 1) / chunk_steps;
  const int vec = aligned(seg, mask, data);
  fsum_digit_kernel<In><<<grid, kThreads, smem, st>>>(
      reinterpret_cast<const Bits*>(data), seg, mask, n, K, priv, copies,
      chunk_steps, vec, acc, flags);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fsum_finish_kernel<In><<<(K + kFinishThreads - 1) / kFinishThreads,
                           kFinishThreads, 0, st>>>(
      reinterpret_cast<const long long*>(acc), flags, K,
      reinterpret_cast<Bits*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// data float64[n] (is_f64) or float32[n]; out float64[K] or float32[K];
// scratch int64[66 * K + (K + 1) / 2] for float64, [9 * K + (K + 1) / 2]
// for float32, zeroed here. A memset and two kernels on `stream`; returns a
// cudaError_t.
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

// The device's run counts (unsigned long long[2]: float64, float32) on the
// current device; waits for the device.
int seg_fsum_runs(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_runs, sizeof(g_runs));
}

}  // extern "C"
