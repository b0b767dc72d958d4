// K1: time-direction tap median over a virtual row concat.
//
// Replaces, in zen_tpu/ops/median_pallas.py:
//   _time_kernel_pair      (the serving step's median over [hist ++ fresh],
//                           reached through tap_median_time_pair_pallas),
//   _time_kernel           (the one-input form with constant fill, reached
//                           through tap_median_time_pallas when its rows
//                           fit one chunk: the B < history streaming step,
//                           time_filtered_tail, short offline passes),
//   _time_kernel_pipelined (the same form double-buffered over many row
//                           chunks: the offline passes' full-T medians,
//                           e.g. the centered K = 11 of hop 256), and
//   _time_kernel_piped     (the same form with one whole-extent block per
//                           stream for fleets of >= 256 streams: the
//                           512-stream hop-256 step at B < H, f32 or bf16,
//                           and its padded constant-fill branch).
// All four collapse into one kernel: b may have zero rows, and the
// TPU's row chunking and per-stream blocks are the grid here.
//
//   out[c, i, f] = median over o in offsets of V[c, start + i + o, f]
//   V = rows of a [C, Ta, F] followed by rows of b [C, Tb, F]
//   rows outside [0, Ta + Tb) read `fill`
//
// Element types: float and __nv_bfloat16 (the bf16 stream state). A bf16
// tap converts to float exactly, so the float compares rank the same
// elements, and the selected value converts back to the same bf16 bits.
//
// What bounds it on this card: bytes. The main-path shapes take K = 3
// (hop 1024) and K = 11 (hop 256) taps; ranking by counting costs at
// most 2 K^2 compares per output, 242 at K = 11, against 4 (K + 1) bytes
// of loads and store (half that in bf16), about 5 compares per byte --
// below the ~20 FP32 operations per byte where an H100 stops being
// bandwidth-bound. Neighbouring output rows share all but one tap row,
// so most tap loads are L1/L2 hits and device-memory traffic approaches
// one read of V and one write of out.
//
// What the simple design does about it: one thread per output element,
// with f fastest, so each warp's loads and stores are coalesced rows;
// the two input pointers remove the concat copy the JAX step pays
// without the pair kernel; the taps live in registers (the loops over
// KMAX are unrolled), and the selection is exact rank-by-counting, which
// picks sorted[(K-1)/2], the element jnp.median picks for odd K.
//
// Past 64 taps (K = 67 to 401 at hop 8 to 32) a register array no
// longer fits, and counting would cost up to K^2 tap reads per output
// (8,649 at K = 93, 160,801 at K = 401) on the few thousand outputs of a
// hop-32 step, a handful of blocks on 132 SMs. The rank route (rank
// once, select many, rank_select.cuh) gives each block one column and a
// run of 32 output rows: its 128 threads stage the rows the run's taps
// reach, [start + i0 + min(o), start + i0 + 31 + max(o)] of V (fill
// outside), as (value, row) keys in shared memory and bitonic-sort them
// once; then each lane of the first warp, one output row, walks the
// ranks adding the multiplicity of each row in its tap set until the sum
// passes (K-1)/2. The multiplicities
// come from a table over [min(o), max(o)] (duplicated taps, e.g. the
// replicate border's repeated offset 0, count more than once), built by
// the wrapper and uploaded once per offsets tuple, padded with 31 zeros
// on each side so that a lane reads table[row - lane + 31] without a
// branch: all lanes read one rank (a broadcast) and consecutive table
// words (no bank conflicts). The shapes of the hop-32 step have few
// outputs, so the kernel is built for latency: the four warps keep the
// staging loads of a unit in flight together and share its sort, and the
// walk reads eight ranks a step. One unit per block spreads the work
// over the SMs: 65 blocks at K = 93 [1, 183 + 32, 65], 493 at K = 401
// [1, 900, 17], where the first wide kernel ran 9 and 60.
//
// The keys (a power of two >= 32 + max(o) - min(o)) and the table must
// fit the 227 KB a block can opt into: max(o) - min(o) up to 16,352.
// Offsets that span more, whatever their count, stay on the first wide
// kernel, which stages the offsets (K up to 12,287) and re-reads each
// tap through the read-only cache in its rank loop: right, not fast.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "rank_select.cuh"

namespace {

constexpr int kMaxTaps = 64;
// largest odd k whose k int offsets fit 48 KB of shared memory
constexpr int kMaxWideTaps = 48 * 1024 / sizeof(int) - 1;

struct Taps {
  int k;
  int o[kMaxTaps];
};

using zen_rank::from_float;
using zen_rank::to_float;

// one element through the read-only data cache, as float
__device__ __forceinline__ float load_ro(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_ro(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(p))));
}

template <typename T, int KMAX>
__global__ void tap_median_time_kernel(const T* __restrict__ a,
                                       const T* __restrict__ b,
                                       T* __restrict__ out, int ta, int tb,
                                       int f, int start, int t_out,
                                       long long n, Taps taps, float fill) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int col = static_cast<int>(idx % f);
  const long long rest = idx / f;
  const int i = static_cast<int>(rest % t_out);
  const long long c = rest / t_out;
  const int k = taps.k;
  const int half = (k - 1) / 2;

  float v[KMAX];
#pragma unroll
  for (int q = 0; q < KMAX; ++q) {
    if (q < k) {
      const int r = start + i + taps.o[q];
      float x = fill;
      if (r >= 0 && r < ta) {
        x = to_float(a[(static_cast<size_t>(c) * ta + r) * f + col]);
      } else if (r >= ta && r < ta + tb) {
        x = to_float(b[(static_cast<size_t>(c) * tb + (r - ta)) * f + col]);
      }
      v[q] = x;
    }
  }
  // sorted[half] is the tap v with #(< v) <= half < #(< v) + #(== v);
  // duplicates all satisfy it with the same value
  float med = v[0];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < k) {
      int lt = 0;
      int eq = 0;
#pragma unroll
      for (int q = 0; q < KMAX; ++q) {
        if (q < k) {
          lt += v[q] < v[j];
          eq += v[q] == v[j];
        }
      }
      if (lt <= half && half < lt + eq) med = v[j];
    }
  }
  out[idx] = from_float<T>(med);
}

// one tap of V for the wide kernel, through the read-only data cache
template <typename T>
__device__ __forceinline__ float tap_at(const T* __restrict__ a,
                                        const T* __restrict__ b,
                                        long long c, int ta, int tb, int f,
                                        int col, int r, float fill) {
  if (r >= 0 && r < ta) {
    return load_ro(a + (static_cast<size_t>(c) * ta + r) * f + col);
  }
  if (r >= ta && r < ta + tb) {
    return load_ro(b + (static_cast<size_t>(c) * tb + (r - ta)) * f + col);
  }
  return fill;
}

template <typename T>
__global__ void tap_median_time_wide_kernel(
    const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out,
    int ta, int tb, int f, int start, int t_out, long long n,
    const int* __restrict__ offsets, int k, float fill) {
  extern __shared__ int offs[];
  for (int q = threadIdx.x; q < k; q += blockDim.x) offs[q] = offsets[q];
  __syncthreads();
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int col = static_cast<int>(idx % f);
  const long long rest = idx / f;
  const int row = start + static_cast<int>(rest % t_out);
  const long long c = rest / t_out;
  const int half = (k - 1) / 2;
  float med = tap_at(a, b, c, ta, tb, f, col, row + offs[0], fill);
  for (int j = 0; j < k; ++j) {
    const float v = tap_at(a, b, c, ta, tb, f, col, row + offs[j], fill);
    int lt = 0;
    int eq = 0;
    for (int q = 0; q < k; ++q) {
      const float t = tap_at(a, b, c, ta, tb, f, col, row + offs[q], fill);
      lt += t < v;
      eq += t == v;
    }
    if (lt <= half && half < lt + eq) {
      med = v;
      break;
    }
  }
  out[idx] = from_float<T>(med);
}

constexpr int kRun = 32;           // most output rows of a rank-kernel block
constexpr int kRankThreads = 128;  // threads that stage and sort them

// One block per unit: column `col` of stream `c`, output rows i0 + lane
// for lane < run. `plan` holds the multiplicity table (span + 62 ints),
// then the `staged` rows the run's taps reach, relative to its first
// output row's min(o) tap. All kRankThreads threads stage and sort; one
// lane of the first warp per output row walks.
template <typename T>
__global__ void tap_median_time_rank_kernel(
    const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out,
    int ta, int tb, int f, int start, int t_out, int run,
    const int* __restrict__ plan, int min_o, int span, int staged, int k,
    float fill) {
  extern __shared__ __align__(16) unsigned long long stage[];
  const int n = zen_rank::key_count(staged);
  const int len = span + 2 * (kRun - 1);
  const int* rows = plan + len;
  int* table = reinterpret_cast<int*>(stage + n);
  const int tid = threadIdx.x;
  const int n_runs = (t_out + run - 1) / run;
  const long long unit = blockIdx.x;
  const int col = static_cast<int>(unit % f);
  const long long rest = unit / f;
  const int i0 = static_cast<int>(rest % n_runs) * run;
  const long long c = rest / n_runs;
  for (int q = tid; q < len; q += kRankThreads) table[q] = plan[q];
  const int row0 = start + i0 + min_o;  // the V row of relative row 0
#pragma unroll 4
  for (int s = tid; s < n; s += kRankThreads) {
    unsigned long long key = zen_rank::kPadKey;
    if (s < staged) {
      const int d = rows[s];
      key = zen_rank::make_key(tap_at(a, b, c, ta, tb, f, col, row0 + d, fill), d);
    }
    stage[s] = key;
  }
  __syncthreads();
  const int lane = tid;
  const int i = i0 + lane;
  const bool live = lane < run && i < t_out;
  T* dst = out + (static_cast<size_t>(c) * t_out + i) * f + col;
  if (ZEN_RANK_CUT == 1) {
    if (live) *dst = from_float<T>(zen_rank::value_of(stage[lane]));
    return;
  }
  zen_rank::bitonic_sort(stage, n, tid, kRankThreads);
  if (!live) return;
  if (ZEN_RANK_CUT == 2) {
    *dst = from_float<T>(zen_rank::value_of(stage[lane]));
    return;
  }
  // relative row d is tap d - lane of this lane's output row, counted
  // table[d - lane + 31] times; every tap is staged, so the walk ends
  // before the padding (whose reads count 0)
  const unsigned int mult_at = kRun - 1 - lane;
  const unsigned long long key = zen_rank::walk(
      stage, (k - 1) / 2, [&](unsigned long long kv) {
        const unsigned int q = zen_rank::position_of(kv) + mult_at;
        return q < static_cast<unsigned int>(len) ? table[q] : 0;
      });
  *dst = from_float<T>(zen_rank::value_of(key));
}

template <typename T>
int launch_register(const T* a, const T* b, T* out, int c, int ta, int tb,
                    int f, int start, int t_out, const int* offsets, int k,
                    float fill, void* stream) {
  if (k < 1 || k > kMaxTaps || k % 2 == 0 || c <= 0 || f <= 0 || t_out <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Taps taps;
  taps.k = k;
  for (int q = 0; q < kMaxTaps; ++q) taps.o[q] = q < k ? offsets[q] : 0;
  const long long n = static_cast<long long>(c) * t_out * f;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 4) {
    tap_median_time_kernel<T, 4><<<blocks, threads, 0, s>>>(
        a, b, out, ta, tb, f, start, t_out, n, taps, fill);
  } else if (k <= 16) {
    tap_median_time_kernel<T, 16><<<blocks, threads, 0, s>>>(
        a, b, out, ta, tb, f, start, t_out, n, taps, fill);
  } else {
    tap_median_time_kernel<T, kMaxTaps><<<blocks, threads, 0, s>>>(
        a, b, out, ta, tb, f, start, t_out, n, taps, fill);
  }
  return static_cast<int>(cudaGetLastError());
}

// K > kMaxTaps: `offsets` is a device buffer of k ints, staged in the
// block's shared memory, which bounds k by the 48 KB a block takes
// without an opt-in (kMaxWideTaps).
template <typename T>
int launch_wide(const T* a, const T* b, T* out, int c, int ta, int tb, int f,
                int start, int t_out, const int* offsets, int k, float fill,
                void* stream) {
  if (k < 1 || k > kMaxWideTaps || k % 2 == 0 || c <= 0 || f <= 0 ||
      t_out <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = static_cast<long long>(c) * t_out * f;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  tap_median_time_wide_kernel<T><<<blocks, threads, k * sizeof(int),
                                   static_cast<cudaStream_t>(stream)>>>(
      a, b, out, ta, tb, f, start, t_out, n, offsets, k, fill);
  return static_cast<int>(cudaGetLastError());
}

// `plan` is a device buffer: span + 62 ints (31 zeros, the count of each
// offset min_o .. min_o + span - 1, 31 zeros), then `staged` rows
template <typename T>
int launch_rank(const T* a, const T* b, T* out, int c, int ta, int tb, int f,
                int start, int t_out, const int* plan, int min_o, int span,
                int staged, int run, int k, float fill, void* stream) {
  if (k < 1 || k % 2 == 0 || c <= 0 || f <= 0 || t_out <= 0 || span < 1 ||
      run < 1 || run > kRun || staged < 1 || staged > kRun - 1 + span) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      zen_rank::key_count(staged) * sizeof(unsigned long long) +
      (static_cast<size_t>(span) + 2 * (kRun - 1)) * sizeof(int);
  const int err = zen_rank::opt_in(
      reinterpret_cast<const void*>(tap_median_time_rank_kernel<T>), smem);
  if (err != 0) return err;
  const int n_runs = (t_out + run - 1) / run;
  const long long units = static_cast<long long>(c) * n_runs * f;
  tap_median_time_rank_kernel<T><<<static_cast<unsigned>(units), kRankThreads, smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      a, b, out, ta, tb, f, start, t_out, run, plan, min_o, span, staged, k,
      fill);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `offsets` is a host array of k ints (k <= 64)
extern "C" int zen_tap_median_time(const float* a, const float* b, float* out,
                                   int c, int ta, int tb, int f, int start,
                                   int t_out, const int* offsets, int k,
                                   float fill, void* stream) {
  return launch_register(a, b, out, c, ta, tb, f, start, t_out, offsets, k,
                         fill, stream);
}

extern "C" int zen_tap_median_time_bf16(const __nv_bfloat16* a,
                                        const __nv_bfloat16* b,
                                        __nv_bfloat16* out, int c, int ta,
                                        int tb, int f, int start, int t_out,
                                        const int* offsets, int k, float fill,
                                        void* stream) {
  return launch_register(a, b, out, c, ta, tb, f, start, t_out, offsets, k,
                         fill, stream);
}

// `offsets` is a device buffer of k ints (64 < k <= kMaxWideTaps)
extern "C" int zen_tap_median_time_wide(const float* a, const float* b,
                                        float* out, int c, int ta, int tb,
                                        int f, int start, int t_out,
                                        const int* offsets, int k, float fill,
                                        void* stream) {
  return launch_wide(a, b, out, c, ta, tb, f, start, t_out, offsets, k, fill,
                     stream);
}

extern "C" int zen_tap_median_time_wide_bf16(
    const __nv_bfloat16* a, const __nv_bfloat16* b, __nv_bfloat16* out, int c,
    int ta, int tb, int f, int start, int t_out, const int* offsets, int k,
    float fill, void* stream) {
  return launch_wide(a, b, out, c, ta, tb, f, start, t_out, offsets, k, fill,
                     stream);
}

extern "C" int zen_tap_median_time_rank(const float* a, const float* b,
                                        float* out, int c, int ta, int tb,
                                        int f, int start, int t_out,
                                        const int* plan, int min_o, int span,
                                        int staged, int run, int k, float fill,
                                        void* stream) {
  return launch_rank(a, b, out, c, ta, tb, f, start, t_out, plan, min_o, span,
                     staged, run, k, fill, stream);
}

extern "C" int zen_tap_median_time_rank_bf16(
    const __nv_bfloat16* a, const __nv_bfloat16* b, __nv_bfloat16* out, int c,
    int ta, int tb, int f, int start, int t_out, const int* plan, int min_o,
    int span, int staged, int run, int k, float fill, void* stream) {
  return launch_rank(a, b, out, c, ta, tb, f, start, t_out, plan, min_o, span,
                     staged, run, k, fill, stream);
}

extern "C" const char* zen_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
