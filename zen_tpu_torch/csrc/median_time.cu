// K1: time-direction tap median over a virtual row concat.
//
// Replaces, in zen_tpu/ops/median_pallas.py:
//   _time_kernel_pair      (the serving step's median over [hist ++ fresh],
//                           reached through tap_median_time_pair_pallas),
//   _time_kernel           (the one-input form with constant fill, reached
//                           through tap_median_time_pallas when its rows
//                           fit one chunk: the B < history streaming step,
//                           time_filtered_tail, short offline passes), and
//   _time_kernel_pipelined (the same form double-buffered over many row
//                           chunks: the offline passes' full-T medians,
//                           e.g. the centered K = 11 of hop 256).
// All three collapse into one kernel: b may have zero rows, and the
// TPU's row chunking is the grid here.
//
//   out[c, i, f] = median over o in offsets of V[c, start + i + o, f]
//   V = rows of a [C, Ta, F] followed by rows of b [C, Tb, F]
//   rows outside [0, Ta + Tb) read `fill`
//
// What bounds it on this card: bytes. The main-path shapes take K = 3
// (hop 1024) and K = 11 (hop 256) taps; ranking by counting costs at
// most 2 K^2 compares per output, 242 at K = 11, against 4 (K + 1) bytes
// of loads and store, about 5 compares per byte -- below the ~20 FP32
// operations per byte where an H100 stops being bandwidth-bound.
// Neighbouring output rows share all but one tap row, so most tap loads
// are L1/L2 hits and device-memory traffic approaches one read of V and
// one write of out.
//
// What the simple design does about it: one thread per output element,
// with f fastest, so each warp's loads and stores are 128-byte coalesced
// rows; the two input pointers remove the concat copy the JAX step pays
// without the pair kernel; the taps live in registers (the loops over
// KMAX are unrolled), and the selection is exact rank-by-counting, which
// picks sorted[(K-1)/2], the element jnp.median picks for odd K.
//
// Past 64 taps (K = 67 to 401 at hop 8 to 32) a register array no
// longer fits: the wide kernel stages the offsets in shared memory from
// a device buffer the wrapper uploads once per offsets tuple, and
// re-reads each tap through the read-only cache in the rank loop. It is
// right, not fast: up to K^2 loads per output, mostly L1 hits.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxTaps = 64;
// largest odd k whose k int offsets fit 48 KB of shared memory
constexpr int kMaxWideTaps = 48 * 1024 / sizeof(int) - 1;

struct Taps {
  int k;
  int o[kMaxTaps];
};

template <int KMAX>
__global__ void tap_median_time_kernel(const float* __restrict__ a,
                                       const float* __restrict__ b,
                                       float* __restrict__ out, int ta, int tb,
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
        x = a[(static_cast<size_t>(c) * ta + r) * f + col];
      } else if (r >= ta && r < ta + tb) {
        x = b[(static_cast<size_t>(c) * tb + (r - ta)) * f + col];
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
  out[idx] = med;
}

// one tap of V for the wide kernel, through the read-only data cache
__device__ __forceinline__ float tap_at(const float* __restrict__ a,
                                        const float* __restrict__ b,
                                        long long c, int ta, int tb, int f,
                                        int col, int r, float fill) {
  if (r >= 0 && r < ta) {
    return __ldg(a + (static_cast<size_t>(c) * ta + r) * f + col);
  }
  if (r >= ta && r < ta + tb) {
    return __ldg(b + (static_cast<size_t>(c) * tb + (r - ta)) * f + col);
  }
  return fill;
}

__global__ void tap_median_time_wide_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    float* __restrict__ out, int ta, int tb, int f, int start, int t_out,
    long long n, const int* __restrict__ offsets, int k, float fill) {
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
  out[idx] = med;
}

}  // namespace

extern "C" int zen_tap_median_time(const float* a, const float* b, float* out,
                                   int c, int ta, int tb, int f, int start,
                                   int t_out, const int* offsets, int k,
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
    tap_median_time_kernel<4><<<blocks, threads, 0, s>>>(
        a, b, out, ta, tb, f, start, t_out, n, taps, fill);
  } else if (k <= 16) {
    tap_median_time_kernel<16><<<blocks, threads, 0, s>>>(
        a, b, out, ta, tb, f, start, t_out, n, taps, fill);
  } else {
    tap_median_time_kernel<kMaxTaps><<<blocks, threads, 0, s>>>(
        a, b, out, ta, tb, f, start, t_out, n, taps, fill);
  }
  return static_cast<int>(cudaGetLastError());
}

// K > kMaxTaps: `offsets` is a device buffer of k ints, staged in the
// block's shared memory, which bounds k by the 48 KB a block takes
// without an opt-in (kMaxWideTaps).
extern "C" int zen_tap_median_time_wide(const float* a, const float* b,
                                        float* out, int c, int ta, int tb,
                                        int f, int start, int t_out,
                                        const int* offsets, int k, float fill,
                                        void* stream) {
  if (k < 1 || k > kMaxWideTaps || k % 2 == 0 || c <= 0 || f <= 0 ||
      t_out <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = static_cast<long long>(c) * t_out * f;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  tap_median_time_wide_kernel<<<blocks, threads, k * sizeof(int),
                                static_cast<cudaStream_t>(stream)>>>(
      a, b, out, ta, tb, f, start, t_out, n, offsets, k, fill);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* zen_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
