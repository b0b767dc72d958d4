// K2: frequency-direction sliding median with the boundary built in.
//
// Replaces, in zen_tpu/ops/median_pallas.py:
//   _freq_kernel_fused     (boundary-fused median on unpadded [R, F] rows,
//                           reached through sliding_median_boundary_pallas
//                           when the folded rows tile: the hop-256 fleet),
//   _freq_kernel           (valid-mode median of a row pre-padded by
//                           jnp.pad, reached through
//                           sliding_median_last_axis_pallas: the hop-1024
//                           step, whose 2049 bins at K = 47 the fused
//                           kernel does not tile),
//   _freq_kernel_pipelined (the same, double-buffered over many row
//                           tiles: offline pass 1, K = 187 over 8193
//                           bins on one row per frame), and
//   _freq_impl_sublane     (the transposed route through the time kernels
//                           for K <= 31 on >= 128 rows that do not tile:
//                           offline pass 2, K = 13 over 513 bins).
// The TPU's lane/sublane layout choice and its row pipelining are VMEM
// and vreg concerns; on this card every route is the same grid.
//
//   out[r, j] = median over o in [-m, m] of x[r, bnd(j + o)],  m = (K-1)/2
//   bnd follows jnp.pad: reflect (|p|, then 2(F-1) - p; excludes the
//   edge sample), wrap (p mod F) or edge (clamp). `valid` reads an
//   already padded row: out[r, j] = median of x[r, j .. j + K - 1], with
//   F_out = F_in - K + 1.
//
// Element types: float and __nv_bfloat16 (the bf16 stream state). The row
// segment is staged in the input's own type; each bf16 tap converts to
// float exactly, so the float compares rank the same elements, and the
// selected value converts back to the same bf16 bits.
//
// What bounds it on this card: compares. Ranking by counting costs up to
// 2 K^2 compares per output (338 at K = 13, 4418 at K = 47, 69,938 at
// K = 187) against 8 bytes of device-memory traffic once the row segment
// is staged, so the kernel sits far on the compute side of the H100's
// ~20 operations per byte.
//
// What the simple design does about it: each block stages one row
// segment of TILE + K - 1 samples in dynamic shared memory (opted in
// above 48 KB, so K reaches ~58,000 on Hopper), boundary applied on
// the load, so device memory is read once and the padded copy, the
// transposes and the un-pad slice of the JAX routes never exist. Each
// thread then ranks its own window out of shared memory: consecutive
// threads read consecutive words (no bank conflicts) and the candidate
// loop stops at the first tap whose rank brackets (K-1)/2, which is
// sorted[(K-1)/2], the element jnp.median picks for odd K. Rows and the
// ragged last tile are masked here, so any row count is valid (the
// Pallas fused kernel needed R % 128 == 0).
//
// From K = 11 on: rank once, select many (rank_select.cuh). Counting
// costs ~K^2 per output, 34,969 at K = 187; the rank route stages the
// same segment as 64-bit keys, sorts it once per block by (value,
// position) with a bitonic sort over the next power of two, and has each
// output walk the ranks, counting positions p of its window (p - j < K,
// unsigned), until the count passes (K-1)/2: ~S/2 shared reads for
// S = tile + K - 1, eight ranks a step, where all lanes of a warp read
// the same rank (a broadcast). The wrapper (ops/median_cuda.py) takes
// this route from K = FREQ_RANK_MIN_TAPS on (the crossover measured on
// an H100: below it counting is faster on narrow rows), picks the tile
// (32 to 256 outputs, one thread each) that minimizes the walk plus the
// sort per output (on an H100 the fastest tile at the paths' K, timed in
// chip_smoke.py phase 3), and keeps counting for K whose keys do not fit the
// 227 KB a block can opt into (S > 16,384, K > ~16,000 at the smallest
// tile fitting); both routes pick the same element.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "rank_select.cuh"
#include "row_segment.cuh"

namespace {

constexpr int kTile = 256;

using zen_segment::boundary_index;
using zen_segment::kReflect;
using zen_segment::kValid;
using zen_rank::from_float;
using zen_rank::to_float;

template <typename T>
__global__ void sliding_median_kernel(const T* __restrict__ x,
                                      T* __restrict__ out, int f_in,
                                      int f_out, int k, int mode) {
  // kTile + k - 1 elements of T (one buffer name for every T: an
  // `extern __shared__ T seg[]` per instantiation would clash)
  extern __shared__ __align__(16) unsigned char seg_bytes[];
  T* seg = reinterpret_cast<T*>(seg_bytes);
  const long long r = blockIdx.x;
  const int j0 = blockIdx.y * kTile;
  const int m = (k - 1) / 2;
  const T* row = x + static_cast<size_t>(r) * f_in;
  // first input position of this tile's window, before the boundary rule
  const int base = mode == kValid ? j0 : j0 - m;
  const int live = min(kTile, f_out - j0);
  const int need = live + k - 1;
  for (int s = threadIdx.x; s < need; s += kTile) {
    seg[s] = row[boundary_index(base + s, f_in, mode)];
  }
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= live) return;
  const T* w = seg + threadIdx.x;
  int pick = 0;
  for (int q = 0; q < k; ++q) {
    const float v = to_float(w[q]);
    int lt = 0;
    int eq = 0;
    for (int u = 0; u < k; ++u) {
      const float t = to_float(w[u]);
      lt += t < v;
      eq += t == v;
    }
    if (lt <= m && m < lt + eq) {
      pick = q;
      break;
    }
  }
  out[static_cast<size_t>(r) * f_out + j0 + threadIdx.x] = w[pick];
}

// One block per (row, tile of `tile` outputs), one thread per output.
template <typename T>
__global__ void rank_select_median_kernel(const T* __restrict__ x,
                                          T* __restrict__ out, int f_in,
                                          int f_out, int k, int mode) {
  extern __shared__ __align__(16) unsigned long long keys[];
  const int tile = blockDim.x;
  const long long r = blockIdx.x;
  const int j0 = blockIdx.y * tile;
  const int m = (k - 1) / 2;
  const T* row = x + static_cast<size_t>(r) * f_in;
  const int base = mode == kValid ? j0 : j0 - m;
  const int live = min(tile, f_out - j0);
  // the row segment as keys (row_segment.cuh, shared with segment_copy)
  const int n = zen_segment::stage_keys(keys, row, base, live + k - 1, f_in,
                                        mode, threadIdx.x, tile);
  __syncthreads();
  const int j = threadIdx.x;
  T* dst = out + static_cast<size_t>(r) * f_out + j0 + j;
  if (ZEN_RANK_CUT == 1) {
    if (j < live) *dst = from_float<T>(zen_rank::value_of(keys[j]));
    return;
  }
  zen_rank::bitonic_sort(keys, n, threadIdx.x, tile);
  if (j >= live) return;
  if (ZEN_RANK_CUT == 2) {
    *dst = from_float<T>(zen_rank::value_of(keys[j]));
    return;
  }
  // the first rank at which m + 1 positions of window [j, j + k) are seen
  // (a padding key's position is past every window)
  const unsigned long long key =
      zen_rank::walk(keys, m, [&](unsigned long long kv) {
        return static_cast<int>(
            static_cast<unsigned>(zen_rank::position_of(kv) - j) <
            static_cast<unsigned>(k));
      });
  *dst = from_float<T>(zen_rank::value_of(key));
}

int check_args(int rows, int f_in, int f_out, int k, int mode) {
  if (k < 1 || k % 2 == 0 || rows <= 0 || f_out <= 0 ||
      mode < kReflect || mode > kValid) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (mode == kValid ? f_out != f_in - k + 1 : f_out != f_in) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (mode == kReflect && (k - 1) / 2 > f_in - 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

template <typename T>
int launch(const T* x, T* out, int rows, int f_in, int f_out, int k, int mode,
           void* stream) {
  int err = check_args(rows, f_in, f_out, k, mode);
  if (err != 0) return err;
  // the row segment must fit the shared memory a block may opt into
  const size_t smem = (static_cast<size_t>(kTile) + k - 1) * sizeof(T);
  err = zen_rank::opt_in(reinterpret_cast<const void*>(sliding_median_kernel<T>),
                         smem);
  if (err != 0) return err;
  const dim3 grid(static_cast<unsigned>(rows),
                  static_cast<unsigned>((f_out + kTile - 1) / kTile));
  sliding_median_kernel<T><<<grid, kTile, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      x, out, f_in, f_out, k, mode);
  return static_cast<int>(cudaGetLastError());
}

// `tile` in {32, 64, 128, 256}: the wrapper's choice for this k
template <typename T>
int launch_rank(const T* x, T* out, int rows, int f_in, int f_out, int k,
                int mode, int tile, void* stream) {
  int err = check_args(rows, f_in, f_out, k, mode);
  if (err != 0) return err;
  if (tile != 32 && tile != 64 && tile != 128 && tile != 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(zen_rank::key_count(tile + k - 1)) *
                      sizeof(unsigned long long);
  err = zen_rank::opt_in(
      reinterpret_cast<const void*>(rank_select_median_kernel<T>), smem);
  if (err != 0) return err;
  const dim3 grid(static_cast<unsigned>(rows),
                  static_cast<unsigned>((f_out + tile - 1) / tile));
  rank_select_median_kernel<T><<<grid, tile, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      x, out, f_in, f_out, k, mode);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int zen_sliding_median_boundary(const float* x, float* out,
                                           int rows, int f_in, int f_out,
                                           int k, int mode, void* stream) {
  return launch(x, out, rows, f_in, f_out, k, mode, stream);
}

extern "C" int zen_sliding_median_boundary_bf16(const __nv_bfloat16* x,
                                                __nv_bfloat16* out, int rows,
                                                int f_in, int f_out, int k,
                                                int mode, void* stream) {
  return launch(x, out, rows, f_in, f_out, k, mode, stream);
}

extern "C" int zen_sliding_median_rank(const float* x, float* out, int rows,
                                       int f_in, int f_out, int k, int mode,
                                       int tile, void* stream) {
  return launch_rank(x, out, rows, f_in, f_out, k, mode, tile, stream);
}

extern "C" int zen_sliding_median_rank_bf16(const __nv_bfloat16* x,
                                            __nv_bfloat16* out, int rows,
                                            int f_in, int f_out, int k,
                                            int mode, int tile, void* stream) {
  return launch_rank(x, out, rows, f_in, f_out, k, mode, tile, stream);
}
