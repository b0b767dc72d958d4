// Copy-only mirrors of K1 and K2: the access pattern of each median
// kernel with the selection taken out, so that "memory pattern" and
// "counting and index arithmetic" come apart by subtraction
// (zen_tpu_torch/benches/hbm_pattern.py times each beside its kernel).
//
// Replaces, in benches/hbm_pattern.py:
//   _time_dma_kernel   (l.181, the DMA-only mirror of the piped time
//                       median: rows H .. H+B of each stream's [T, bins]
//                       block) -> rows_copy;
//   _freqT_dma_kernel  (l.240, the DMA-only mirror of the transposed
//                       frequency walk, a manual-DMA chunk copy of the
//                       [1, rows, R] slab with its halo over-reads)
//                       -> segment_copy.
// The TPU mirrors copy the TPU kernels' BlockSpec and DMA walks; the
// port's kernels walk the data differently (K1 is a thread per column;
// K2 applies the border on the load and never transposes), so each
// mirror here copies the port's kernel's pattern instead.
//
//   rows_copy:     out[c, i, f] = x[c, start + i, f],  i < t_out
//   segment_copy:  out[r, j] = x[r, j]  (reflect, wrap or edge rows)
//
// What bounds them on this card: bytes, by construction. rows_copy reads
// each output's row once and writes it once; segment_copy reads a row
// segment with K - 1 halo samples per tile (cache hits past the first
// read) and writes each sample once.
//
// What each design keeps from its kernel:
// * rows_copy has the launch geometry and index arithmetic of K1's
//   network kernel (csrc/median_time.cu, tap_median_time_network_kernel),
//   through the very functions K1 calls (csrc/time_runs.cuh): 128
//   columns a block, a run of consecutive output rows a thread, and one
//   load and one store per output where K1 stages the rows its taps
//   reach and selects.
// * segment_copy has the grid and staging of the route K2 takes at its K
//   (csrc/median_freq.cu; the wrapper picks as K2's does). At a network K
//   (the fleet's K = 13): one block of 128 threads per row chunk
//   (row_segment.cuh, network_chunk), the segment staged in the input's
//   own type by zen_segment::stage_values, a sync, and each output's own
//   sample written back where K2 runs its network. At a rank K: one
//   block per (row, tile of outputs) with `tile` = the wrapper's
//   freq_rank_tile(k) threads, the key_count(tile + k - 1) 64-bit keys in
//   dynamic shared memory with the opt-in, built by the same
//   zen_segment::stage_keys; then a sync, and each output writes the
//   value of the key at its own position (no sort, no walk).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "rank_select.cuh"
#include "row_segment.cuh"
#include "time_runs.cuh"
#include "zen_select.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(zen_runs::kThreads)
rows_copy_kernel(const T* __restrict__ x, T* __restrict__ out, int t, int f,
                 int start, int t_out, int run, unsigned n_runs) {
  const zen_runs::Unit u = zen_runs::unit_of(run, n_runs);
  if (u.col >= f) return;
  const T* src = x + (static_cast<size_t>(u.c) * t + start + u.i0) * f + u.col;
  const int rows = min(run, t_out - u.i0);
  T* dst = out + (static_cast<size_t>(u.c) * t_out + u.i0) * f + u.col;
#pragma unroll 8
  for (int i = 0; i < rows; ++i) {
    dst[static_cast<long long>(i) * f] = src[static_cast<long long>(i) * f];
  }
}

// segment_copy at a K of K2's network route
template <typename T>
__global__ void __launch_bounds__(zen_segment::kNetworkThreads)
segment_copy_values_kernel(const T* __restrict__ x, T* __restrict__ out,
                           int f, int k, int chunk, int mode) {
  // raw bytes: a __shared__ array of a class type may not be constructed
  __shared__ __align__(16) unsigned char
      seg_bytes[(zen_segment::kNetworkChunk + ZEN_SELECT_FREQ_MAX_TAPS - 1) * sizeof(T)];
  T* seg = reinterpret_cast<T*>(seg_bytes);
  const size_t r = blockIdx.x;
  const int j0 = blockIdx.y * chunk;
  const int live = min(chunk, f - j0);
  const int m = (k - 1) / 2;
  zen_segment::stage_values(seg, x + r * f, j0 - m, live + k - 1, f, mode,
                            threadIdx.x);
  __syncthreads();
  T* dst = out + r * f + j0;
  for (int j = threadIdx.x; j < live; j += zen_segment::kNetworkThreads) {
    dst[j] = seg[j + m];
  }
}

// segment_copy at a K of K2's rank route
template <typename T>
__global__ void segment_copy_kernel(const T* __restrict__ x,
                                    T* __restrict__ out, int f, int k,
                                    int mode) {
  extern __shared__ __align__(16) unsigned long long keys[];
  const int tile = blockDim.x;
  const long long r = blockIdx.x;
  const int j0 = blockIdx.y * tile;
  const int m = (k - 1) / 2;
  const T* row = x + static_cast<size_t>(r) * f;
  const int live = min(tile, f - j0);
  zen_segment::stage_keys(keys, row, j0 - m, live + k - 1, f, mode,
                          threadIdx.x, tile);
  __syncthreads();
  const int j = threadIdx.x;
  if (j >= live) return;
  out[static_cast<size_t>(r) * f + j0 + j] =
      zen_rank::from_float<T>(zen_rank::value_of(keys[j + m]));
}

// `run`: the output rows a thread takes, the wrapper's K1 run
template <typename T>
int launch_rows(const T* x, T* out, int c, int t, int f, int start, int t_out,
                int run, void* stream) {
  if (c <= 0 || f <= 0 || t_out <= 0 || start < 0 || start + t_out > t ||
      run < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  dim3 grid;
  unsigned n_runs = 0;
  if (!zen_runs::grid_of(c, t_out, f, run, &grid, &n_runs)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  rows_copy_kernel<T><<<grid, zen_runs::kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      x, out, t, f, start, t_out, run, n_runs);
  return static_cast<int>(cudaGetLastError());
}

int check_segment(int rows, int f, int k, int mode) {
  if (k < 1 || k % 2 == 0 || rows <= 0 || f <= 0 ||
      mode < zen_segment::kReflect || mode > zen_segment::kEdge ||
      (mode == zen_segment::kReflect && (k - 1) / 2 > f - 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

template <typename T>
int launch_segment_values(const T* x, T* out, int rows, int f, int k, int mode,
                          void* stream) {
  const int err = check_segment(rows, f, k, mode);
  if (err != 0) return err;
  if (k > ZEN_SELECT_FREQ_MAX_TAPS) return static_cast<int>(cudaErrorInvalidValue);
  const int chunk = zen_segment::network_chunk(f);
  const dim3 grid(static_cast<unsigned>(rows),
                  static_cast<unsigned>((f + chunk - 1) / chunk));
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  segment_copy_values_kernel<T><<<grid, zen_segment::kNetworkThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      x, out, f, k, chunk, mode);
  return static_cast<int>(cudaGetLastError());
}

// `tile` in {32, 64, 128, 256}: the wrapper's freq_rank_tile(k)
template <typename T>
int launch_segment(const T* x, T* out, int rows, int f, int k, int mode,
                   int tile, void* stream) {
  if (check_segment(rows, f, k, mode) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (tile != 32 && tile != 64 && tile != 128 && tile != 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(zen_rank::key_count(tile + k - 1)) *
                      sizeof(unsigned long long);
  const int err = zen_rank::opt_in(
      reinterpret_cast<const void*>(segment_copy_kernel<T>), smem);
  if (err != 0) return err;
  const dim3 grid(static_cast<unsigned>(rows),
                  static_cast<unsigned>((f + tile - 1) / tile));
  segment_copy_kernel<T><<<grid, tile, smem, static_cast<cudaStream_t>(stream)>>>(
      x, out, f, k, mode);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int zen_rows_copy(const float* x, float* out, int c, int t, int f,
                             int start, int t_out, int run, void* stream) {
  return launch_rows(x, out, c, t, f, start, t_out, run, stream);
}

extern "C" int zen_rows_copy_bf16(const __nv_bfloat16* x, __nv_bfloat16* out,
                                  int c, int t, int f, int start, int t_out,
                                  int run, void* stream) {
  return launch_rows(x, out, c, t, f, start, t_out, run, stream);
}

extern "C" int zen_segment_copy_values(const float* x, float* out, int rows,
                                       int f, int k, int mode, void* stream) {
  return launch_segment_values(x, out, rows, f, k, mode, stream);
}

extern "C" int zen_segment_copy_values_bf16(const __nv_bfloat16* x,
                                            __nv_bfloat16* out, int rows,
                                            int f, int k, int mode,
                                            void* stream) {
  return launch_segment_values(x, out, rows, f, k, mode, stream);
}

extern "C" int zen_segment_copy(const float* x, float* out, int rows, int f,
                                int k, int mode, int tile, void* stream) {
  return launch_segment(x, out, rows, f, k, mode, tile, stream);
}

extern "C" int zen_segment_copy_bf16(const __nv_bfloat16* x,
                                     __nv_bfloat16* out, int rows, int f,
                                     int k, int mode, int tile, void* stream) {
  return launch_segment(x, out, rows, f, k, mode, tile, stream);
}
