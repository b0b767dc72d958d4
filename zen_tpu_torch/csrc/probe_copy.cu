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
// port's kernels walk the data differently (K1 is a thread per output;
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
// * rows_copy has K1 register's launch geometry and index arithmetic
//   (csrc/median_time.cu, tap_median_time_kernel): 256 threads a block,
//   one thread per output with f fastest, the same 64-bit idx % f and
//   rest / t_out, and one load where K1 makes K.
// * segment_copy has K2 rank's grid and staging (csrc/median_freq.cu,
//   rank_select_median_kernel): one block per (row, tile of outputs) with
//   `tile` = the wrapper's freq_rank_tile(k) threads, the key_count(tile +
//   k - 1) 64-bit keys in dynamic shared memory with the opt-in, built by
//   the same zen_segment::stage_keys; then a sync, and each output writes
//   the value of the key at its own position (no sort, no walk).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "rank_select.cuh"
#include "row_segment.cuh"

namespace {

template <typename T>
__global__ void rows_copy_kernel(const T* __restrict__ x, T* __restrict__ out,
                                 int t, int f, int start, int t_out,
                                 long long n) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int col = static_cast<int>(idx % f);
  const long long rest = idx / f;
  const int i = static_cast<int>(rest % t_out);
  const long long c = rest / t_out;
  out[idx] = x[(static_cast<size_t>(c) * t + start + i) * f + col];
}

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

template <typename T>
int launch_rows(const T* x, T* out, int c, int t, int f, int start, int t_out,
                void* stream) {
  if (c <= 0 || f <= 0 || t_out <= 0 || start < 0 || start + t_out > t) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = static_cast<long long>(c) * t_out * f;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((n + threads - 1) / threads);
  rows_copy_kernel<T><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, t, f, start, t_out, n);
  return static_cast<int>(cudaGetLastError());
}

// `tile` in {32, 64, 128, 256}: the wrapper's freq_rank_tile(k)
template <typename T>
int launch_segment(const T* x, T* out, int rows, int f, int k, int mode,
                   int tile, void* stream) {
  if (k < 1 || k % 2 == 0 || rows <= 0 || f <= 0 ||
      mode < zen_segment::kReflect || mode > zen_segment::kEdge ||
      (mode == zen_segment::kReflect && (k - 1) / 2 > f - 1)) {
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
                             int start, int t_out, void* stream) {
  return launch_rows(x, out, c, t, f, start, t_out, stream);
}

extern "C" int zen_rows_copy_bf16(const __nv_bfloat16* x, __nv_bfloat16* out,
                                  int c, int t, int f, int start, int t_out,
                                  void* stream) {
  return launch_rows(x, out, c, t, f, start, t_out, stream);
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
