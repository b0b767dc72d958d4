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
// sorted[(K-1)/2], the element jnp.median picks for odd K. A selection
// network or an incremental window is later work. Rows and the ragged
// last tile are masked here, so any row count is valid (the Pallas fused
// kernel needed R % 128 == 0).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTile = 256;

enum Mode { kReflect = 0, kWrap = 1, kEdge = 2, kValid = 3 };

__device__ __forceinline__ int boundary_index(int p, int f, int mode) {
  if (mode == kReflect) {
    p = p < 0 ? -p : p;
    const int q = 2 * (f - 1) - p;
    return p < q ? p : q;
  }
  if (mode == kWrap) {
    p %= f;
    return p < 0 ? p + f : p;
  }
  if (mode == kEdge) return p < 0 ? 0 : (p > f - 1 ? f - 1 : p);
  return p;  // valid: always inside the padded row
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

template <typename T>
int launch(const T* x, T* out, int rows, int f_in, int f_out, int k, int mode,
           void* stream) {
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
  // the row segment must fit the shared memory a block may opt into
  // (227 KB on Hopper); above the 48 KB default, opt in
  const size_t smem = (static_cast<size_t>(kTile) + k - 1) * sizeof(T);
  int device = 0;
  int optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem > static_cast<size_t>(optin)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(sliding_median_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(rows),
                  static_cast<unsigned>((f_out + kTile - 1) / kTile));
  sliding_median_kernel<T><<<grid, kTile, smem,
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
