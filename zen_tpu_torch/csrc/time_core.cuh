// K1's shared core (see median_time_core.cu): the kernel, and the switch
// over the shapes one compile part launches. Each of the ZEN_CORE_PARTS
// sources median_time_core_p<q>.cu expands ZEN_CORE_DEFINE_PART(q) for
// the shapes select_network.core_part assigns it, so that nvcc compiles
// the parts at once (one nvcc a source).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "rank_select.cuh"
#include "time_runs.cuh"
#include "zen_core.cuh"

namespace zen_core {

// each tap run's first offset, relative to the thread's first output row
struct Firsts {
  int first[ZEN_CORE_MAX_TAP_RUNS];
};

template <typename T, int ID>
__global__ void __launch_bounds__(zen_runs::kThreads)
tap_median_time_core_kernel(const T* __restrict__ a, const T* __restrict__ b,
                            T* __restrict__ out, int ta, int tb, int f,
                            int start, int t_out, unsigned n_runs, float fill,
                            const __grid_constant__ Firsts firsts) {
  using S = Shape<ID>;
  const zen_runs::Unit u = zen_runs::unit_of(S::kR, n_runs);
  if (u.col >= f) return;
  const T* pa = a + static_cast<size_t>(u.c) * ta * f + u.col;
  const T* pb = b + static_cast<size_t>(u.c) * tb * f + u.col;
  const int row0 = start + u.i0;
  const float fill_f = zen_rank::to_float(zen_rank::from_float<T>(fill));
  float v[S::kStaged];
  // every load is independent and predicated, so they are in flight together
  S::stage(v, [&](int j, int p) {
    const int r = row0 + firsts.first[j] + p;
    const bool in_a = r >= 0 && r < ta;
    const bool in_b = r >= ta && r < ta + tb;
    const T* src = in_a ? pa + static_cast<long long>(r) * f
                        : pb + static_cast<long long>(in_b ? r - ta : 0) * f;
    return (in_a || in_b) ? zen_rank::to_float(*src) : fill_f;
  });
  float m[S::kR];
  S::medians(v, m);
  T* dst = out + (static_cast<size_t>(u.c) * t_out + u.i0) * f + u.col;
#pragma unroll
  for (int i = 0; i < S::kR; ++i) {
    if (u.i0 + i < t_out) dst[static_cast<long long>(i) * f] = zen_rank::from_float<T>(m[i]);
  }
}

// launch shape `shape` of part q: the kernel's error code, or
// cudaErrorInvalidValue where the shape is not q's, its K is not `k`, its
// tap runs are not `tap_runs` or the grid passes the launch limits
template <typename T>
using PartLaunch = int (*)(const T* a, const T* b, T* out, int c, int ta,
                           int tb, int f, int start, int t_out,
                           const Firsts& firsts, int tap_runs, int shape,
                           int k, float fill, cudaStream_t s);

#define ZEN_CORE_CASE(ID)                                                     \
  case ID: {                                                                  \
    using S = Shape<ID>;                                                      \
    dim3 grid;                                                                \
    unsigned n_runs = 0;                                                      \
    if (k != S::kK || tap_runs != S::kTapRuns ||                              \
        !zen_runs::grid_of(c, t_out, f, S::kR, &grid, &n_runs)) {             \
      return static_cast<int>(cudaErrorInvalidValue);                         \
    }                                                                         \
    tap_median_time_core_kernel<T, ID><<<grid, zen_runs::kThreads, 0, s>>>(   \
        a, b, out, ta, tb, f, start, t_out, n_runs, fill, firsts);            \
    return static_cast<int>(cudaGetLastError());                              \
  }

#define ZEN_CORE_DEFINE_PART(Q)                                               \
  template <typename T>                                                       \
  int launch_part_##Q(const T* a, const T* b, T* out, int c, int ta, int tb,  \
                      int f, int start, int t_out, const Firsts& firsts,      \
                      int tap_runs, int shape, int k, float fill,             \
                      cudaStream_t s) {                                       \
    switch (shape) {                                                          \
      ZEN_CORE_FOR_EACH_SHAPE_OF_PART_##Q(ZEN_CORE_CASE)                      \
      default:                                                                \
        return static_cast<int>(cudaErrorInvalidValue);                       \
    }                                                                         \
  }                                                                           \
  template int launch_part_##Q<float>(                                        \
      const float*, const float*, float*, int, int, int, int, int, int,       \
      const Firsts&, int, int, int, float, cudaStream_t);                     \
  template int launch_part_##Q<__nv_bfloat16>(                                \
      const __nv_bfloat16*, const __nv_bfloat16*, __nv_bfloat16*, int, int,   \
      int, int, int, int, const Firsts&, int, int, int, float, cudaStream_t);

#define ZEN_CORE_DECLARE_PART(Q)                                              \
  template <typename T>                                                       \
  int launch_part_##Q(const T* a, const T* b, T* out, int c, int ta, int tb,  \
                      int f, int start, int t_out, const Firsts& firsts,      \
                      int tap_runs, int shape, int k, float fill,             \
                      cudaStream_t s);

}  // namespace zen_core
