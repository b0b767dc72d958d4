// K2's shared core (see median_freq_core.cu): the kernel, and the switch
// over the shapes one compile part launches. Each of the ZEN_CORE_FREQ_PARTS
// sources median_freq_core_p<q>.cu expands ZEN_FREQ_CORE_DEFINE_PART(q) for
// the shapes select_network.freq_core_part assigns it, so that nvcc
// compiles the parts at once (one nvcc a source).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "rank_select.cuh"
#include "row_segment.cuh"
#include "zen_core.cuh"

namespace zen_freq_core {

using zen_rank::from_float;
using zen_rank::to_float;
using zen_segment::kNetworkChunk;
using zen_segment::kNetworkThreads;

// a word of B bytes, one shared-memory access
template <int B>
struct Word;
template <>
struct Word<2> { using type = unsigned short; };
template <>
struct Word<4> { using type = unsigned int; };
template <>
struct Word<8> { using type = uint2; };
template <>
struct Word<16> { using type = uint4; };

// samples of T a thread moves in one access: the largest power of two
// that divides R, at most 16 bytes
template <typename T, int R>
__host__ __device__ constexpr int word_samples() {
  int a = 1;
  while (R % (2 * a) == 0 && 2 * a * static_cast<int>(sizeof(T)) <= 16) a *= 2;
  return a;
}

// samples past a chunk's segment (and past its outputs) that the last
// run's words may reach: R - 1 outputs past the chunk's last, the loads
// rounded up to a word
constexpr int kSlack = 16;

// The row segment as the core stages it: interior positions (their row
// index inside the row) load directly, a thread's share laid out as
// load_values lays it out; the at most K - 1 halo positions (base + s < 0
// on the left, >= f_in on the right) take the border rule, one a thread
// of the first threads. No load pays for the border's index arithmetic
// unless it reads the halo.
struct Split {
  int hl, hr;  // halo positions on the left and on the right
};

__device__ __forceinline__ Split split_of(int base, int need, int f_in) {
  return {base < 0 ? -base : 0, max(0, base + need - f_in)};
}

template <typename T>
__device__ __forceinline__ void load_split(T (&held)[zen_segment::kNetworkLoads], T* halo,
                                           const T* __restrict__ row, int base, int need,
                                           int f_in, int mode, Split sp, int tid) {
#pragma unroll
  for (int u = 0; u < zen_segment::kNetworkLoads; ++u) {
    const int s = tid + u * kNetworkThreads;
    const int p = base + s;
    if (s < need && static_cast<unsigned>(p) < static_cast<unsigned>(f_in)) held[u] = row[p];
  }
  if (tid < sp.hl + sp.hr) {
    const int s = tid < sp.hl ? tid : f_in - base + tid - sp.hl;
    *halo = row[zen_segment::boundary_index(base + s, f_in, mode)];
  }
}

template <typename T>
__device__ __forceinline__ void store_split(T* seg, const T (&held)[zen_segment::kNetworkLoads],
                                            T halo, int base, int need, int f_in, Split sp,
                                            int tid) {
#pragma unroll
  for (int u = 0; u < zen_segment::kNetworkLoads; ++u) {
    const int s = tid + u * kNetworkThreads;
    if (s < need && static_cast<unsigned>(base + s) < static_cast<unsigned>(f_in)) {
      seg[s] = held[u];
    }
  }
  if (tid < sp.hl + sp.hr) seg[tid < sp.hl ? tid : f_in - base + tid - sp.hl] = halo;
}

// Block (bx, c) takes chunk c (of `chunk` outputs) of the rows bx, bx +
// gridDim.x, ..., kNetworkThreads threads striding over the chunk's runs
// of kR outputs; it issues the next row's loads before it selects this
// row's medians, so that they are in flight meanwhile.
template <typename T, int ID>
__global__ void __launch_bounds__(kNetworkThreads)
core_median_kernel(const T* __restrict__ x, T* __restrict__ out, int rows, int f_in,
                   int f_out, int chunk, int mode) {
  using S = zen_core::Shape<ID>;
  constexpr int K = S::kK, R = S::kR, N = S::kStaged;
  constexpr int A = word_samples<T, R>();
  constexpr int kWords = (N + A - 1) / A;
  using W = typename Word<A * static_cast<int>(sizeof(T))>::type;
  static_assert(S::kTapRuns == 1 && N == K + R - 1, "K2's window is one run of K samples");
  static_assert(R + A - 2 <= kSlack, "a run's words pass the slack");
  __shared__ __align__(16) unsigned char seg_bytes[(kNetworkChunk + K - 1 + kSlack) * sizeof(T)];
  __shared__ __align__(16) unsigned char res_bytes[(kNetworkChunk + kSlack) * sizeof(T)];
  T* seg = reinterpret_cast<T*>(seg_bytes);
  T* res = reinterpret_cast<T*>(res_bytes);
  const int tid = threadIdx.x;
  const int j0 = blockIdx.y * chunk;
  const int live = min(chunk, f_out - j0);
  const int need = live + K - 1;
  const int base = mode == zen_segment::kValid ? j0 : j0 - (K - 1) / 2;
  const Split sp = split_of(base, need, f_in);
  T held[zen_segment::kNetworkLoads];
  T halo;
  load_split(held, &halo, x + static_cast<size_t>(blockIdx.x) * f_in, base, need, f_in, mode,
             sp, tid);  // the grid has at most `rows` blocks a chunk
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    store_split(seg, held, halo, base, need, f_in, sp, tid);
    __syncthreads();
    if (r + gridDim.x < rows) {
      load_split(held, &halo, x + static_cast<size_t>(r + gridDim.x) * f_in, base, need, f_in,
                 mode, sp, tid);
    }
    for (int i0 = tid * R; i0 < live; i0 += kNetworkThreads * R) {
      float staged[kWords * A];
      const W* src = reinterpret_cast<const W*>(seg + i0);
#pragma unroll
      for (int w = 0; w < kWords; ++w) {
        const W word = src[w];
        const T* e = reinterpret_cast<const T*>(&word);
#pragma unroll
        for (int q = 0; q < A; ++q) staged[w * A + q] = to_float(e[q]);
      }
      float v[N];
      S::stage(v, [&](int, int p) { return staged[p]; });
      float m[R];
      S::medians(v, m);
      W* dst = reinterpret_cast<W*>(res + i0);
#pragma unroll
      for (int w = 0; w < R / A; ++w) {
        W word;
        T* e = reinterpret_cast<T*>(&word);
#pragma unroll
        for (int q = 0; q < A; ++q) e[q] = from_float<T>(m[w * A + q]);
        dst[w] = word;
      }
    }
    // the medians are in res and seg is free for the next row
    __syncthreads();
    T* dst = out + static_cast<size_t>(r) * f_out + j0;
    for (int j = tid; j < live; j += kNetworkThreads) dst[j] = res[j];
  }
}

// Blocks of ID's kernel that an SM holds at once (its registers and shared
// memory), asked once
template <typename T, int ID>
int blocks_per_sm(int* out) {
  static int per_sm = 0;
  static const int err = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, core_median_kernel<T, ID>, kNetworkThreads, 0));
  *out = per_sm;
  return err;
}

// The grid: a column of blocks a chunk, as many a column as the card
// holds at once over the chunks, at most one a row
template <typename T, int ID>
int launch_shape(const T* x, T* out, int rows, int f_in, int f_out, int chunk, int chunks,
                 int mode, cudaStream_t s) {
  int device = 0, sms = 0, per_sm = 0;
  int err = static_cast<int>(cudaGetDevice(&device));
  if (err == 0) {
    err = static_cast<int>(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device));
  }
  if (err == 0) err = blocks_per_sm<T, ID>(&per_sm);
  if (err != 0) return err;
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long most = (static_cast<long long>(sms) * per_sm + chunks - 1) / chunks;
  const dim3 grid(static_cast<unsigned>(rows < most ? rows : most), static_cast<unsigned>(chunks));
  core_median_kernel<T, ID><<<grid, kNetworkThreads, 0, s>>>(x, out, rows, f_in, f_out, chunk,
                                                             mode);
  return static_cast<int>(cudaGetLastError());
}


// what a part's launcher returns for a shape another part compiles
constexpr int kNotThisPart = -1;

// launch shape `shape` of part q at `chunk` outputs a block (`chunks` a
// row): the kernel's error code, cudaErrorInvalidValue where its K is not
// `k`, or kNotThisPart where q does not compile it
template <typename T>
using PartLaunch = int (*)(const T* x, T* out, int rows, int f_in, int f_out, int k, int mode,
                           int shape, int chunk, int chunks, cudaStream_t s);

#define ZEN_FREQ_CORE_CASE(ID)                                                          \
  case ID:                                                                              \
    if (k != zen_core::Shape<ID>::kK) return static_cast<int>(cudaErrorInvalidValue);   \
    return launch_shape<T, ID>(x, out, rows, f_in, f_out, chunk, chunks, mode, s);

#define ZEN_FREQ_CORE_DEFINE_PART(Q)                                                    \
  template <typename T>                                                                 \
  int launch_part_##Q(const T* x, T* out, int rows, int f_in, int f_out, int k, int mode, \
                      int shape, int chunk, int chunks, cudaStream_t s) {               \
    switch (shape) {                                                                    \
      ZEN_CORE_FOR_EACH_FREQ_SHAPE_OF_PART_##Q(ZEN_FREQ_CORE_CASE)                      \
      default:                                                                          \
        return kNotThisPart;                                                            \
    }                                                                                   \
  }                                                                                     \
  template int launch_part_##Q<float>(const float*, float*, int, int, int, int, int, int,  \
                                      int, int, cudaStream_t);                          \
  template int launch_part_##Q<__nv_bfloat16>(const __nv_bfloat16*, __nv_bfloat16*, int, \
                                              int, int, int, int, int, int, int,        \
                                              cudaStream_t);

#define ZEN_FREQ_CORE_DECLARE_PART(Q)                                                   \
  template <typename T>                                                                 \
  int launch_part_##Q(const T* x, T* out, int rows, int f_in, int f_out, int k, int mode, \
                      int shape, int chunk, int chunks, cudaStream_t s);

}  // namespace zen_freq_core
