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
// What bounds it on this card: at small K the min/max operations of the
// selection (66 an output at K = 13, which run at half the FP32 rate), at
// large K the block's sort; never the bytes. Two routes, chosen by the
// wrapper (ops/median_cuda.py, freq_route) from K alone; both pick
// sorted[(K-1)/2], the element jnp.median picks for odd K.
//
// `network`, K up to ZEN_SELECT_FREQ_MAX_TAPS (the hop-256 fleet's K = 13).
// A first version took these K through the rank route below: one-warp
// blocks, 8-byte keys, a 64-key sort and a walk for what a few dozen
// min/max select; its staging alone was 64% of the kernel and six times
// a plain copy of the rows. Here a block of 128 threads takes one row,
// or an even share of a long one (row_segment.cuh, network_chunk: 513
// bins are one block, no sliver tiles), stages its segment in the
// input's own type (4 or 2 bytes a sample, consecutive threads on
// consecutive samples, the boundary rule paid on the halo only), syncs
// once, and each thread then strides over the outputs: K consecutive
// words from shared memory (consecutive threads on consecutive words:
// no bank conflicts) into registers, and the comparator network
// zen_select::median<K> (generated by ops/select_network.py) on them.
// Device memory is read once and written once; the padded copy, the
// transposes and the un-pad slice of the JAX routes never exist. Rows
// and the ragged end are masked here, so any row count is valid (the
// Pallas fused kernel needed R % 128 == 0). The route's second kernel,
// the shared core for runs of outputs whose windows overlap, is in
// median_freq_core.cu; the wrapper picks one of the two a call
// (median_cuda.freq_network_form).
//
// `rank`, from FREQ_RANK_MIN_TAPS on, at every K: rank once, select many
// (rank_select.cuh). A network grows as ~K log^2 K min/max per output;
// the rank route stages the segment as 64-bit keys, sorts it once per
// block by (value, position), and finds each output's rank in the sorted
// keys, counting positions p of its window (p - j < K, unsigned) until the
// count passes (K-1)/2. Where the keys fit the 227 KB a block can opt
// into (S <= 16,384, K up to 16,353 at the smallest tile) they stay in
// shared memory, and the wrapper weighs two kernels on the call's
// geometry (median_cuda.freq_rank_plan, priced by sort_us, fitted to
// benches/rank_geometry.py's times on an H100):
// * rank_select_median_kernel, the walk (the first design): a thread an
//   output, 32 to 256 a block, each walking from rank 0, ~S/2 ranks for S
//   = tile + K - 1, eight a step, all lanes of a warp on one rank (a
//   broadcast); the bitonic sort. The few blocks of a single stream's step (hop 1024's
//   32 rows at K = 47, pitch-track's 8 at K = 187) finish soonest so.
// * rank_steps_median_kernel, the steps: a thread a run of consecutive
//   outputs, the first sought from the middle rank (its count below off
//   one scan of the inverse ranks), each next stepped from the
//   previous output's rank, its count moved by the sample that left and
//   the one that entered the window (read at their ranks in an inverse
//   array, one scatter after the sort): ~S/K ranks an output, so a tile
//   grows to the key count the sort is paid for (320 outputs at K = 187:
//   64 threads of 5, 506 keys of 512). The medians go through shared
//   memory so that the writes stay coalesced. On the 4-minute track's
//   pass 1 (2585 rows of 8193 at K = 187) the walk took 1724 us
//   (benches/rank_store.py) and the steps 729 with merge_sort
//   (benches/rank_split.py) on an H100. The steps now sort with
//   warp_merge_sort (rank_select.cuh), whose warps sort slices of 256
//   keys in registers, so a block's threads need not follow its merge
//   runs: its warps serve its walkers, at least a thread a merge run of
//   8 keys (687-692 us on that pass, H100 80GB HBM3 at 700 W).
// Past 16,384 keys the sort would no longer fit a block: a first version
// ranked each window by counting there (up to 2 K^2 compares an output,
// 2.7e8 at K = 16,385). Now the keys live in the block's slice of a
// device-memory scratch (the key store of rank_select.cuh): a persistent
// grid of at most one block an SM, kStoreThreads threads a block and as
// many outputs a unit, sorts them through a 128 KB chunk of shared memory
// (the bitonic network, its strides from a chunk up as passes over the
// slice), and walks the slice through the cache. The scratch, sized by
// the grid, bounds K (median_cuda.MAX_FREQ_TAPS). The store stays for
// calls whose units of 1024 outputs share a sort (R=4 rows of 8193 at K =
// 16,385).
//
// `select`, where the call's outputs are too few to share a sort
// (median_cuda.freq_rank_pick weighs the two on the call's geometry: a
// pre-padded row of 58,112 samples at K = 57,857 has 256 outputs, a
// 64-sample row under wrap at K = 2,096,129 has 64): a block takes a row
// and a tile of outputs (one, where the call has few), stages the
// positions its windows reach as 4-byte order bits (in shared memory
// where they fit, else read through L2 on each pass) and selects each
// output alone by its digits (radix_select.cuh), a position counted
// once where it lies in the output's window. Where the tile's positions
// outnumber the row's samples (K past F under wrap or edge, or near 2F
// under reflect) it stages the row's F samples instead, each counted as
// often as the border repeats it in the output's window (row_count): a
// window never stages 2 M positions of 64 samples.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "radix_select.cuh"
#include "rank_select.cuh"
#include "row_segment.cuh"
#include "zen_select.cuh"

namespace {

using zen_segment::check_args;
using zen_segment::kReflect;
using zen_segment::kValid;
using zen_rank::from_float;
using zen_rank::to_float;

// One block per (row, chunk of `chunk` outputs), kNetworkThreads threads
// striding over the chunk's outputs.
template <typename T, int K>
__global__ void __launch_bounds__(zen_segment::kNetworkThreads)
network_median_kernel(const T* __restrict__ x, T* __restrict__ out, int f_in,
                      int f_out, int chunk, int mode) {
  // raw bytes: a __shared__ array of a class type may not be constructed
  __shared__ __align__(16) unsigned char
      seg_bytes[(zen_segment::kNetworkChunk + ZEN_SELECT_FREQ_MAX_TAPS - 1) * sizeof(T)];
  T* seg = reinterpret_cast<T*>(seg_bytes);
  const size_t r = blockIdx.x;
  const int j0 = blockIdx.y * chunk;
  const int live = min(chunk, f_out - j0);
  const int base = mode == kValid ? j0 : j0 - (K - 1) / 2;
  zen_segment::stage_values(seg, x + r * f_in, base, live + K - 1, f_in, mode,
                            threadIdx.x);
  __syncthreads();
  T* dst = out + r * f_out + j0;
  for (int j = threadIdx.x; j < live; j += zen_segment::kNetworkThreads) {
    float v[K];
#pragma unroll
    for (int q = 0; q < K; ++q) v[q] = to_float(seg[j + q]);
    dst[j] = from_float<T>(zen_select::median<K>(v));
  }
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

// One block per (row, tile of `tile` outputs), a run of `run` consecutive
// outputs a thread (tile / run threads walk, of blockDim.x, which all
// stage and sort): the first sought from the middle rank (seek, its count
// below from prefix_below), each next stepped from the previous one's
// rank; the keys sorted by warp_merge_sort, the registers capped at 64 a
// thread (launch bounds, at most kWarpStepsThreads threads a block).
// Shared memory: merge_room(n) keys (the keys as staged, then the
// sort's), as many again where sort_spare, then the rank of each
// staged position (inv, tile + k - 1 ints), the tile's medians (res, as
// floats, written out together at the end), the count below the middle
// rank before each position (tile + k ints) and the scan's warp sums (32).
constexpr int kWarpStepsThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kWarpStepsThreads, 4)
rank_steps_median_kernel(const T* __restrict__ x, T* __restrict__ out, int f_in, int f_out,
                         int k, int mode, int tile, int run) {
  extern __shared__ __align__(16) unsigned long long keys[];
  const int threads = blockDim.x;
  const int tid = threadIdx.x;
  const long long r = blockIdx.x;
  const int j0 = blockIdx.y * tile;
  const int m = (k - 1) / 2;
  const T* row = x + static_cast<size_t>(r) * f_in;
  const int base = mode == kValid ? j0 : j0 - m;
  const int live = min(tile, f_out - j0);
  const int staged = live + k - 1;
  const int n = zen_segment::stage_keys(keys, row, base, staged, f_in, mode,
                                        tid, threads);
  // the sort's buffers: the keys' and, where sort_spare, a second
  const int most = zen_rank::key_count(tile + k - 1);
  const int room = zen_rank::merge_room(most);
  int* inv = reinterpret_cast<int*>(
      keys + room * (zen_rank::sort_spare(most, threads) ? 2 : 1));
  float* res = reinterpret_cast<float*>(inv + tile + k - 1);
  int* prefix = reinterpret_cast<int*>(res + tile);
  int* warp_sums = prefix + tile + k;
  __syncthreads();
  T* dst = out + static_cast<size_t>(r) * f_out + j0;
  if (ZEN_RANK_CUT == 1) {
    for (int j = tid; j < live; j += threads) {
      dst[j] = from_float<T>(zen_rank::value_of(keys[j]));
    }
    return;
  }
  const unsigned long long* sorted = zen_rank::warp_merge_sort(keys, 0, room, 1, n, tid, threads);
  const auto key = [&](int rank) { return sorted[rank]; };
  if (ZEN_RANK_CUT == 2) {
    for (int j = tid; j < live; j += threads) {
      dst[j] = from_float<T>(zen_rank::value_of(key(j)));
    }
    return;
  }
  // one scatter: the rank of each staged position
  for (int q = tid; q < staged; q += threads) {
    inv[zen_rank::position_of(key(q))] = q;
  }
  __syncthreads();
  const int pivot = staged / 2;
  zen_rank::prefix_below(prefix, inv, staged, pivot, tid, threads, warp_sums);
  const int first = tid * run;
  const int last = min(first + run, live);
  int j = first;
  // positions of window [j, j + k) (a padding key's is past every window)
  const auto in_window = [&](unsigned long long kv) {
    return static_cast<int>(static_cast<unsigned>(zen_rank::position_of(kv) - j) <
                            static_cast<unsigned>(k));
  };
  if (j < last) {
    int at = pivot, below = prefix[j + k] - prefix[j];
    res[j] = zen_rank::value_of(zen_rank::seek(key, m, in_window, &at, &below, n));
    for (++j; j < last; ++j) {
      // position j - 1 left the window, j + k - 1 entered it
      below += static_cast<int>(inv[j + k - 1] < at) - static_cast<int>(inv[j - 1] < at);
      res[j] = zen_rank::value_of(zen_rank::step(key, m, in_window, &at, &below));
    }
  }
  __syncthreads();
  for (int q = tid; q < live; q += threads) dst[q] = from_float<T>(res[q]);
}

// The rank route on the key store: a persistent grid whose block b walks
// the units (row, tile of kStoreThreads outputs) b, b + gridDim.x, ...,
// staging each unit's keys in its own slice of `scratch` (`slice` keys),
// sorting them through `len` keys of shared memory, one thread an output.
template <typename T>
__global__ void __launch_bounds__(zen_rank::kStoreThreads)
rank_store_median_kernel(const T* __restrict__ x, T* __restrict__ out,
                         int rows, int f_in, int f_out, int k, int mode,
                         unsigned long long* __restrict__ scratch, int slice,
                         int len) {
  extern __shared__ __align__(16) unsigned long long chunk[];
  constexpr int tile = zen_rank::kStoreThreads;
  unsigned long long* keys = scratch + static_cast<size_t>(blockIdx.x) * slice;
  const int tiles = (f_out + tile - 1) / tile;
  const long long units = static_cast<long long>(rows) * tiles;
  const int m = (k - 1) / 2;
  const int j = threadIdx.x;
  for (long long unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const long long r = unit / tiles;
    const int j0 = static_cast<int>(unit % tiles) * tile;
    const T* row = x + static_cast<size_t>(r) * f_in;
    const int base = mode == kValid ? j0 : j0 - m;
    const int live = min(tile, f_out - j0);
    const int n = zen_segment::stage_keys(keys, row, base, live + k - 1, f_in,
                                          mode, j, tile);
    __syncthreads();
    if (ZEN_RANK_CUT != 1) zen_rank::sort_store(keys, n, chunk, len, j, tile);
    if (j < live) {
      // as the shared route: positions of window [j, j + k) until m + 1
      const unsigned long long key =
          ZEN_RANK_CUT != 0
              ? keys[j]
              : zen_rank::walk(keys, m, [&](unsigned long long kv) {
                  return static_cast<int>(
                      static_cast<unsigned>(zen_rank::position_of(kv) - j) <
                      static_cast<unsigned>(k));
                });
      out[static_cast<size_t>(r) * f_out + j0 + j] =
          from_float<T>(zen_rank::value_of(key));
    }
    __syncthreads();  // the next unit restages the slice
  }
}

// floor(a / b) for b > 0
__device__ __forceinline__ long long floor_div(long long a, long long b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// How many positions p in [lo, hi] the border maps to sample s of a row
// of f (boundary_index's preimages; reflect's lie in [-(f - 1), 2(f -
// 1)], the window's reach when (K - 1) / 2 <= f - 1)
__device__ __forceinline__ int row_count(int s, int lo, int hi, int f, int mode) {
  const auto in = [&](long long p) { return lo <= p && p <= hi ? 1 : 0; };
  if (mode == zen_segment::kWrap) {
    return static_cast<int>(floor_div(static_cast<long long>(hi) - s, f) -
                            floor_div(static_cast<long long>(lo) - 1 - s, f));
  }
  if (mode == zen_segment::kEdge) {
    if (f == 1) return hi - lo + 1;
    if (s == 0) return max(0, min(hi, 0) - lo + 1);
    if (s == f - 1) return max(0, hi - max(lo, f - 1) + 1);
    return in(s);
  }
  // reflect: s, -s and 2 (f - 1) - s, each once
  return in(s) + (s > 0 ? in(-s) : 0) + (s < f - 1 ? in(2LL * (f - 1) - s) : 0);
}

// The select route: one block per (row, tile of `tile` outputs), output
// j of the tile selected by zen_pick::select over the staged samples.
// Positions base .. base + live + k - 2, each counted by the windows it
// lies in, or (`whole`: they outnumber the row's f_in samples) the row's
// samples, each counted row_count times. kShared: the staged order bits
// in shared memory (room for `stage_len`, the most a block stages),
// otherwise each pass reads the row through L2; kHist: the threads' bins
// in shared memory after them (zen_pick::layout).
template <typename T, bool kShared, bool kHist>
__global__ void __launch_bounds__(zen_pick::kMaxThreads)
select_median_kernel(const T* __restrict__ x, T* __restrict__ out, int f_in,
                     int f_out, int k, int mode, int tile, int stage_len) {
  extern __shared__ __align__(16) unsigned int bits[];
  __shared__ zen_pick::Shared sh;
  int* hist = kHist ? reinterpret_cast<int*>(bits + (kShared ? stage_len : 0)) : nullptr;
  const long long r = blockIdx.x;
  const int j0 = blockIdx.y * tile;
  const int m = (k - 1) / 2;
  const T* row = x + static_cast<size_t>(r) * f_in;
  const int live = min(tile, f_out - j0);
  const long long need = static_cast<long long>(live) + k - 1;
  const bool whole = need > f_in;
  const int n = whole ? f_in : static_cast<int>(need);
  const int base = mode == kValid ? j0 : j0 - m;
  const auto load = [&](int e) {
    const int p = whole ? e : zen_segment::boundary_index(base + e, f_in, mode);
    return zen_rank::order_bits(to_float(row[p]));
  };
  zen_pick::begin(&sh, hist);
  __syncthreads();
  if (kShared) {
    unsigned int lo = ~0u, hi = 0u;
#pragma unroll 4
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const unsigned int o = load(e);
      bits[e] = o;
      lo = min(lo, o);
      hi = max(hi, o);
    }
    zen_pick::stage_range(&sh, lo, hi);
  }
  __syncthreads();
  int tick = 0;
  for (int jl = 0; jl < live; ++jl) {
    const int j = j0 + jl;
    const unsigned int key = zen_pick::select<kHist>(
        n, m, [&](int e) { return kShared ? bits[e] : load(e); },
        [&](int e) {
          return whole ? row_count(e, j - m, j + m, f_in, mode)
                       : static_cast<int>(static_cast<unsigned>(e - jl) <
                                          static_cast<unsigned>(k));
        },
        &sh, hist, tick);
    if (threadIdx.x == 0) {
      out[static_cast<size_t>(r) * f_out + j] =
          from_float<T>(zen_rank::value_of_bits(key));
    }
  }
}

template <typename T>
int launch_network(const T* x, T* out, int rows, int f_in, int f_out, int k,
                   int mode, void* stream) {
  const int err = check_args(rows, f_in, f_out, k, mode);
  if (err != 0) return err;
  const int chunk = zen_segment::network_chunk(f_out);
  const dim3 grid(static_cast<unsigned>(rows),
                  static_cast<unsigned>((f_out + chunk - 1) / chunk));
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
#define ZEN_NETWORK_CASE(K)                                          \
  case K:                                                            \
    network_median_kernel<T, K>                                      \
        <<<grid, zen_segment::kNetworkThreads, 0, s>>>(x, out, f_in, \
                                                       f_out, chunk, mode); \
    break;
    ZEN_SELECT_FOR_EACH_FREQ_K(ZEN_NETWORK_CASE)
#undef ZEN_NETWORK_CASE
    default:  // K above ZEN_SELECT_FREQ_MAX_TAPS
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// `tile` outputs a block, `run` outputs a walking thread and `threads` a
// block: the wrapper's choice for the call (freq_rank_plan). run 1: the
// walk from rank 0 for every output, `tile` threads in {32, 64, 128, 256};
// run > 1: the steps, tile / run walking threads of `threads`, a multiple
// of 32 up to kWarpStepsThreads.
template <typename T>
int launch_rank(const T* x, T* out, int rows, int f_in, int f_out, int k,
                int mode, int tile, int run, int threads, void* stream) {
  int err = check_args(rows, f_in, f_out, k, mode);
  if (err != 0) return err;
  if (run < 1 || tile < run || tile % run != 0 ||
      (run == 1 ? (threads != tile || (tile != 32 && tile != 64 && tile != 128 && tile != 256))
                : (threads % 32 != 0 || threads > kWarpStepsThreads || tile / run > threads))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles = (static_cast<long long>(f_out) + tile - 1) / tile;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int n = zen_rank::key_count(tile + k - 1);
  // run > 1: the sort's buffers, the inverse ranks, the tile's medians,
  // the counts below the middle rank and the scan's warp sums
  const size_t smem =
      run == 1 ? static_cast<size_t>(n) * sizeof(unsigned long long)
               : (zen_rank::sort_spare(n, threads) ? 2 : 1) *
                         static_cast<size_t>(zen_rank::merge_room(n)) *
                         sizeof(unsigned long long) +
                     (2 * (static_cast<size_t>(tile) + k) - 1 + tile + 32) * 4;
  err = zen_rank::opt_in(run == 1 ? reinterpret_cast<const void*>(rank_select_median_kernel<T>)
                                  : reinterpret_cast<const void*>(rank_steps_median_kernel<T>),
                         smem);
  if (err != 0) return err;
  const dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>(tiles));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (run == 1) {
    rank_select_median_kernel<T><<<grid, tile, smem, s>>>(x, out, f_in, f_out, k, mode);
  } else {
    rank_steps_median_kernel<T><<<grid, threads, smem, s>>>(x, out, f_in, f_out, k, mode,
                                                            tile, run);
  }
  return static_cast<int>(cudaGetLastError());
}

// `scratch` holds `blocks` slices of `slice` keys (a power of two, at
// least the keys of a unit of min(kStoreThreads, f_out) outputs: the
// wrapper's rank_store_args); `len` keys of shared memory a block (a
// power of two, 32 to kStoreChunk)
template <typename T>
int launch_rank_store(const T* x, T* out, int rows, int f_in, int f_out,
                      int k, int mode, unsigned long long* scratch,
                      int blocks, int slice, int len, void* stream) {
  int err = check_args(rows, f_in, f_out, k, mode);
  if (err != 0) return err;
  const long long staged =
      static_cast<long long>(f_out < zen_rank::kStoreThreads ? f_out
                                                             : zen_rank::kStoreThreads) +
      k - 1;
  if (scratch == nullptr || blocks < 1 || staged > (1 << 30) ||
      slice < zen_rank::key_count(static_cast<int>(staged)) ||
      (slice & (slice - 1)) != 0 || len < 32 || len > zen_rank::kStoreChunk ||
      (len & (len - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(len) * sizeof(unsigned long long);
  err = zen_rank::opt_in(
      reinterpret_cast<const void*>(rank_store_median_kernel<T>), smem);
  if (err != 0) return err;
  rank_store_median_kernel<T><<<blocks, zen_rank::kStoreThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      x, out, rows, f_in, f_out, k, mode, scratch, slice, len);
  return static_cast<int>(cudaGetLastError());
}

// `tile` outputs a block (1 to 256, the grid's second dimension at most
// 65535) and `threads` a block (a power of two, 64 to
// zen_pick::kMaxThreads): the wrapper's freq_select_plan. The staged
// order bits and the threads' bins go to shared memory as
// zen_pick::layout fits them, the bins only where `shared_bins` (the
// wrapper's select_shared_bins).
template <typename T>
int launch_select(const T* x, T* out, int rows, int f_in, int f_out, int k,
                  int mode, int tile, int threads, int shared_bins, void* stream) {
  int err = check_args(rows, f_in, f_out, k, mode);
  if (err != 0) return err;
  if (tile < 1 || tile > 256 || threads < 64 || threads > zen_pick::kMaxThreads ||
      (threads & (threads - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles = (static_cast<long long>(f_out) + tile - 1) / tile;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  int optin = 0;
  err = zen_rank::optin_bytes(&optin);
  if (err != 0) return err;
  const long long need = static_cast<long long>(min(tile, f_out)) + k - 1;
  const int stage_len = static_cast<int>(need < f_in ? need : f_in);
  const zen_pick::Layout at = zen_pick::layout(stage_len, threads, optin, shared_bins != 0);
  const auto kernel = at.shared ? (at.hist ? select_median_kernel<T, true, true>
                                           : select_median_kernel<T, true, false>)
                                : select_median_kernel<T, false, true>;
  err = zen_rank::opt_in(reinterpret_cast<const void*>(kernel), at.bytes,
                         optin - static_cast<int>(sizeof(zen_pick::Shared)));
  if (err != 0) return err;
  const dim3 grid(static_cast<unsigned>(rows), static_cast<unsigned>(tiles));
  kernel<<<grid, threads, at.bytes, static_cast<cudaStream_t>(stream)>>>(
      x, out, f_in, f_out, k, mode, tile, stage_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int zen_sliding_median_network(const float* x, float* out,
                                          int rows, int f_in, int f_out,
                                          int k, int mode, void* stream) {
  return launch_network(x, out, rows, f_in, f_out, k, mode, stream);
}

extern "C" int zen_sliding_median_network_bf16(const __nv_bfloat16* x,
                                               __nv_bfloat16* out, int rows,
                                               int f_in, int f_out, int k,
                                               int mode, void* stream) {
  return launch_network(x, out, rows, f_in, f_out, k, mode, stream);
}

extern "C" int zen_sliding_median_rank(const float* x, float* out, int rows,
                                       int f_in, int f_out, int k, int mode,
                                       int tile, int run, int threads,
                                       void* stream) {
  return launch_rank(x, out, rows, f_in, f_out, k, mode, tile, run, threads, stream);
}

extern "C" int zen_sliding_median_rank_bf16(const __nv_bfloat16* x,
                                            __nv_bfloat16* out, int rows,
                                            int f_in, int f_out, int k,
                                            int mode, int tile, int run,
                                            int threads, void* stream) {
  return launch_rank(x, out, rows, f_in, f_out, k, mode, tile, run, threads, stream);
}

extern "C" int zen_sliding_median_rank_store(
    const float* x, float* out, int rows, int f_in, int f_out, int k, int mode,
    unsigned long long* scratch, int blocks, int slice, int len, void* stream) {
  return launch_rank_store(x, out, rows, f_in, f_out, k, mode, scratch, blocks,
                           slice, len, stream);
}

extern "C" int zen_sliding_median_rank_store_bf16(
    const __nv_bfloat16* x, __nv_bfloat16* out, int rows, int f_in, int f_out,
    int k, int mode, unsigned long long* scratch, int blocks, int slice,
    int len, void* stream) {
  return launch_rank_store(x, out, rows, f_in, f_out, k, mode, scratch, blocks,
                           slice, len, stream);
}

extern "C" int zen_sliding_median_select(const float* x, float* out, int rows,
                                         int f_in, int f_out, int k, int mode,
                                         int tile, int threads, int shared_bins,
                                         void* stream) {
  return launch_select(x, out, rows, f_in, f_out, k, mode, tile, threads, shared_bins,
                       stream);
}

extern "C" int zen_sliding_median_select_bf16(const __nv_bfloat16* x,
                                              __nv_bfloat16* out, int rows,
                                              int f_in, int f_out, int k,
                                              int mode, int tile, int threads,
                                              int shared_bins, void* stream) {
  return launch_select(x, out, rows, f_in, f_out, k, mode, tile, threads, shared_bins,
                       stream);
}
