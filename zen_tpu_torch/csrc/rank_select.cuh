// Rank once, select many: the device code that K1's and K2's large-K
// routes share (csrc/median_time.cu, csrc/median_freq.cu).
//
// A block stages the samples its outputs' windows reach, once, as 64-bit
// keys: the value's order bits above, its staged position below. One sort
// of the keys orders the staged samples by (value, position). An output's
// median is the key at the first rank where the count of positions in
// its own window (with their multiplicity, where taps repeat) passes
// (K - 1) / 2: sorted(window)[(K - 1) / 2], the element rank-by-counting
// and torch.kthvalue pick. Two ways to that rank:
// * walk (the first design): every output walks the ranks upward
//   from rank 0, ~S/2 reads for S staged samples, all lanes of a warp on
//   one rank (a broadcast). The sort is bitonic_sort. A block then has
//   as many outputs as threads (K2: 32 to 256), since the walk grows with
//   S: its sort is shared by few outputs.
// * steps: a thread takes a run of consecutive outputs. The first walks
//   from rank 0 (K1: walk_from_zero) or, in K2, starts from the middle
//   rank, its count below read off one scan of the inverse ranks
//   (prefix_below), and seeks its median (seek): about as many ranks as
//   its window's median lies from the block's, not S/2; each next starts
//   from the previous
//   output's rank, moves the count below it by the samples that left and
//   entered the window, found at their ranks in an inverse array (one
//   scatter after the sort), and steps down or up to the rank that holds
//   its median (step): about S/K ranks, as neighbouring windows differ by
//   a sample each way. So a block's tile can grow until the sort is paid
//   by hundreds of outputs, and the sort is merge_sort: runs of 8 sorted
//   in registers, then passes that merge pairs of runs along their merge
//   path, in a layout that keeps a warp's lanes on distinct banks (the
//   last pass writes the keys plainly).
// The wrappers' cost rule picks the way and the geometry for each call
// (ops/median_cuda.py, sort_us): calls of few outputs a block (a single
// stream's hop-32 and hop-1024 steps) keep the walk, whose blocks finish
// sooner; calls of many (offline passes, median2d) take the steps.
// Per output the bitonic sort costs O(log^2 S) compare-swaps a staged
// sample, merge_sort O(log S) moves; both stay far below the up to K^2
// compares of ranking each window by counting. Each kernel keeps the sort
// that ran faster in it (benches/rank_split.py, the same kernels built
// with the other sort, on an H100): in the steps merge_sort (805 against
// 839 us on the 4-minute pass 1, 868 against 923 on median2d's fl 93,
// both while its last pass still wrote merge_index's layout), in
// the walk bitonic_sort (10.2 against 14.0 us on hop 32's K1 step, 9.3
// against 13.6 on hop 1024's K2 step, where a block sorts 128-256 keys).
//
// Two stores for the keys. The shared store sorts them in shared memory,
// up to the 227 KB a block can opt into: 16,384 keys of 8 bytes, as a
// power of two (the steps take the inverse and, where a thread merges
// more than one run, a second buffer, so they stop sooner). Past that
// K2's keys live in the block's slice of a device-memory scratch that
// the wrapper allocates, sized by
// the grid (a persistent grid of at most one block an SM walks the
// units), and sort_store sorts them: each chunk of kStoreChunk keys in
// shared memory, the stages' strides from a chunk up as passes over the
// slice, the strides below a chunk in shared memory again. It is the same
// bitonic network, so the keys end in the same order; the walk then reads
// the slice through the cache. K2 takes the store only where a unit's
// 1024 outputs share its sort; calls with few outputs, and every K1 call
// whose keys pass shared memory, take the select route instead
// (radix_select.cuh), which sorts nothing.
//
// Exactness: the key order is the float order, except that -0.0 sorts
// below +0.0 and NaN does not arise (both kernels take magnitudes, from
// abs()), so the selected value is the one a float-compare selection
// picks; between -0.0 and +0.0 the two could differ in the sign bit.
//
// ZEN_RANK_CUT splits a rank block's time (chip_smoke.py phase 3 builds
// the library twice more with it): 1 ends the rank kernels after
// staging, 2 after the sort, each storing a staged key per output so the
// work before stays; the cut kernels' outputs are not medians. 0, the
// default, builds the full kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#ifndef ZEN_RANK_CUT
#define ZEN_RANK_CUT 0
#endif

namespace zen_rank {

// the shared memory a block of the current device may opt into (227 KB
// on Hopper), into *bytes
inline int optin_bytes(int* bytes) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  return static_cast<int>(err);
}

// `smem` bytes of dynamic shared memory for `kernel`: refused past
// `optin` (optin_bytes), opted into above the 48 KB default
inline int opt_in(const void* kernel, size_t smem, int optin) {
  if (smem > static_cast<size_t>(optin)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  }
  return static_cast<int>(err);
}

// the same, querying the current device's limit
inline int opt_in(const void* kernel, size_t smem) {
  int optin = 0;
  const int got = optin_bytes(&optin);
  return got != 0 ? got : opt_in(kernel, smem, optin);
}

// The element types of both kernels: a bf16 converts to float exactly,
// so float compares rank the same elements, and a selected value
// converts back to the same bf16 bits.
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
// exact: x is always a converted bf16 tap or the bf16-rounded fill
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// a key above every staged sample: the padding up to a power of two
constexpr unsigned long long kPadKey = ~0ull;

// unsigned order of the result == float order of x (-0.0 < +0.0)
__device__ __forceinline__ unsigned int order_bits(float x) {
  const unsigned int u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// the value whose order_bits are k
__device__ __forceinline__ float value_of_bits(unsigned int k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ float value_of(unsigned long long key) {
  return value_of_bits(static_cast<unsigned int>(key >> 32));
}

__device__ __forceinline__ unsigned long long make_key(float v, int pos) {
  return (static_cast<unsigned long long>(order_bits(v)) << 32) |
         static_cast<unsigned int>(pos);
}

__device__ __forceinline__ int position_of(unsigned long long key) {
  return static_cast<int>(static_cast<unsigned int>(key));
}

// one compare-swap of a bitonic stage across lanes: this lane's key and
// its partner's at lane ^ stride; the lower lane keeps the smaller key
// when the run ascends (`up`)
__device__ __forceinline__ unsigned long long lane_swap(unsigned long long x,
                                                        int lane, int stride,
                                                        bool up) {
  const unsigned long long y = __shfl_xor_sync(0xffffffffu, x, stride);
  const bool keep_min = ((lane & stride) == 0) == up;
  return keep_min == (x < y) ? x : y;
}

// The strides `top` .. 1 (top >= 16) of stage `size` of a bitonic sort
// over keys[0, n) in shared memory (n a power of two >= 32), by the
// `count` threads of a block (a multiple of 32, ids `tid`). `base` is the
// index of keys[0] in the whole sort: a pair ascends where bit `size` of
// its index is clear. Strides from 32 up run in shared memory, a
// compare-swap per thread per stage; those below 32 in registers, a warp
// taking 32 consecutive keys and exchanging them with shuffles. Ends
// synced.
__device__ __forceinline__ void merge_down(unsigned long long* keys, int n,
                                           int size, int top, int base,
                                           int tid, int count) {
  const int lane = tid & 31;
  for (int stride = top; stride >= 32; stride >>= 1) {
    for (int t = tid; t < n / 2; t += count) {
      const int lo = 2 * t - (t & (stride - 1));  // bit `stride` clear
      const int hi = lo + stride;
      const unsigned long long x = keys[lo];
      const unsigned long long y = keys[hi];
      if ((x > y) == (((base + lo) & size) == 0)) {
        keys[lo] = y;
        keys[hi] = x;
      }
    }
    __syncthreads();
  }
  for (int e = tid; e < n; e += count) {
    unsigned long long x = keys[e];
    for (int stride = 16; stride > 0; stride >>= 1) {
      x = lane_swap(x, lane, stride, ((base + e) & size) == 0);
    }
    keys[e] = x;
  }
  __syncthreads();
}

// Bitonic sort of keys[0, n) in shared memory, n a power of two >= 32, by
// the `count` threads of a block: ascending for base = 0; for keys[0, n)
// at index `base` of a larger sort, the direction that sort gives them.
// Sizes 2 .. 32 run in registers, then merge_down each larger size, so a
// block syncs 2 log2(n / 32) + 1 times, not log2(n) (log2(n) + 1) / 2 (10
// against 36 at n = 256). The caller syncs before (the staging); the last
// sync ends the sort.
__device__ __forceinline__ void bitonic_sort(unsigned long long* keys, int n,
                                             int tid, int count,
                                             int base = 0) {
  const int lane = tid & 31;
  for (int e = tid; e < n; e += count) {
    unsigned long long x = keys[e];
    for (int size = 2; size <= 32; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        x = lane_swap(x, lane, stride, ((base + e) & size) == 0);
      }
    }
    keys[e] = x;
  }
  __syncthreads();
  for (int size = 64; size <= n; size <<= 1) {
    merge_down(keys, n, size, size >> 1, base, tid, count);
  }
}

// The key store past shared memory: a block of kStoreThreads threads
// sorts at most kStoreChunk keys (128 KB) in shared memory at once, so
// one block runs an SM. A pass over device memory keeps kPassPairs
// compare-swaps a thread in flight: one block alone moves the slice, and
// with one pair a thread it would wait a round trip for each 16 KB.
constexpr int kStoreThreads = 1024;
constexpr int kStoreChunk = 16384;
constexpr int kPassPairs = 4;

// Ascending sort of keys[0, n) in device memory (n a power of two >= 32)
// by the `count` threads of a block, through `chunk`, shared memory for
// `len` keys (a power of two from 32 to kStoreChunk): the same bitonic
// network as bitonic_sort. Each run of len keys is sorted in shared
// memory in the direction the network gives it; then each larger stage
// runs its strides from len up as passes over device memory, a
// compare-swap per thread per pass (consecutive threads on consecutive
// pairs), and its strides below len in shared memory, run by run. A
// thread moves the same entries between `chunk` and `keys` both ways, so
// those moves need no sync of their own. The caller syncs before; the
// last sync ends the sort.
__device__ __forceinline__ void sort_store(unsigned long long* keys, int n,
                                           unsigned long long* chunk,
                                           int len, int tid, int count) {
  len = n < len ? n : len;
  for (int c0 = 0; c0 < n; c0 += len) {
    for (int e = tid; e < len; e += count) chunk[e] = keys[c0 + e];
    bitonic_sort(chunk, len, tid, count, c0);
    for (int e = tid; e < len; e += count) keys[c0 + e] = chunk[e];
  }
  __syncthreads();
  for (int size = 2 * len; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride >= len; stride >>= 1) {
      for (int t0 = tid; t0 < n / 2; t0 += kPassPairs * count) {
        unsigned long long x[kPassPairs], y[kPassPairs];
#pragma unroll
        for (int u = 0; u < kPassPairs; ++u) {
          const int t = t0 + u * count;
          if (t < n / 2) {
            const int lo = 2 * t - (t & (stride - 1));
            x[u] = keys[lo];
            y[u] = keys[lo + stride];
          }
        }
#pragma unroll
        for (int u = 0; u < kPassPairs; ++u) {
          const int t = t0 + u * count;
          const int lo = 2 * t - (t & (stride - 1));
          if (t < n / 2 && (x[u] > y[u]) == ((lo & size) == 0)) {
            keys[lo] = y[u];
            keys[lo + stride] = x[u];
          }
        }
      }
      __syncthreads();
    }
    for (int c0 = 0; c0 < n; c0 += len) {
      for (int e = tid; e < len; e += count) chunk[e] = keys[c0 + e];
      __syncthreads();
      merge_down(chunk, len, size, len >> 1, c0, tid, count);
      for (int e = tid; e < len; e += count) keys[c0 + e] = chunk[e];
    }
    __syncthreads();
  }
}

// keys a thread sorts in registers, then merges a pass, in merge_sort
constexpr int kMergeRun = 8;

// where merge_sort's passes keep key r: a key's room of padding after every
// kMergeRun keys, so that the 32 lanes of a warp, kMergeRun keys apart,
// reach 32 different banks (a plain stride of 64 bytes reaches 2)
__host__ __device__ __forceinline__ int merge_index(int r) { return r + r / kMergeRun; }

// the room merge_sort's layout takes for n keys
__host__ __device__ __forceinline__ int merge_room(int n) { return merge_index(n); }

__device__ __forceinline__ void compare_swap(unsigned long long& a, unsigned long long& b) {
  const unsigned long long lo = a < b ? a : b;
  b = a < b ? b : a;
  a = lo;
}

// The kMergeRun outputs from e0 on of merging the sorted runs src[base,
// base + len) and src[base + len, base + 2 len) (base: e0 rounded down to
// 2 len; src in merge_index's layout), into out: from where the merge path
// of output e0 crosses the two runs (a binary search) on, one load an
// output. Equal keys (the padding) come from the first run first; a run's
// end reads as kPadKey, and where both heads are kPadKey the rest of both
// runs is padding, equal, so either side gives the same outputs.
__device__ __forceinline__ void merge_at(const unsigned long long* src, int e0, int len,
                                         unsigned long long* out) {
  const int base = e0 & ~(2 * len - 1);
  const int d = e0 - base;
  const auto at_a = [&](int i) { return src[merge_index(base + i)]; };
  const auto at_b = [&](int j) { return src[merge_index(base + len + j)]; };
  // how many of the pair's first d outputs come from the first run
  int lo = d > len ? d - len : 0;
  int hi = d < len ? d : len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (at_a(mid) <= at_b(d - 1 - mid)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int i = lo;
  int j = d - lo;
  unsigned long long a = i < len ? at_a(i) : kPadKey;
  unsigned long long b = j < len ? at_b(j) : kPadKey;
#pragma unroll
  for (int u = 0; u < kMergeRun; ++u) {
    const bool take_a = a <= b;
    out[u] = take_a ? a : b;
    i += take_a ? 1 : 0;
    j += take_a ? 0 : 1;
    const int next = take_a ? i : j;
    const unsigned long long loaded =
        next < len ? src[merge_index(base + (take_a ? 0 : len) + next)] : kPadKey;
    a = take_a ? loaded : a;
    b = take_a ? b : loaded;
  }
}

// Batcher's odd-even merge network on kMergeRun keys (19 compare-swaps)
__device__ __forceinline__ void sort_run(unsigned long long* v) {
#define ZEN_CS(p, q) compare_swap(v[p], v[q])
  ZEN_CS(0, 1); ZEN_CS(2, 3); ZEN_CS(4, 5); ZEN_CS(6, 7);
  ZEN_CS(0, 2); ZEN_CS(1, 3); ZEN_CS(4, 6); ZEN_CS(5, 7);
  ZEN_CS(1, 2); ZEN_CS(5, 6);
  ZEN_CS(0, 4); ZEN_CS(1, 5); ZEN_CS(2, 6); ZEN_CS(3, 7);
  ZEN_CS(2, 4); ZEN_CS(3, 5);
  ZEN_CS(1, 2); ZEN_CS(3, 4); ZEN_CS(5, 6);
#undef ZEN_CS
}

// Whether merge_sort needs its second buffer: where the `count` threads
// take more than one run of kMergeRun keys each, a pass's outputs do not
// fit their registers
__host__ __device__ __forceinline__ bool merge_spare(int n, int count) {
  return count * kMergeRun < n;
}

// Ascending sort of the n keys staged plainly in keys[0, n) (n a power of
// two >= 32) by the `count` threads of a block, in buffers of
// merge_room(n) keys: the passes keep merge_index's layout, the last one
// writes the sorted keys plainly, key r at [r] (its stores conflict on
// banks, but the walk's chunks of consecutive ranks then read as one
// stretch: 729 against 804 us on the 4-minute pass 1 in K2, 882 against
// 868 on median2d's fl 93 in K1, benches/rank_split.py on an H100).
// A thread takes kMergeRun keys n / kMergeRun apart (consecutive threads
// read consecutive keys), sorts them in registers (sort_run) and writes
// them as one run; then
// log2(n / kMergeRun) passes merge pairs of sorted runs, a thread
// kMergeRun outputs a pass (merge_at). Where each thread takes at most one
// run (merge_spare false) its outputs wait in registers for the pass's
// reads to end and go back to `keys` (two syncs a pass, no second
// buffer); otherwise a pass writes `spare`, merge_room(n) keys more, and
// the two buffers swap. The caller syncs before; the last sync ends the
// sort. Returns the buffer that holds the sorted keys: keys or spare.
__device__ __forceinline__ unsigned long long* merge_sort(unsigned long long* keys,
                                                          unsigned long long* spare, int n,
                                                          int tid, int count) {
  const int runs = n / kMergeRun;
  unsigned long long v[kMergeRun];
  if (!merge_spare(n, count)) {
    const bool mine = tid < runs;
    if (mine) {
#pragma unroll
      for (int u = 0; u < kMergeRun; ++u) v[u] = keys[tid + u * runs];
      sort_run(v);
    }
    __syncthreads();
    for (int len = kMergeRun;; len <<= 1) {
      if (mine) {
#pragma unroll
        for (int u = 0; u < kMergeRun; ++u) {
          const int e = tid * kMergeRun + u;
          keys[len >= n ? e : merge_index(e)] = v[u];
        }
      }
      __syncthreads();
      if (len >= n) return keys;
      if (mine) merge_at(keys, tid * kMergeRun, len, v);
      __syncthreads();
    }
  }
  for (int v0 = tid; v0 < runs; v0 += count) {
#pragma unroll
    for (int u = 0; u < kMergeRun; ++u) v[u] = keys[v0 + u * runs];
    sort_run(v);
#pragma unroll
    for (int u = 0; u < kMergeRun; ++u) spare[merge_index(v0 * kMergeRun + u)] = v[u];
  }
  __syncthreads();
  unsigned long long* src = spare;
  unsigned long long* dst = keys;
  for (int len = kMergeRun; len < n; len <<= 1) {
    for (int e0 = tid * kMergeRun; e0 < n; e0 += count * kMergeRun) {
      merge_at(src, e0, len, v);
#pragma unroll
      for (int u = 0; u < kMergeRun; ++u) dst[2 * len >= n ? e0 + u : merge_index(e0 + u)] = v[u];
    }
    __syncthreads();
    unsigned long long* t = src;
    src = dst;
    dst = t;
  }
  return src;
}

__host__ __device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// ranks the walk takes per step: their reads do not wait on each other
constexpr int kWalkChunk = 8;

// keys staged for `staged` samples: a power of two, at least one warp's
// 32 (the sort's register stages take 32 keys a warp)
__host__ __device__ __forceinline__ int key_count(int staged) {
  const int n = pow2_at_least(staged);
  return n < 32 ? 32 : n;
}

// The rank walk over sorted keys: the key at the first rank where the
// running sum of count(key) (how many times that staged sample is a tap
// of this thread's window) passes m. It sums kWalkChunk ranks a step and
// then finds the rank inside the step that passes m, so the loop waits
// on one sum per chunk and not on every read. The answer lies below the
// padding and a chunk starts at a multiple of kWalkChunk, so no read
// passes the key count (a power of two >= 32).
template <typename Count>
__device__ __forceinline__ unsigned long long walk(
    const unsigned long long* keys, int m, Count count) {
  int rank = 0;
  int seen = 0;
  for (;;) {
    int step = 0;
#pragma unroll
    for (int u = 0; u < kWalkChunk; ++u) step += count(keys[rank + u]);
    if (seen + step > m) break;
    seen += step;
    rank += kWalkChunk;
  }
  for (;; ++rank) {
    seen += count(keys[rank]);
    if (seen > m) return keys[rank];
  }
}

// walk() over the sorted keys key(rank) that also leaves where it ended
// for step(): the rank of the key it returns in *at, and the count of the
// ranks below it in *below
template <typename Key, typename Count>
__device__ __forceinline__ unsigned long long walk_from_zero(Key key, int m, Count count,
                                                             int* at, int* below) {
  int rank = 0;
  int seen = 0;
  for (;;) {
    int step = 0;
#pragma unroll
    for (int u = 0; u < kWalkChunk; ++u) step += count(key(rank + u));
    if (seen + step > m) break;
    seen += step;
    rank += kWalkChunk;
  }
  for (;; ++rank) {
    const int c = count(key(rank));
    if (seen + c > m) break;
    seen += c;
  }
  *at = rank;
  *below = seen;
  return key(rank);
}

// The count of staged positions whose rank lies below `pivot`, before each
// position: prefix[p] for p in 0 .. staged (prefix[staged] the total),
// from `rank_of` (the inverse ranks) by the `count` threads of a block (a
// multiple of 32, at most 1024; each takes a stretch of consecutive
// positions) through `warp_sums` (count / 32 ints). One scan gives every
// window [j, j + w) its count below the pivot: prefix[j + w] - prefix[j].
// The caller syncs before; ends synced.
__device__ __forceinline__ void prefix_below(int* prefix, const int* rank_of, int staged,
                                             int pivot, int tid, int count, int* warp_sums) {
  const int per = (staged + count - 1) / count;
  const int lo = min(tid * per, staged);
  const int hi = min(lo + per, staged);
  int mine = 0;
  for (int p = lo; p < hi; ++p) mine += rank_of[p] < pivot ? 1 : 0;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int x = mine;  // inclusive scan over the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < count / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < count / 32) warp_sums[lane] = w;
  }
  __syncthreads();
  int before = x - mine + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (int p = lo; p < hi; ++p) {
    prefix[p] = before;
    before += rank_of[p] < pivot ? 1 : 0;
  }
  if (tid == 0) prefix[staged] = warp_sums[count / 32 - 1];
  __syncthreads();
}

// The rank at which the running count of count(key(rank)) passes m, from
// rank *at with *below counted before it (this output's window): down
// while the count below passes m, then up; kWalkChunk ranks a step where
// a whole chunk leaves the answer beyond it, one rank at a time after,
// so that the reads of a chunk do not wait on each other. Leaves the rank
// in *at and the count below it in *below (step()'s start), returns the
// key. An output's first walk starts from the middle rank, its count
// below from prefix_below: the answer lies about as far from it as the
// window's median from the block's, not S/2 ranks from rank 0. The
// answer lies below the padding; a chunk is read only where it ends by
// the key count n.
template <typename Key, typename Count>
__device__ __forceinline__ unsigned long long seek(Key key, int m, Count count, int* at,
                                                   int* below, int n) {
  int rank = *at;
  int seen = *below;
  while (seen > m && rank >= kWalkChunk) {
    int chunk = 0;
#pragma unroll
    for (int u = 1; u <= kWalkChunk; ++u) chunk += count(key(rank - u));
    if (seen - chunk <= m) break;
    seen -= chunk;
    rank -= kWalkChunk;
  }
  while (seen > m) {
    --rank;
    seen -= count(key(rank));
  }
  while (rank + kWalkChunk <= n) {
    int chunk = 0;
#pragma unroll
    for (int u = 0; u < kWalkChunk; ++u) chunk += count(key(rank + u));
    if (seen + chunk > m) break;
    seen += chunk;
    rank += kWalkChunk;
  }
  for (;; ++rank) {
    const int c = count(key(rank));
    if (seen + c > m) break;
    seen += c;
  }
  *at = rank;
  *below = seen;
  return key(rank);
}

// The incremental walk: the same key as walk() for the next output of a
// run, from where the previous output's walk ended. *below holds the
// count, under this output's window, of the ranks below *at (the caller
// has moved the previous output's count by the samples that left and
// entered the window, read at their ranks in the inverse array). Where it
// passes m the answer lies below: step down until it does not; then step
// up to the first rank at which it passes m. Neighbouring windows differ
// by a sample each way, so the answer lies about S/K ranks away for S
// staged samples, not S/2. Both ends stay inside the staged ranks: the
// count below rank 0 is 0, and the answer lies below the padding.
template <typename Key, typename Count>
__device__ __forceinline__ unsigned long long step(Key key, int m, Count count, int* at,
                                                   int* below) {
  int rank = *at;
  int seen = *below;
  while (seen > m) {
    --rank;
    seen -= count(key(rank));
  }
  for (;; ++rank) {
    const int c = count(key(rank));
    if (seen + c > m) break;
    seen += c;
  }
  *at = rank;
  *below = seen;
  return key(rank);
}

// The warp route's selection (K1's tap_median_time_warp_kernel): a warp
// holds one output's taps as order bits, S a lane (32 S of them, padded
// with ~0u above every tap), element e = lane * S + j in lane e / S's
// slot e % S, and sorts them ascending by a bitonic network: at each
// stage (size, stride) element e meets e ^ stride and keeps the smaller
// where bit `stride` of e and bit `size` of e are both clear or both set.
// A stride below S pairs two slots of one lane (in registers); from S up
// the partner is lane ^ (stride / S), slot for slot, through one
// __shfl_xor_sync a slot. No shared memory, no block barrier. Every
// exchange keeps one of its two operands: a compare and a select where
// the direction depends on the lane (one instruction fewer than a min, a
// max and a select), a min and a max where it is known at compile time.
// So the warp ends with the multiset it began with, sorted as the rank
// routes' keys order it (-0.0 below +0.0; equal bits are one value), and
// element (K - 1) / 2 is bitwise the rank route's median.
template <int S, int Size, int Stride>
__device__ __forceinline__ void warp_stage(unsigned int (&v)[S], int lane) {
  if constexpr (Stride >= S) {
    constexpr int kLanes = Stride / S;
    const bool up = (lane & (Size / S)) == 0;  // bit `Size` of e, Size >= 2 S
    const bool keep_min = ((lane & kLanes) == 0) == up;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const unsigned int o = __shfl_xor_sync(0xffffffffu, v[j], kLanes);
      v[j] = (o < v[j]) == keep_min ? o : v[j];
    }
  } else if constexpr (Size < S) {
    // the direction is bit `Size` of the slot
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if ((j & Stride) == 0) {
        const unsigned int lo = min(v[j], v[j | Stride]);
        const unsigned int hi = max(v[j], v[j | Stride]);
        const bool up = (j & Size) == 0;
        v[j] = up ? lo : hi;
        v[j | Stride] = up ? hi : lo;
      }
    }
  } else {
    // the direction is bit `Size` / S of the lane
    const bool up = (lane & (Size / S)) == 0;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      if ((j & Stride) == 0) {
        const unsigned int lo = v[j], hi = v[j | Stride];
        const bool swap = (hi < lo) == up;
        v[j] = swap ? hi : lo;
        v[j | Stride] = swap ? lo : hi;
      }
    }
  }
}

template <int S, int Size = 2, int Stride = 1>
__device__ __forceinline__ void warp_sort(unsigned int (&v)[S], int lane) {
  warp_stage<S, Size, Stride>(v, lane);
  if constexpr (Stride > 1) {
    warp_sort<S, Size, Stride / 2>(v, lane);
  } else if constexpr (Size < 32 * S) {
    warp_sort<S, Size * 2, Size>(v, lane);
  }
}

}  // namespace zen_rank
