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
//   by hundreds of outputs.
// The wrappers' cost rule picks the way and the geometry for each call
// (ops/median_cuda.py, sort_us): calls of few outputs a block (a single
// stream's hop-32 and hop-1024 steps) keep the walk, whose blocks finish
// sooner; calls of many (offline passes, median2d) take the steps.
// Per output the bitonic sort costs O(log^2 S) compare-swaps a staged
// sample, a merge pass O(log S) moves; both stay far below the up to K^2
// compares of ranking each window by counting. The walk keeps bitonic_sort
// in shared memory (10.2 against 14.0 us for a merge sort on hop 32's K1
// step, 9.3 against 13.6 on hop 1024's K2 step, where a block sorts
// 128-256 keys, benches/rank_split.py on an H100). The steps sort with
// warp_merge_sort: a warp sorts a slice of 256 keys in registers, 8 a
// lane as doubles whose order is the keys' (sort_form: one DSETP a
// compare, on the FP64 pipe, where a 64-bit integer compare takes two
// ALU instructions), by a bitonic network in its flip form (no stage has
// a direction of its own): 21 stages of compares and selects inside a
// lane and 15 across lanes, one __shfl_xor_sync of a double a key; no
// shared memory and no barrier. A slice goes back plainly through a
// parked layout free of bank conflicts; past 256 keys the slices merge in
// passes along their merge path (merge_passes: one at the 4-minute
// track's 512 keys). Its K2 kernel caps its registers at 64 a thread
// (launch bounds). It replaced merge_sort, the first design (runs of 8
// sorted in registers, then log2(n / 8) merge passes, each a binary
// search and 8 dependent shared loads a thread between two block
// barriers: six at 512 keys). On an H100 80GB HBM3 at 700 W
// (benches/rank_split.py on this tree and on the one before, in turns)
// the track's pass 1 sorted in 316.86-319.38 against 424.75-428.10 us
// (the kernel 686.78-691.90 against 728.91-734.40; its walk 286-288
// against 223-225, at fewer blocks an SM) and median2d's fl 93 in
// 294.72-297.38 against 353.33-357.22 (8 columns a block against 4; the
// kernel 803.31-809.60 against 881.86-888.56). Tries that lost: min and
// max as fmin and fmax, each with a compare of its own (842 us to sort
// the track), 16 keys a lane (195 registers a thread), and 64-bit integer
// compares (368.53 us).
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

// keys a thread merges a pass, in merge_passes
constexpr int kMergeRun = 8;

// where the merge passes keep key r: a key's room of padding after every
// kMergeRun keys, so that the 32 lanes of a warp, kMergeRun keys apart,
// reach 32 different banks (a plain stride of 64 bytes reaches 2)
__host__ __device__ __forceinline__ int merge_index(int r) { return r + r / kMergeRun; }

// the room merge_index's layout takes for n keys
__host__ __device__ __forceinline__ int merge_room(int n) { return merge_index(n); }

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

// The merge passes from sorted runs of `len` keys in src
// (merge_index's layout) to one run of n, by the `count` threads of a
// block, kMergeRun outputs a thread a pass (merge_at), src and dst
// swapping each pass; the last pass writes plainly. The caller syncs
// before; the last sync ends the sort. Returns the buffer that holds the
// sorted keys.
__device__ __forceinline__ unsigned long long* merge_passes(unsigned long long* src,
                                                            unsigned long long* dst, int n,
                                                            int len, int tid, int count) {
  unsigned long long v[kMergeRun];
  for (; len < n; len <<= 1) {
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

// keys a lane of warp_merge_sort holds, and a warp's slice of keys
constexpr int kLaneKeys = 8;
constexpr int kWarpKeys = 32 * kLaneKeys;
// staged positions below this bound ride in sort_form's 20 position bits:
// every steps block's do, as its keys (8 bytes each) or its inverse ranks
// (4 bytes a position) fit the 227 KB of shared memory a block may take
constexpr int kSortPositions = 1 << 19;

// A key as the double whose order is the key's: exponent 1 above a
// mantissa of the key's 32 order bits and 20 position bits. It is a
// normal double (no NaN, no subnormal), so a double compare (DSETP, the
// FP64 pipe) orders two keys where the integer compare takes two ALU
// instructions. Positions below kSortPositions keep their bits; the
// padding's (all ones) becomes 2^20 - 1, above every staged position.
__device__ __forceinline__ double sort_form(unsigned long long key) {
  const unsigned int hi = static_cast<unsigned int>(key >> 32);
  const unsigned int lo = static_cast<unsigned int>(key);
  return __hiloint2double(static_cast<int>(0x00100000u | (hi >> 12)),
                          static_cast<int>((hi << 20) | (lo & 0xFFFFFu)));
}

// the key of sort_form's double: 2^20 - 1 sign-extends back to the
// padding's position, so kPadKey comes back whole
__device__ __forceinline__ unsigned long long key_form(double d) {
  const unsigned int hi = static_cast<unsigned int>(__double2hiint(d));
  const unsigned int lo = static_cast<unsigned int>(__double2loint(d));
  const unsigned int order = (hi << 12) | (lo >> 20);
  const int pos = static_cast<int>(lo << 12) >> 12;
  return (static_cast<unsigned long long>(order) << 32) | static_cast<unsigned int>(pos);
}

// One stage of the ascending bitonic sort of a warp's 32 R keys in the
// flip form: element e = lane * R + j sits in slot j of `lane`; the
// stride Size / 2 is the flip (e meets e ^ (Size - 1), the run's mirror
// image), a smaller stride the half-cleaner (e meets e ^ Stride), and the
// lower of the two keeps the smaller, so no stage has a direction of its
// own. A partner inside the lane (Stride < R) is one compare and four
// selects on two registers; from R up it is lane ^ (Size - 1) / R (flip,
// mirrored slot R - 1 - j) or lane ^ Stride / R (same slot), one
// __shfl_xor_sync of a double a slot, one compare and two selects: the
// lower lane keeps the partner's key where it is the smaller.
template <int R, int Size, int Stride>
__device__ __forceinline__ void key_stage(double (&v)[R], int lane) {
  constexpr bool kFlip = Stride == Size / 2;
  if constexpr (Stride >= R) {
    constexpr int kLanes = (kFlip ? Size - 1 : Stride) / R;
    const bool low = (lane & (Stride / R)) == 0;
#pragma unroll
    for (int j = 0; j < (kFlip ? R / 2 : R); ++j) {
      const double a = __shfl_xor_sync(0xffffffffu, v[kFlip ? R - 1 - j : j], kLanes);
      if constexpr (kFlip) {
        const double b = __shfl_xor_sync(0xffffffffu, v[j], kLanes);
        v[R - 1 - j] = (b < v[R - 1 - j]) == low ? b : v[R - 1 - j];
      }
      v[j] = (a < v[j]) == low ? a : v[j];
    }
  } else {
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int p = kFlip ? (j ^ (Size - 1)) : (j ^ Stride);
      if (j < p) {
        const bool swap = v[p] < v[j];
        const double lo = swap ? v[p] : v[j];
        v[p] = swap ? v[j] : v[p];
        v[j] = lo;
      }
    }
  }
}

template <int R, int Size = 2, int Stride = 1>
__device__ __forceinline__ void key_bitonic(double (&v)[R], int lane) {
  key_stage<R, Size, Stride>(v, lane);
  if constexpr (Stride > 1) {
    key_bitonic<R, Size, Stride / 2>(v, lane);
  } else if constexpr (Size < 32 * R) {
    key_bitonic<R, Size * 2, Size>(v, lane);
  }
}

// One warp loads keys[0, n) (n a power of two, 32 <= n <= kWarpKeys), key
// e = j * 32 + lane into slot j (consecutive lanes on consecutive keys: no
// bank conflict; slots past n read kPadKey), and sorts them in registers:
// lane `lane` ends with sorted elements lane * kLaneKeys .. + kLaneKeys - 1.
__device__ __forceinline__ void warp_load_sort(const unsigned long long* keys, int n, int lane,
                                               double (&v)[kLaneKeys]) {
#pragma unroll
  for (int j = 0; j < kLaneKeys; ++j) {
    const int e = j * 32 + lane;
    v[j] = sort_form(e < n ? keys[e] : kPadKey);
  }
  key_bitonic<kLaneKeys>(v, lane);
}

// where warp_store_plain parks element j of lane q's run: its slot turned
// by bits 1-3 of q, so that 16 lanes writing their slot j, and 16 lanes
// reading 16 consecutive elements, each reach 16 distinct 8-byte bank pairs
__device__ __forceinline__ int parked(int q, int j) {
  return q * kLaneKeys + (j ^ ((q >> 1) & (kLaneKeys - 1)));
}

// The sorted registers of warp_load_sort back into keys[0, n), key r at
// [r], in place: each lane parks its run (parked), then reads the keys
// j * 32 + lane and writes them plainly, so no access conflicts on banks
// (a lane writing its 8 consecutive keys would: 16 lanes 64 bytes apart
// reach two bank pairs). A lane's run is all padding or all below n (n is
// a multiple of kLaneKeys).
__device__ __forceinline__ void warp_store_plain(unsigned long long* keys, int n, int lane,
                                                 const double (&v)[kLaneKeys]) {
  __syncwarp();
  if (lane * kLaneKeys < n) {
#pragma unroll
    for (int j = 0; j < kLaneKeys; ++j) keys[parked(lane, j)] = key_form(v[j]);
  }
  __syncwarp();
  unsigned long long w[kLaneKeys];
#pragma unroll
  for (int j = 0; j < kLaneKeys; ++j) {
    const int e = j * 32 + lane;
    if (e < n) w[j] = keys[parked(e / kLaneKeys, e % kLaneKeys)];
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kLaneKeys; ++j) {
    const int e = j * 32 + lane;
    if (e < n) keys[e] = w[j];
  }
}

// Whether a steps block sorting n keys by `count` threads needs a second
// buffer of merge_room(n) keys: past one warp's kWarpKeys, where a
// thread merges more than one run of kMergeRun keys, a pass's outputs do
// not fit its registers
__host__ __device__ __forceinline__ bool sort_spare(int n, int count) {
  return n > kWarpKeys && count * kMergeRun < n;
}

// Ascending sort of `cols` buffers of n keys each (buffer g at keys + g *
// stride, its second buffer at + room; n a power of two >= 32), staged
// plainly, by a block's `threads` threads (a multiple of 32), the buffer
// g's `threads` / cols of them taking buffer g (tid = g * group + gid):
// the same arrays any ascending sort leaves (keys are distinct but for
// the padding). Slices of kWarpKeys keys are sorted in registers, a warp a
// slice (warp_load_sort): up to kWarpKeys a buffer is one slice, stored
// back plainly in place by a warp of the block; past it, where the
// buffer's threads take one merge run each (no sort_spare), its warps
// sort its slices in place in merge_index's layout and merge them in
// registers, else the block's warps sort every slice into the buffers'
// second buffers for merge_passes. No shared memory and
// no barrier inside a slice's sort. The caller syncs before; the last
// sync ends the sort. Returns where buffer g's sorted keys are.
__device__ __forceinline__ unsigned long long* warp_merge_sort(unsigned long long* keys,
                                                               int stride, int room, int cols,
                                                               int n, int tid, int threads) {
  const int lane = tid & 31;
  const int warps = threads >> 5;
  const int group = threads / cols;
  const int g = tid / group;
  const int gid = tid - g * group;
  unsigned long long* buf = keys + g * stride;
  double v[kLaneKeys];
  if (n <= kWarpKeys) {
    for (int q = tid >> 5; q < cols; q += warps) {
      warp_load_sort(keys + q * stride, n, lane, v);
      warp_store_plain(keys + q * stride, n, lane, v);
    }
    __syncthreads();
    return buf;
  }
  const int per = n / kWarpKeys;
  if (!sort_spare(n, group)) {
    // group >= n / kMergeRun: whole warps, at least one a slice
    const int s = gid >> 5;
    if (s < per) warp_load_sort(buf + s * kWarpKeys, kWarpKeys, lane, v);
    __syncthreads();
    if (s < per) {
#pragma unroll
      for (int j = 0; j < kLaneKeys; ++j) {
        buf[merge_index(s * kWarpKeys + lane * kLaneKeys + j)] = key_form(v[j]);
      }
    }
    __syncthreads();
    const bool mine = gid < n / kMergeRun;
    unsigned long long out[kMergeRun];
    for (int len = kWarpKeys; len < n; len <<= 1) {
      if (mine) merge_at(buf, gid * kMergeRun, len, out);
      __syncthreads();
      if (mine) {
#pragma unroll
        for (int u = 0; u < kMergeRun; ++u) {
          const int e = gid * kMergeRun + u;
          buf[2 * len >= n ? e : merge_index(e)] = out[u];
        }
      }
      __syncthreads();
    }
    return buf;
  }
  for (int q = tid >> 5; q < cols * per; q += warps) {
    unsigned long long* b = keys + (q / per) * stride;
    const int base = (q % per) * kWarpKeys;
    warp_load_sort(b + base, kWarpKeys, lane, v);
#pragma unroll
    for (int j = 0; j < kLaneKeys; ++j) {
      b[room + merge_index(base + lane * kLaneKeys + j)] = key_form(v[j]);
    }
  }
  __syncthreads();
  return merge_passes(buf + room, buf, n, kWarpKeys, gid, group);
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
