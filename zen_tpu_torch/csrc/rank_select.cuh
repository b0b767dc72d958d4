// Rank once, select many: the device code that K1's and K2's large-K
// routes share (csrc/median_time.cu, csrc/median_freq.cu).
//
// A block stages the samples its outputs' windows reach, once, as 64-bit
// keys: the value's order bits above, its staged position below. One
// bitonic sort of the keys orders the staged samples by (value,
// position). Each output then walks the ranks upward, counting the
// positions that fall in its own window (with their multiplicity, where
// taps repeat), until the count passes (K - 1) / 2: the value at that
// rank is sorted(window)[(K - 1) / 2], the element rank-by-counting and
// torch.kthvalue pick. Per output that is ~S/2 reads for S staged
// samples, plus the sort's O(log^2 S) compare-swaps per sample, against
// up to K^2 compares for ranking each window by counting.
//
// Two stores for the keys. The shared store sorts them in shared memory
// (bitonic_sort), up to the 227 KB a block can opt into: 16,384 keys of
// 8 bytes, as a power of two. Past that K2's keys live in the block's
// slice of a device-memory scratch that the wrapper allocates, sized by
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

}  // namespace zen_rank
