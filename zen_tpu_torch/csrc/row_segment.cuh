// K2's row-segment staging, shared by K2 (csrc/median_freq.cu,
// csrc/median_freq_core.cu) and its copy-only mirror segment_copy
// (csrc/probe_copy.cu), so that the mirror's access pattern is K2's by
// construction.
//
// A block of `count` threads stages the `need` samples its outputs'
// windows reach, row positions base .. base + need - 1 with the boundary
// rule applied on the load, in shared memory:
// * stage_values (the network route, K up to ZEN_SELECT_FREQ_MAX_TAPS): in the
//   input's own type, 4 or 2 bytes a sample; consecutive threads load
//   consecutive samples, and only the halo pays for the boundary rule;
// * stage_keys (the rank route): as 64-bit (value order bits, position)
//   keys, padded with kPadKey up to key_count(need) keys.
// network_chunk is the network route's split of a row into blocks, which
// K2's launchers (the network's and its shared core's, csrc/
// median_freq_core.cu) and the mirror's call; check_args the launchers'
// check of a call's geometry.
#pragma once

#include <cuda_runtime.h>

#include "rank_select.cuh"
#include "zen_select.cuh"

namespace zen_segment {

enum Mode { kReflect = 0, kWrap = 1, kEdge = 2, kValid = 3 };

// the input position of padded position p of a row of f samples, as
// jnp.pad's reflect (excludes the edge sample), wrap (p mod f) and edge
// (clamp) read it; `valid` reads an already padded row
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

// The launchers' check of a call's geometry: 0, or cudaErrorInvalidValue
// where K is not odd and positive, a count is not positive, the mode is
// unknown, f_out is not the mode's width (valid: f_in - k + 1, else
// f_in) or reflect's window passes the row's far edge
inline int check_args(int rows, int f_in, int f_out, int k, int mode) {
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

// Outputs per block of the network route: a row of f_out outputs splits
// into the fewest chunks of at most kNetworkChunk, evenly, so that no
// block is left a sliver (513 bins: one block a row; 2049: three of 683).
constexpr int kNetworkChunk = 1024;
constexpr int kNetworkThreads = 128;

__host__ __device__ __forceinline__ int network_chunk(int f_out) {
  const int chunks = (f_out + kNetworkChunk - 1) / kNetworkChunk;
  return (f_out + chunks - 1) / chunks;
}

// A thread's share of the largest segment a network block stages
constexpr int kNetworkLoads =
    (kNetworkChunk + ZEN_SELECT_FREQ_MAX_TAPS - 1 + kNetworkThreads - 1) /
    kNetworkThreads;

// Stages seg[0, need), need <= kNetworkChunk + ZEN_SELECT_FREQ_MAX_TAPS - 1, by
// the kNetworkThreads threads tid of a block; the caller syncs after. A
// thread starts all its loads before its first store, so that they are
// in flight together.
template <typename T>
__device__ __forceinline__ void stage_values(T* seg, const T* __restrict__ row,
                                             int base, int need, int f_in,
                                             int mode, int tid) {
  T held[kNetworkLoads];
#pragma unroll
  for (int u = 0; u < kNetworkLoads; ++u) {
    const int s = tid + u * kNetworkThreads;
    if (s < need) {
      const int p = base + s;
      held[u] = row[static_cast<unsigned>(p) < static_cast<unsigned>(f_in)
                        ? p
                        : boundary_index(p, f_in, mode)];
    }
  }
#pragma unroll
  for (int u = 0; u < kNetworkLoads; ++u) {
    const int s = tid + u * kNetworkThreads;
    if (s < need) seg[s] = held[u];
  }
}

// Stages keys[0, key_count(need)) by threads tid, tid + count, ...; the
// caller syncs after. Returns the key count.
template <typename T>
__device__ __forceinline__ int stage_keys(unsigned long long* keys,
                                          const T* __restrict__ row,
                                          int base, int need, int f_in,
                                          int mode, int tid, int count) {
  const int n = zen_rank::key_count(need);
  for (int s = tid; s < n; s += count) {
    keys[s] = s < need ? zen_rank::make_key(
                             zen_rank::to_float(
                                 row[boundary_index(base + s, f_in, mode)]),
                             s)
                       : zen_rank::kPadKey;
  }
  return n;
}

}  // namespace zen_segment
