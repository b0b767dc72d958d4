// K2's row-segment staging, shared by K2's rank route
// (csrc/median_freq.cu) and its copy-only mirror segment_copy
// (csrc/probe_copy.cu), so that the mirror's access pattern is K2's by
// construction.
//
// A block of `count` threads stages the `need` samples its outputs'
// windows reach, row positions base .. base + need - 1 with the boundary
// rule applied on the load, as 64-bit (value order bits, position) keys
// in shared memory, padded with kPadKey up to key_count(need) keys.
#pragma once

#include <cuda_runtime.h>

#include "rank_select.cuh"

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
