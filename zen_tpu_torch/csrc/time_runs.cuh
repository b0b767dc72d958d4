// The launch geometry of K1's network kernel (csrc/median_time.cu),
// shared with its copy-only mirror rows_copy (csrc/probe_copy.cu), so
// that the mirror's grid and index arithmetic are K1's by construction.
//
// A thread takes one column of one stream and a run of `run` consecutive
// output rows. Block: kThreads consecutive columns of one run, so a
// warp's loads and stores are coalesced rows. Grid: x = stream * n_runs +
// run index (x may reach 2^31 - 1; y and z stop at 65,535, which streams
// times runs passes at a 4-minute track), y = column tile. All of it is
// 32-bit arithmetic, one unsigned division per thread; 64 bits appear
// only in the base pointers the callers form from `c`.
#pragma once

#include <cuda_runtime.h>

namespace zen_runs {

constexpr int kThreads = 128;

struct Unit {
  unsigned c;  // stream
  int i0;      // first output row of the run
  int col;     // column; the thread has no work when col >= f
};

__device__ __forceinline__ Unit unit_of(int run, unsigned n_runs) {
  Unit u;
  u.c = blockIdx.x / n_runs;
  u.i0 = static_cast<int>(blockIdx.x - u.c * n_runs) * run;
  u.col = static_cast<int>(blockIdx.y) * kThreads + static_cast<int>(threadIdx.x);
  return u;
}

// The grid for c streams of t_out output rows by f columns; false when
// it passes the launch limits.
inline bool grid_of(int c, int t_out, int f, int run, dim3* grid,
                    unsigned* n_runs) {
  const long long runs = (static_cast<long long>(t_out) + run - 1) / run;
  const long long x = runs * c;
  const long long y = (static_cast<long long>(f) + kThreads - 1) / kThreads;
  if (x > 2147483647LL || y > 65535) return false;
  *n_runs = static_cast<unsigned>(runs);
  *grid = dim3(static_cast<unsigned>(x), static_cast<unsigned>(y));
  return true;
}

}  // namespace zen_runs
