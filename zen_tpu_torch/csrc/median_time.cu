// K1: time-direction tap median over a virtual row concat.
//
// Replaces, in zen_tpu/ops/median_pallas.py:
//   _time_kernel_pair      (the serving step's median over [hist ++ fresh],
//                           reached through tap_median_time_pair_pallas),
//   _time_kernel           (the one-input form with constant fill, reached
//                           through tap_median_time_pallas when its rows
//                           fit one chunk: the B < history streaming step,
//                           time_filtered_tail, short offline passes),
//   _time_kernel_pipelined (the same form double-buffered over many row
//                           chunks: the offline passes' full-T medians,
//                           e.g. the centered K = 11 of hop 256), and
//   _time_kernel_piped     (the same form with one whole-extent block per
//                           stream for fleets of >= 256 streams: the
//                           512-stream hop-256 step at B < H, f32 or bf16,
//                           and its padded constant-fill branch).
// All four collapse into this file: b may have zero rows, and the TPU's
// row chunking and per-stream blocks are the grid here. Every tap count
// has a kernel, chosen by the wrapper (ops/median_cuda.py, time_route,
// time_call_route): the `register` route's comparator network up to
// ZEN_SELECT_TIME_MAX_TAPS (63) taps, and above it the `rank`, `warp` and
// `select` routes, weighed on the call's geometry, at any span of the
// offsets. Both pick sorted[(K-1)/2], the element jnp.median picks.
// The register route has a second kernel for runs of outputs whose tap
// set is one or two runs of consecutive offsets, the shared core
// (median_time_core.cu); the wrapper picks it per call
// (median_cuda.time_network_form).
//
//   out[c, i, f] = median over o in offsets of V[c, start + i + o, f]
//   V = rows of a [C, Ta, F] followed by rows of b [C, Tb, F]
//   rows outside [0, Ta + Tb) read `fill`
//
// Element types: float and __nv_bfloat16 (the bf16 stream state). A bf16
// tap converts to float exactly, so the float compares rank the same
// elements, and the selected value converts back to the same bf16 bits.
//
// `register`, K up to 63 (K = 3 at hop 1024, 11 at hop 256, 23 at hop
// 128, 47 at 44.1 kHz hop 64, 51 at 48 kHz hop 64). What bounds it on
// this card: the selection, not the bytes. Each output runs a pruned
// odd-even merge network (zen_select::median<K>, generated by
// ops/select_network.py): 54 min/max at K = 11, 364 at K = 33, 570 at
// K = 47, 816 at K = 63, issued at half the FP32 rate; and it reads its K
// taps from shared memory. A first version ranked the K taps by counting
// (2 K^2 compares an output and K separate loads a tap): nine tenths of
// its time at K = 11 went to selecting, 13 to 25 times its bytes bound.
// What the design does about it:
// * The network is straight-line code on a register array with no
//   divergence, one kernel instantiation per K.
// * A thread takes one column and a run of consecutive output rows
//   (csrc/time_runs.cuh: 128 columns a block, 32-bit index arithmetic).
//   Neighbouring output rows share most tap rows, so the thread loads the
//   union of the rows its run's taps reach once (25 rows for a run of 8 at
//   hop 256, 3.1 loads an output in place of 11; 61 for a run of 8 under
//   hop 64's 47 taps), bounds and fill decided on that load. Which rows,
//   and which of them each output's K taps are, depends on the offsets
//   alone: the wrapper computes both per offsets tuple and run
//   (time_network_plan), choosing the run so that the rows fit the byte
//   index of the slot table (kNetMaxStaged), and the launcher passes them
//   in the kernel's parameters.
// * A thread issues its staging loads in batches, predicated, and stores
//   them after (4 a batch up to 16 taps, 16 above): one stream's step is
//   a few dozen blocks, and there the rows' cache round trips, not the
//   selection, are the kernel's time (on an H100, K = 47 at B = 1 took
//   15 us with one load in flight, 8 with sixteen; four keep the K = 11
//   fleets at 32 registers a thread).
// * Registers cannot be indexed by a run-time tap table, so the staged
//   rows live in shared memory, one column per thread (row s of thread t
//   at word s * 128 + t: no bank conflicts, and no barrier, since a
//   thread reads back only what it stored). The loop over the run's rows
//   is a run-time loop around one unrolled network, so any offsets,
//   duplicates included (the replicate border's repeated 0), and any
//   `fill` are just values on wires.
// * The two input pointers remove the concat copy the JAX step pays
//   without the pair kernel.
//
// `rank`, K from 65 (K = 93 at 44.1 kHz hop 32, 401 at 48 kHz hop 8,
// 12,801 at 192 kHz hop 1, 25,601 at 384 kHz hop 1, and tap sets of any
// span). A register array no longer fits, and counting would cost up to
// K^2 tap reads an output (8,649 at K = 93). What bounds it on this card:
// the block's sort of its staged keys, not the bytes. The design, rank
// once and select many (rank_select.cuh): each block takes one column
// and a run of up to 32 output rows; its 128 threads stage the rows the
// run's taps reach (time_rank_rows: 155 for a run of 32 under hop 32's
// two tap runs, not the 215 between their extremes) as (value, row) keys
// in shared memory and bitonic-sort them once; then each lane of the
// first warp, one output row, walks the ranks adding the multiplicity of
// each row in its tap set until the sum passes (K-1)/2. The
// multiplicities come from a table over [min(o), max(o)] (duplicated taps
// count more than once), built by the wrapper and uploaded once per
// offsets tuple, padded with 31 zeros on each side so that a lane reads
// table[row - lane + 31] without a branch: all lanes read one rank (a
// broadcast) and consecutive table words. The shapes of the hop-32 step
// have few outputs, so the kernel is built for latency: the four warps
// keep the staging loads of a unit in flight together and share its
// sort, and the walk reads eight ranks a step. One unit per block spreads
// the work over the SMs: 65 blocks at K = 93 [1, 183 + 32, 65], 493 at
// K = 401 [1, 900, 17].
// Calls of many output rows take the steps instead
// (tap_median_time_steps_kernel; the wrapper weighs both on the call's
// geometry, median_cuda.time_rank_geometry): a block takes 1 to 8
// adjacent columns and a longer run of output rows, its columns' keys
// sorted by warp_merge_sort (rank_select.cuh: a warp a column's 256 keys
// in registers), and a thread takes a lane run of
// consecutive output rows, the first walked from rank 0, each next
// stepped from the previous row's rank after moving its count at the tap
// set's change points (two a run of taps: hop 32's four, median2d's
// contiguous K = 93 two), read at their ranks in an inverse array. Where
// the walk from rank 0 read ~S/2 ranks an output, a step reads ~S/K; and
// adjacent columns turn a staged row's loads and an output row's stores
// into one stretch of 4 * cols bytes, where a column a block touched 4
// bytes of each 32-byte sector (median2d's [41355, 513] at fl 93 on an
// H100: the walk took 2136 us, of which 942 staging and its stores; 160
// rows of 4 columns, 5 rows a thread, 866-873, benches/rank_store.py and
// benches/rank_split.py). A single
// stream's step keeps the walk: its 32 rows a column are too few to pay
// for the inverse and a second walk.
// Every span fits: the keys a block stages depend on the rows its taps
// reach, not on the span between them, and the wrapper halves the run
// (time_rank_run) while they pass 227 KB, down to one output row, which
// stages its distinct taps. A tap that reads fill for every output row of
// a call moves next to V (time_rank_offsets), so the table spans at most
// 2 t_v + 1 rows however far the offsets reach. The table goes into
// shared memory beside the keys where both fit (spans up to about 57,000
// rows); past that the walk reads it from the plan in device memory
// through the read-only cache, where the few words a block's rows touch
// stay cached. Both variants stay: on an H100 the walk over the shared
// table took 10.14 us at hop 32's K = 93 (B = 32), 8.13 at B = 1 and 9.92
// at a span of 16,354 rows, against 10.59, 8.59 and 10.82 reading device
// memory (benches/rank_table.py).
// `warp`, K from 65 to 256, for calls of few outputs (the hop-32 step's
// K = 93: 2080 outputs at B = 32, 65 at B = 1). The rank walk above spends
// its time in the block's barriers and its lanes' serial walks: 65 blocks
// on 132 SMs, each staging about 155 keys and bitonic-sorting 256 over 128
// threads with a __syncthreads a stage, then one lane an output walking
// ~75 ranks (on an H100 80GB HBM3 at 700 W, 10.11 us at B = 32 and 8.13
// at B = 1, against about 5 for an empty launch; the warp route 7.84 and
// 6.46, benches/rank_store.py). A register network does not fit: median<93>
// would be 1580 serial min/max in one thread. So the parallelism goes
// inside the output: a warp takes one output, its lanes hold the taps as
// order bits (S = 4 a lane up to 128 taps, 8 up to 256), read from the
// two inputs through the planned offsets with fill, all in flight at once,
// and zen_rank::warp_sort orders them with __shfl_xor_sync and integer
// min/max (28 stages at S = 4, 15 of them across lanes): no shared
// memory, no barrier, a chain of a few hundred instructions. The wrapper
// weighs it against the walk, the steps and select (median_cuda.
// time_route_costs); many-output calls (median2d's fl 93: 21 M outputs)
// keep the steps, whose sort the outputs share.
// Every tap count fits too, through the `select` route
// (radix_select.cuh), which the wrapper takes wherever it beats the sort
// on the call's geometry (median_cuda.time_rank_pick) and wherever one
// row's distinct taps pass 16,384 keys (the 25,601 of 384 kHz hop 1): a
// block takes one column and a run of output rows (one, where the call
// has few: 192 and 384 kHz hop 1 at B = 32 are 96 outputs, one block
// each), stages the rows the run's taps reach once as 4-byte order bits
// (in shared memory where they fit, else read through L2 on each pass),
// and selects each output row alone: kPasses passes of a digit histogram
// over the staged rows, each row counted table[row - lane + 31] times, as
// in the walk. Nothing is sorted, so a call of a few outputs spreads over
// as many blocks and no block orders tens of thousands of keys alone (a
// sort of one output's keys on one SM lost to torch.kthvalue there). The
// selection's bound on this card is its kPasses reads of the staged rows
// an output and each pass's barrier, not the bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "radix_select.cuh"
#include "rank_select.cuh"
#include "time_runs.cuh"
#include "zen_select.cuh"

namespace {

using zen_rank::from_float;
using zen_rank::to_float;

// one element through the read-only data cache, as float
__device__ __forceinline__ float load_ro(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_ro(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(
      __ldg(reinterpret_cast<const unsigned short*>(p))));
}

constexpr int kNetMaxRun = 16;     // most output rows of a network thread
constexpr int kNetMaxStaged = 256;  // most rows a run may stage (a slot is a byte)

// What a run stages and where each output's taps lie in it, from the
// offsets alone (the wrapper's time_network_plan).
struct NetPlan {
  int staged;              // rows the run's taps reach
  int row[kNetMaxStaged];  // each relative to the run's first output row
  // slot[i * K + q]: which staged row tap q of the run's output row i is
  unsigned char slot[kNetMaxRun * ZEN_SELECT_TIME_MAX_TAPS];
};

template <typename T, int K>
__global__ void __launch_bounds__(zen_runs::kThreads)
tap_median_time_network_kernel(const T* __restrict__ a,
                               const T* __restrict__ b, T* __restrict__ out,
                               int ta, int tb, int f, int start, int t_out,
                               int run, unsigned n_runs, float fill,
                               const __grid_constant__ NetPlan plan) {
  // plan.staged rows of kThreads elements of T; this thread's column
  extern __shared__ __align__(16) unsigned char net_bytes[];
  T* mine = reinterpret_cast<T*>(net_bytes) + threadIdx.x;
  const zen_runs::Unit u = zen_runs::unit_of(run, n_runs);
  if (u.col >= f) return;
  const T* pa = a + static_cast<size_t>(u.c) * ta * f + u.col;
  const T* pb = b + static_cast<size_t>(u.c) * tb * f + u.col;
  const int row0 = start + u.i0;
  const T fill_t = from_float<T>(fill);
  // a batch of predicated loads in flight, then their stores: a load
  // under a branch waits for the store before it, one cache round trip a
  // staged row for a thread of a small grid (one hop-64 stream: 47 rows).
  // Four up to 16 taps keep a thread at 32 registers (the fleets'
  // occupancy); sixteen above, where a small grid waits on round trips.
  constexpr int kBatch = K <= 16 ? 4 : 16;
  for (int s0 = 0; s0 < plan.staged; s0 += kBatch) {
    T x[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const bool live = s0 + q < plan.staged;
      const int r = row0 + plan.row[live ? s0 + q : 0];
      const bool in_a = live && r >= 0 && r < ta;
      const bool in_b = live && r >= ta && r < ta + tb;
      const T* src = in_a ? pa + static_cast<long long>(r) * f
                          : pb + static_cast<long long>(r - ta) * f;
      x[q] = (in_a || in_b) ? *src : fill_t;
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      if (s0 + q < plan.staged) mine[(s0 + q) * zen_runs::kThreads] = x[q];
    }
  }
  const int rows = min(run, t_out - u.i0);
  T* dst = out + (static_cast<size_t>(u.c) * t_out + u.i0) * f + u.col;
  for (int i = 0; i < rows; ++i) {
    float v[K];
#pragma unroll
    for (int q = 0; q < K; ++q) {
      v[q] = to_float(mine[plan.slot[i * K + q] * zen_runs::kThreads]);
    }
    dst[static_cast<long long>(i) * f] = from_float<T>(zen_select::median<K>(v));
  }
}

// one tap of V for the rank kernel's staging, through the read-only data cache
template <typename T>
__device__ __forceinline__ float tap_at(const T* __restrict__ a,
                                        const T* __restrict__ b,
                                        long long c, int ta, int tb, int f,
                                        int col, int r, float fill) {
  if (r >= 0 && r < ta) {
    return load_ro(a + (static_cast<size_t>(c) * ta + r) * f + col);
  }
  if (r >= ta && r < ta + tb) {
    return load_ro(b + (static_cast<size_t>(c) * tb + (r - ta)) * f + col);
  }
  return fill;
}

// the same, branch-free (the row clamped where it reads fill), so that a
// thread's loads of a batch are in flight together
template <typename T>
__device__ __forceinline__ float tap_pred(const T* __restrict__ a,
                                          const T* __restrict__ b,
                                          long long c, int ta, int tb, int f,
                                          int col, int r, float fill) {
  const bool in_a = r >= 0 && r < ta;
  const bool in_b = r >= ta && r < ta + tb;
  const T* src = in_a ? a + (static_cast<size_t>(c) * ta + r) * f + col
                      : b + (static_cast<size_t>(c) * tb + (in_b ? r - ta : 0)) * f + col;
  return in_a || in_b ? load_ro(src) : fill;
}

constexpr int kRun = 32;           // most output rows of a rank-kernel block
constexpr int kStageBatch = 8;     // staging loads a select or steps thread keeps in flight
constexpr int kRankThreads = 128;  // threads that stage and sort them
constexpr int kWarpThreads = 128;  // threads of a warp-route block: four outputs
constexpr int kWarpMaxSlots = 8;   // taps a lane of the warp route holds, at most

// One block per unit: column `col` of stream `c`, output rows i0 + lane
// for lane < run. `plan` holds the multiplicity table (span + 62 ints),
// then the `staged` rows the run's taps reach, relative to its first
// output row's min(o) tap. All kRankThreads threads stage and sort; one
// lane of the first warp per output row walks. kSharedTable: the table is
// copied into shared memory behind the keys; otherwise the walk reads it
// from `plan` through the read-only cache (spans whose table does not fit
// beside the keys).
template <typename T, bool kSharedTable>
__global__ void tap_median_time_rank_kernel(
    const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out,
    int ta, int tb, int f, int start, int t_out, int run,
    const int* __restrict__ plan, int min_o, int span, int staged, int k,
    float fill) {
  extern __shared__ __align__(16) unsigned long long stage[];
  const int n = zen_rank::key_count(staged);
  const int len = span + 2 * (kRun - 1);
  const int* rows = plan + len;
  int* table = reinterpret_cast<int*>(stage + n);
  const int tid = threadIdx.x;
  const int n_runs = (t_out + run - 1) / run;
  const long long unit = blockIdx.x;
  const int col = static_cast<int>(unit % f);
  const long long rest = unit / f;
  const int i0 = static_cast<int>(rest % n_runs) * run;
  const long long c = rest / n_runs;
  if (kSharedTable) {
    for (int q = tid; q < len; q += kRankThreads) table[q] = plan[q];
  }
  const int row0 = start + i0 + min_o;  // the V row of relative row 0
#pragma unroll 4
  for (int s = tid; s < n; s += kRankThreads) {
    unsigned long long key = zen_rank::kPadKey;
    if (s < staged) {
      const int d = rows[s];
      key = zen_rank::make_key(tap_at(a, b, c, ta, tb, f, col, row0 + d, fill), d);
    }
    stage[s] = key;
  }
  __syncthreads();
  const int lane = tid;
  const int i = i0 + lane;
  const bool live = lane < run && i < t_out;
  T* dst = out + (static_cast<size_t>(c) * t_out + i) * f + col;
  if (ZEN_RANK_CUT == 1) {
    if (live) *dst = from_float<T>(zen_rank::value_of(stage[lane]));
    return;
  }
  zen_rank::bitonic_sort(stage, n, tid, kRankThreads);
  if (!live) return;
  if (ZEN_RANK_CUT == 2) {
    *dst = from_float<T>(zen_rank::value_of(stage[lane]));
    return;
  }
  // relative row d is tap d - lane of this lane's output row, counted
  // table[d - lane + 31] times; every tap is staged, so the walk ends
  // before the padding (whose reads count 0)
  const unsigned int mult_at = kRun - 1 - lane;
  const unsigned long long key = zen_rank::walk(
      stage, (k - 1) / 2, [&](unsigned long long kv) {
        const unsigned int q = zen_rank::position_of(kv) + mult_at;
        if (q >= static_cast<unsigned int>(len)) return 0;
        return kSharedTable ? table[q] : __ldg(plan + q);
      });
  *dst = from_float<T>(zen_rank::value_of(key));
}

// The rank route with steps: a unit is `cols` adjacent columns (1, 2, 4
// or 8) of a stream and `run` output rows; each column's group of
// kRankThreads / cols threads sorts its column's keys, and its thread t
// takes output rows t * lane_run .. t * lane_run + lane_run - 1 of it
// (run up to kRankThreads / cols * lane_run): the first walked from rank
// 0, each next stepped from the previous one's rank. Moving from output
// row i to i + 1 changes the count of relative row d by table[q - 1] -
// table[q], q = d - i + 31, only at the tap set's change points, the
// `n_changes` (q, table[q - 1] - table[q]) pairs after the staged rows in
// `plan` (two a run of taps; a repeated tap is a change of its own).
// Adjacent columns make a staged row's loads and an output row's stores
// one stretch of 4 * cols bytes (one column a block touches 4 bytes of
// each 32-byte sector it reads or writes). The sort is warp_merge_sort,
// whose warp slices take the block's four warps over all columns (a warp
// a column where its keys are one slice: no block barrier inside the
// sort) and whose merge passes, past one slice, each column's group.
// Shared memory, for each column: merge_room(n) keys (the keys as staged,
// then the sort's), as many again where sort_spare, and the rank of each
// relative row (inv, span + run - 1 ints, written for the staged rows; a
// change point's row is always staged, as a tap of row i or of row i +
// 1); then the unit's medians (res, run * cols floats), written out
// together at the end, and the table where kSharedTable.
template <typename T, bool kSharedTable>
__global__ void __launch_bounds__(kRankThreads, 8) tap_median_time_steps_kernel(
    const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out,
    int ta, int tb, int f, int start, int t_out, int run,
    const int* __restrict__ plan, int min_o, int span, int staged, int k,
    float fill, int lane_run, int n_changes, int cols) {
  extern __shared__ __align__(16) unsigned long long stage[];
  const int n = zen_rank::key_count(staged);
  const int room = zen_rank::merge_room(n);
  const int len = span + 2 * (kRun - 1);
  const int reach = span + run - 1;  // relative rows
  const int* rows = plan + len;
  const int* changes = rows + staged;
  const int tid = threadIdx.x;
  const int shift = __ffs(cols) - 1;  // cols is a power of two
  const int group = kRankThreads >> shift;
  const int g = (tid << shift) / kRankThreads;  // this thread's column of the unit
  const int gid = tid - g * group;
  // each column's sort buffers: its keys' and, where sort_spare, a second
  const int rooms = zen_rank::sort_spare(n, group) ? 2 : 1;
  unsigned long long* keys = stage + rooms * room * g;
  int* inv = reinterpret_cast<int*>(stage + rooms * room * cols) + reach * g;
  float* res = reinterpret_cast<float*>(stage + rooms * room * cols) + reach * cols;
  int* table = reinterpret_cast<int*>(res + run * cols);
  const int n_runs = (t_out + run - 1) / run;
  const int col_units = (f + cols - 1) / cols;
  const long long unit = blockIdx.x;
  const int col0 = static_cast<int>(unit % col_units) * cols;
  const long long rest = unit / col_units;
  const int i0 = static_cast<int>(rest % n_runs) * run;
  const long long c = rest / n_runs;
  const int width = min(cols, f - col0);  // the unit's columns inside V
  if (kSharedTable) {
    for (int q = tid; q < len; q += kRankThreads) table[q] = plan[q];
  }
  const int row0 = start + i0 + min_o;  // the V row of relative row 0
  // kStageBatch (row, column) pairs a step, columns fastest: their row
  // numbers, then their taps, in flight
  for (int e0 = tid; e0 < n * cols; e0 += kStageBatch * kRankThreads) {
    int d[kStageBatch];
    float v[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int s = (e0 + u * kRankThreads) >> shift;
      d[u] = s < staged ? __ldg(rows + s) : 0;
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int e = e0 + u * kRankThreads;
      v[u] = tap_pred(a, b, c, ta, tb, f, col0 + min(e & (cols - 1), width - 1), row0 + d[u],
                      fill);
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int e = e0 + u * kRankThreads;
      const int s = e >> shift;
      if (s < n) {
        stage[rooms * room * (e & (cols - 1)) + s] =
            s < staged ? zen_rank::make_key(v[u], d[u]) : zen_rank::kPadKey;
      }
    }
  }
  __syncthreads();
  const int live = min(run, t_out - i0);
  T* dst = out + (static_cast<size_t>(c) * t_out + i0) * f + col0;
  // the unit's medians, an output row's columns together
  const auto write_out = [&]() {
    for (int e = tid; e < live * cols; e += kRankThreads) {
      if ((e & (cols - 1)) < width) {
        dst[static_cast<size_t>(e >> shift) * f + (e & (cols - 1))] = from_float<T>(res[e]);
      }
    }
  };
  if (ZEN_RANK_CUT == 1) {
    for (int i = gid; i < live; i += group) res[i * cols + g] = zen_rank::value_of(keys[i]);
    __syncthreads();
    write_out();
    return;
  }
  const unsigned long long* sorted =
      zen_rank::warp_merge_sort(stage, rooms * room, room, cols, n, tid, kRankThreads);
  const auto key = [&](int rank) { return sorted[rank]; };
  if (ZEN_RANK_CUT == 2) {
    for (int i = gid; i < live; i += group) res[i * cols + g] = zen_rank::value_of(key(i));
    __syncthreads();
    write_out();
    return;
  }
  // one scatter: the rank of each staged row
  for (int s = gid; s < staged; s += group) {
    inv[zen_rank::position_of(key(s))] = s;
  }
  __syncthreads();
  const int first = gid * lane_run;
  const int last = min(first + lane_run, live);
  if (first < last && g < width) {
    int i = first;
    // relative row d is tap d - i of output row i, counted table[d - i + 31]
    // times (0 outside the table)
    const auto count = [&](unsigned long long kv) {
      const unsigned int q = zen_rank::position_of(kv) + (kRun - 1) - i;
      if (q >= static_cast<unsigned int>(len)) return 0;
      return kSharedTable ? table[q] : __ldg(plan + q);
    };
    const int m = (k - 1) / 2;
    int at = 0, below = 0;
    res[i * cols + g] =
        zen_rank::value_of(zen_rank::walk_from_zero(key, m, count, &at, &below));
    for (++i; i < last; ++i) {
      for (int e = 0; e < n_changes; ++e) {
        const int d = __ldg(changes + 2 * e) + i - kRun;  // q + (i - 1) - 31
        if (inv[d] < at) below += __ldg(changes + 2 * e + 1);
      }
      res[i * cols + g] = zen_rank::value_of(zen_rank::step(key, m, count, &at, &below));
    }
  }
  __syncthreads();
  write_out();
}

// The select route: one block per unit, as the rank kernel's (one
// column, a run of output rows), `plan` the same table and staged rows.
// kShared: the staged rows' order bits in shared memory, otherwise each
// pass reads them from V through L2; kHist: the threads' bins in shared
// memory after them (zen_pick::layout). Each output row of the run in
// turn: zen_pick::select over the staged rows, row d counted table[d -
// lane + 31] times, or once where `unit` (a run of one whose taps are
// distinct: every staged row is one tap, and the table is not read).
template <typename T, bool kShared, bool kHist>
__global__ void __launch_bounds__(zen_pick::kMaxThreads)
tap_median_time_select_kernel(
    const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out,
    int ta, int tb, int f, int start, int t_out, int run,
    const int* __restrict__ plan, int span, int staged, int k, int min_o,
    float fill, int unit) {
  extern __shared__ __align__(16) unsigned int bits[];
  __shared__ zen_pick::Shared sh;
  int* hist = kHist ? reinterpret_cast<int*>(bits + (kShared ? staged : 0)) : nullptr;
  const int len = span + 2 * (kRun - 1);
  const int* rows = plan + len;
  const int n_runs = (t_out + run - 1) / run;
  const long long unit_id = blockIdx.x;
  const int col = static_cast<int>(unit_id % f);
  const long long rest = unit_id / f;
  const int i0 = static_cast<int>(rest % n_runs) * run;
  const long long c = rest / n_runs;
  const int row0 = start + i0 + min_o;  // the V row of relative row 0
  const auto load = [&](int e) {
    return zen_rank::order_bits(
        tap_pred(a, b, c, ta, tb, f, col, row0 + __ldg(rows + e), fill));
  };
  zen_pick::begin(&sh, hist);
  __syncthreads();
  if (kShared) {
    // kStageBatch rows a step: their row numbers, then their taps, in flight
    unsigned int lo = ~0u, hi = 0u;
    for (int e0 = threadIdx.x; e0 < staged; e0 += kStageBatch * blockDim.x) {
      int d[kStageBatch];
      float v[kStageBatch];
#pragma unroll
      for (int u = 0; u < kStageBatch; ++u) {
        const int e = e0 + u * blockDim.x;
        d[u] = e < staged ? __ldg(rows + e) : 0;
      }
#pragma unroll
      for (int u = 0; u < kStageBatch; ++u) {
        v[u] = tap_pred(a, b, c, ta, tb, f, col, row0 + d[u], fill);
      }
#pragma unroll
      for (int u = 0; u < kStageBatch; ++u) {
        const int e = e0 + u * blockDim.x;
        if (e < staged) {
          const unsigned int o = zen_rank::order_bits(v[u]);
          bits[e] = o;
          lo = min(lo, o);
          hi = max(hi, o);
        }
      }
    }
    zen_pick::stage_range(&sh, lo, hi);
  }
  __syncthreads();
  int tick = 0;
  for (int lane = 0; lane < run && i0 + lane < t_out; ++lane) {
    const int* mult = plan + (kRun - 1 - lane);  // mult[d]: row d's taps
    const unsigned int key = zen_pick::select<kHist>(
        staged, (k - 1) / 2,
        [&](int e) { return kShared ? bits[e] : load(e); },
        [&](int e) { return unit ? 1 : __ldg(mult + __ldg(rows + e)); }, &sh, hist, tick);
    if (threadIdx.x == 0) {
      out[(static_cast<size_t>(c) * t_out + i0 + lane) * f + col] =
          from_float<T>(zen_rank::value_of_bits(key));
    }
  }
}

// The warp route: a warp an output row's column, kWarpThreads / 32
// consecutive outputs (adjacent columns of one output row, mostly) a
// block. Lane l holds taps l, l + 32, ..., l + 32 (S - 1) of the output
// (`offs`, the planned offsets, K of them, on the device) as order bits,
// ~0u past K, all loads in flight at once; zen_rank::warp_sort orders the
// 32 S values across the warp and lane 0 writes element (K - 1) / 2.
template <typename T, int S>
__global__ void __launch_bounds__(kWarpThreads)
tap_median_time_warp_kernel(const T* __restrict__ a, const T* __restrict__ b,
                            T* __restrict__ out, int ta, int tb, int f, int start,
                            int t_out, long long outputs, const int* __restrict__ offs,
                            int k, float fill) {
  const int lane = threadIdx.x & 31;
  const long long unit =
      static_cast<long long>(blockIdx.x) * (kWarpThreads / 32) + (threadIdx.x >> 5);
  if (unit >= outputs) return;  // the whole warp: one output
  const int col = static_cast<int>(unit % f);
  const long long rest = unit / f;
  const int i = static_cast<int>(rest % t_out);
  const long long c = rest / t_out;
  const int row0 = start + i;
  int o[S];
#pragma unroll
  for (int j = 0; j < S; ++j) o[j] = j * 32 + lane < k ? __ldg(offs + j * 32 + lane) : 0;
  float x[S];
#pragma unroll
  for (int j = 0; j < S; ++j) {
    x[j] = j * 32 + lane < k ? tap_pred(a, b, c, ta, tb, f, col, row0 + o[j], fill) : 0.0f;
  }
  unsigned int v[S];
#pragma unroll
  for (int j = 0; j < S; ++j) v[j] = j * 32 + lane < k ? zen_rank::order_bits(x[j]) : ~0u;
  zen_rank::warp_sort<S>(v, lane);
  // element h = (K - 1) / 2 lies in lane h / S, slot h % S
  const int h = (k - 1) / 2;
  unsigned int mine = v[0];
#pragma unroll
  for (int j = 1; j < S; ++j) {
    if (j == h % S) mine = v[j];
  }
  const unsigned int med = __shfl_sync(0xffffffffu, mine, h / S);
  if (lane == 0) {
    out[(static_cast<size_t>(c) * t_out + i) * f + col] =
        from_float<T>(zen_rank::value_of_bits(med));
  }
}

// K <= ZEN_SELECT_TIME_MAX_TAPS: `rows` (staged ints) and `slots` (run * k
// ints below staged) are host arrays, the wrapper's time_network_plan
template <typename T>
int launch_network(const T* a, const T* b, T* out, int c, int ta, int tb,
                   int f, int start, int t_out, const int* rows, int staged,
                   const int* slots, int run, int k, float fill,
                   void* stream) {
  if (k < 1 || k > ZEN_SELECT_TIME_MAX_TAPS || k % 2 == 0 || c <= 0 || f <= 0 ||
      t_out <= 0 || run < 1 || run > kNetMaxRun || staged < 1 ||
      staged > kNetMaxStaged) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  NetPlan plan;
  plan.staged = staged;
  for (int s = 0; s < staged; ++s) plan.row[s] = rows[s];
  for (int q = 0; q < run * k; ++q) {
    if (slots[q] < 0 || slots[q] >= staged) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    plan.slot[q] = static_cast<unsigned char>(slots[q]);
  }
  dim3 grid;
  unsigned n_runs = 0;
  if (!zen_runs::grid_of(c, t_out, f, run, &grid, &n_runs)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(staged) * zen_runs::kThreads * sizeof(T);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
#define ZEN_NETWORK_CASE(K)                                                  \
  case K: {                                                                  \
    const int err = zen_rank::opt_in(                                        \
        reinterpret_cast<const void*>(tap_median_time_network_kernel<T, K>), \
        smem);                                                               \
    if (err != 0) return err;                                                \
    tap_median_time_network_kernel<T, K><<<grid, zen_runs::kThreads, smem,   \
                                           s>>>(                             \
        a, b, out, ta, tb, f, start, t_out, run, n_runs, fill, plan);        \
    break;                                                                   \
  }
    ZEN_SELECT_FOR_EACH_TIME_K(ZEN_NETWORK_CASE)
#undef ZEN_NETWORK_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// `plan` is a device buffer: span + 62 ints (31 zeros, the count of each
// offset min_o .. min_o + span - 1, 31 zeros), then `staged` rows. The
// block takes the keys (the wrapper's time_rank_keys reckons the same
// bytes and picks the run they fit), and the table too where both fit
// what a block may opt into.
// lane_run 1: the walk from rank 0 for every output row, run up to kRun,
// one column a block; lane_run > 1: the steps over `cols` columns a block
// (1, 2, 4 or 8), run up to kRankThreads / cols * lane_run, each column's
// key buffers and inverse ranks (span + run - 1 ints), the unit's
// medians, and `plan` followed by the tap set's n_changes change points
// (the wrapper's time_rank_changes).
template <typename T>
int launch_rank(const T* a, const T* b, T* out, int c, int ta, int tb, int f,
                int start, int t_out, const int* plan, int min_o, int span,
                int staged, int run, int k, float fill, int lane_run,
                int n_changes, int cols, void* stream) {
  if (k < 1 || k % 2 == 0 || c <= 0 || f <= 0 || t_out <= 0 || span < 1 ||
      run < 1 || lane_run < 1 || staged < 1 || staged > run - 1 + span ||
      (lane_run == 1 ? run > kRun || cols != 1
                     : (cols != 1 && cols != 2 && cols != 4 && cols != 8) ||
                           run > kRankThreads / cols * lane_run || n_changes < 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int optin = 0;
  int err = zen_rank::optin_bytes(&optin);
  if (err != 0) return err;
  // lane_run > 1: for each column the sort's buffers and the inverse
  // ranks, then the unit's medians
  const int n = zen_rank::key_count(staged);
  const size_t keys =
      lane_run == 1
          ? static_cast<size_t>(n) * sizeof(unsigned long long)
          : cols * ((zen_rank::sort_spare(n, kRankThreads / cols) ? 2 : 1) *
                        static_cast<size_t>(zen_rank::merge_room(n)) * sizeof(unsigned long long) +
                    (static_cast<size_t>(span) + run - 1) * sizeof(int)) +
                static_cast<size_t>(run) * cols * sizeof(float);
  const size_t table = (static_cast<size_t>(span) + 2 * (kRun - 1)) * sizeof(int);
  const bool shared_table = keys + table <= static_cast<size_t>(optin);
  const size_t smem = keys + (shared_table ? table : 0);
  const auto walk = shared_table ? tap_median_time_rank_kernel<T, true>
                                 : tap_median_time_rank_kernel<T, false>;
  const auto steps = shared_table ? tap_median_time_steps_kernel<T, true>
                                  : tap_median_time_steps_kernel<T, false>;
  err = zen_rank::opt_in(lane_run == 1 ? reinterpret_cast<const void*>(walk)
                                       : reinterpret_cast<const void*>(steps),
                         smem, optin);
  if (err != 0) return err;
  const int n_runs = (t_out + run - 1) / run;
  const long long units = static_cast<long long>(c) * n_runs * ((f + cols - 1) / cols);
  if (units > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lane_run == 1) {
    walk<<<static_cast<unsigned>(units), kRankThreads, smem, s>>>(
        a, b, out, ta, tb, f, start, t_out, run, plan, min_o, span, staged, k, fill);
  } else {
    steps<<<static_cast<unsigned>(units), kRankThreads, smem, s>>>(
        a, b, out, ta, tb, f, start, t_out, run, plan, min_o, span, staged, k, fill,
        lane_run, n_changes, cols);
  }
  return static_cast<int>(cudaGetLastError());
}

// The select route on launch_rank's plan and checks, `threads` a block
// (a power of two, 64 to zen_pick::kMaxThreads: the wrapper's
// select_threads, time_select_plan), `unit` where every staged row counts
// once (the wrapper's time_select_unit); the staged rows' order bits and
// the threads' bins go to shared memory as zen_pick::layout fits them,
// the bins only where `shared_bins` (the wrapper's select_shared_bins).
template <typename T>
int launch_select(const T* a, const T* b, T* out, int c, int ta, int tb, int f,
                  int start, int t_out, const int* plan, int min_o, int span,
                  int staged, int run, int k, float fill, int threads, int unit,
                  int shared_bins, void* stream) {
  if (k < 1 || k % 2 == 0 || c <= 0 || f <= 0 || t_out <= 0 || span < 1 ||
      run < 1 || run > kRun || staged < 1 || staged > kRun - 1 + span ||
      threads < 64 || threads > zen_pick::kMaxThreads || (threads & (threads - 1)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int optin = 0;
  int err = zen_rank::optin_bytes(&optin);
  if (err != 0) return err;
  const zen_pick::Layout at = zen_pick::layout(staged, threads, optin, shared_bins != 0);
  const auto kernel = at.shared ? (at.hist ? tap_median_time_select_kernel<T, true, true>
                                           : tap_median_time_select_kernel<T, true, false>)
                                : tap_median_time_select_kernel<T, false, true>;
  err = zen_rank::opt_in(reinterpret_cast<const void*>(kernel), at.bytes,
                         optin - static_cast<int>(sizeof(zen_pick::Shared)));
  if (err != 0) return err;
  const int n_runs = (t_out + run - 1) / run;
  const long long units = static_cast<long long>(c) * n_runs * f;
  if (units > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(units), threads, at.bytes,
           static_cast<cudaStream_t>(stream)>>>(
      a, b, out, ta, tb, f, start, t_out, run, plan, span, staged, k, min_o,
      fill, unit);
  return static_cast<int>(cudaGetLastError());
}

// The warp route: `offs` a device buffer of the k planned offsets
// (the wrapper's time_rank_offsets), `slots` taps a lane (4 or 8: up to
// 128 or 256 taps, the wrapper's time_warp_slots)
template <typename T>
int launch_warp(const T* a, const T* b, T* out, int c, int ta, int tb, int f, int start,
                int t_out, const int* offs, int k, float fill, int slots, void* stream) {
  if (k < 1 || k % 2 == 0 || c <= 0 || f <= 0 || t_out <= 0 ||
      (slots != 4 && slots != kWarpMaxSlots) || k > 32 * slots) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long outputs = static_cast<long long>(c) * t_out * f;
  const long long blocks = (outputs + kWarpThreads / 32 - 1) / (kWarpThreads / 32);
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (slots == 4) {
    tap_median_time_warp_kernel<T, 4><<<static_cast<unsigned>(blocks), kWarpThreads, 0, s>>>(
        a, b, out, ta, tb, f, start, t_out, outputs, offs, k, fill);
  } else {
    tap_median_time_warp_kernel<T, kWarpMaxSlots>
        <<<static_cast<unsigned>(blocks), kWarpThreads, 0, s>>>(
            a, b, out, ta, tb, f, start, t_out, outputs, offs, k, fill);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int zen_tap_median_time_network(
    const float* a, const float* b, float* out, int c, int ta, int tb, int f,
    int start, int t_out, const int* rows, int staged, const int* slots,
    int run, int k, float fill, void* stream) {
  return launch_network(a, b, out, c, ta, tb, f, start, t_out, rows, staged,
                        slots, run, k, fill, stream);
}

extern "C" int zen_tap_median_time_network_bf16(
    const __nv_bfloat16* a, const __nv_bfloat16* b, __nv_bfloat16* out, int c,
    int ta, int tb, int f, int start, int t_out, const int* rows, int staged,
    const int* slots, int run, int k, float fill, void* stream) {
  return launch_network(a, b, out, c, ta, tb, f, start, t_out, rows, staged,
                        slots, run, k, fill, stream);
}

extern "C" int zen_tap_median_time_rank(const float* a, const float* b,
                                        float* out, int c, int ta, int tb,
                                        int f, int start, int t_out,
                                        const int* plan, int min_o, int span,
                                        int staged, int run, int k, float fill,
                                        int lane_run, int n_changes, int cols,
                                        void* stream) {
  return launch_rank(a, b, out, c, ta, tb, f, start, t_out, plan, min_o, span,
                     staged, run, k, fill, lane_run, n_changes, cols, stream);
}

extern "C" int zen_tap_median_time_rank_bf16(
    const __nv_bfloat16* a, const __nv_bfloat16* b, __nv_bfloat16* out, int c,
    int ta, int tb, int f, int start, int t_out, const int* plan, int min_o,
    int span, int staged, int run, int k, float fill, int lane_run,
    int n_changes, int cols, void* stream) {
  return launch_rank(a, b, out, c, ta, tb, f, start, t_out, plan, min_o, span,
                     staged, run, k, fill, lane_run, n_changes, cols, stream);
}

extern "C" int zen_tap_median_time_select(
    const float* a, const float* b, float* out, int c, int ta, int tb, int f,
    int start, int t_out, const int* plan, int min_o, int span, int staged,
    int run, int k, float fill, int threads, int unit, int shared_bins, void* stream) {
  return launch_select(a, b, out, c, ta, tb, f, start, t_out, plan, min_o,
                       span, staged, run, k, fill, threads, unit, shared_bins, stream);
}

extern "C" int zen_tap_median_time_select_bf16(
    const __nv_bfloat16* a, const __nv_bfloat16* b, __nv_bfloat16* out, int c,
    int ta, int tb, int f, int start, int t_out, const int* plan, int min_o,
    int span, int staged, int run, int k, float fill, int threads, int unit,
    int shared_bins, void* stream) {
  return launch_select(a, b, out, c, ta, tb, f, start, t_out, plan, min_o,
                       span, staged, run, k, fill, threads, unit, shared_bins, stream);
}

extern "C" int zen_tap_median_time_warp(const float* a, const float* b, float* out, int c,
                                        int ta, int tb, int f, int start, int t_out,
                                        const int* offs, int k, float fill, int slots,
                                        void* stream) {
  return launch_warp(a, b, out, c, ta, tb, f, start, t_out, offs, k, fill, slots, stream);
}

extern "C" int zen_tap_median_time_warp_bf16(const __nv_bfloat16* a, const __nv_bfloat16* b,
                                             __nv_bfloat16* out, int c, int ta, int tb, int f,
                                             int start, int t_out, const int* offs, int k,
                                             float fill, int slots, void* stream) {
  return launch_warp(a, b, out, c, ta, tb, f, start, t_out, offs, k, fill, slots, stream);
}

extern "C" const char* zen_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
