// K2's network route, second form: the shared core, for runs of outputs.
//
// Replaces, in zen_tpu/ops/median_pallas.py, what K2's per-output network
// (csrc/median_freq.cu, network_median_kernel) replaces there at K <= 63
// (_freq_kernel_fused, _freq_kernel, _freq_impl_sublane; the hop-1024
// step's K = 47), on the calls where the wrapper's rule (ops/median_cuda.py,
// freq_network_form) picks it: the same output, bit for bit.
//
//   out[r, j] = median over o in [-m, m] of x[r, bnd(j + o)],  m = (K-1)/2
//   (bnd and `valid` as in median_freq.cu)
//
// What bounds the per-output network on this card is its selection: each
// output runs the whole pruned network on its own K samples (66 min/max
// at K = 13, 570 at K = 47, at half the FP32 rate) and loads them from
// shared memory alone. Neighbouring windows share K - 1 samples: a run of R consecutive
// outputs shares K - R + 1 of them (the core) and each output has R - 1
// of its own. What the design does about it:
// * A block stages its row chunk's segment as the network does (a row or
//   an even share of a long one, network_chunk; kNetworkThreads threads,
//   consecutive threads on consecutive samples), but only the halo
//   positions pay for the border's index arithmetic (load_split: the
//   interior loads directly, the at most K - 1 halo samples by the first
//   threads); the network's stage_values takes that arithmetic into every
//   load's code path, which the selection's min/max then wait behind.
// * A persistent grid: block (bx, c) takes chunk c of rows bx, bx +
//   gridDim.x, ... and issues the next row's loads (into registers)
//   before it selects this row's medians, so that they are in flight
//   meanwhile. A first version of this kernel, a block a row chunk,
//   staged and selected one after the other: on an H100, 22.40 us at the
//   512-stream block (about a copy's 14 plus the selection's 8).
// * A thread takes R consecutive outputs j0 .. j0 + R - 1 (R = kR,
//   compile-time) and reads their K + R - 1 samples from shared memory
//   into registers once, as words of A samples (A the largest power of
//   two that divides R, at most 16 bytes): thread t's first word lies at
//   sample t R, so a warp's f32 words hit every bank once at R = 2, 3, 4
//   and 6.
// * zen_core::Shape<ID>::medians (generated by ops/select_network.py,
//   core_program, the schedule K1's shared core runs on one tap run)
//   sorts the core once, pruned to the ranks any of the R medians can
//   read, and merge-selects each output's median from it and the output's
//   own samples: 26.0 min/max an output at K = 13 and R = 3, 25.0 at R =
//   4, in place of 66; 108.5 at K = 47 and R = 8 in place of 570. It is all fminf/fmaxf, so each median is one of its
//   window's samples, bitwise the element the per-output network and the
//   plain twin pick; bf16 samples convert to float exactly and back.
// * The medians go back to shared memory in words of A and the block
//   writes its outputs out together, coalesced.
// * The grid holds as many blocks as the card holds at once
//   (cudaOccupancyMaxActiveBlocksPerMultiprocessor, asked once a kernel),
//   at most a row's a chunk.
// A run past the chunk's last output reads stale shared memory (kSlack
// samples past the segment) and its medians are never written out, so
// any F and any row count work. The border stays a runtime argument, so
// the build grows by shapes x dtypes alone: every one-run shape up to
// ZEN_SELECT_FREQ_MAX_TAPS that select_network.core_shapes builds
// (ZEN_CORE_FOR_EACH_FREQ_SHAPE), two R a K, 59 shapes from K = 5 to 63,
// compiled in ZEN_CORE_FREQ_PARTS sources at once (freq_core.cuh,
// median_freq_core_p*.cu); this source picks the part a shape lies in.
#include "freq_core.cuh"

#if ZEN_CORE_FREQ_PARTS != 4
#error "median_freq_core_p0.cu .. p3.cu compile the shapes: one source a part"
#endif

namespace zen_freq_core {
ZEN_FREQ_CORE_DECLARE_PART(0)
ZEN_FREQ_CORE_DECLARE_PART(1)
ZEN_FREQ_CORE_DECLARE_PART(2)
ZEN_FREQ_CORE_DECLARE_PART(3)
}  // namespace zen_freq_core

namespace {

// `shape`: the id of (K,) and R (select_network.core_shapes), whose K must
// be `k`
template <typename T>
int launch_core(const T* x, T* out, int rows, int f_in, int f_out, int k,
                int mode, int shape, void* stream) {
  const int err = zen_segment::check_args(rows, f_in, f_out, k, mode);
  if (err != 0) return err;
  const int chunk = zen_segment::network_chunk(f_out);
  const int chunks = (f_out + chunk - 1) / chunk;
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  static const zen_freq_core::PartLaunch<T> parts[ZEN_CORE_FREQ_PARTS] = {
      zen_freq_core::launch_part_0<T>, zen_freq_core::launch_part_1<T>,
      zen_freq_core::launch_part_2<T>, zen_freq_core::launch_part_3<T>};
  for (const auto part : parts) {
    const int got = part(x, out, rows, f_in, f_out, k, mode, shape, chunk, chunks,
                         static_cast<cudaStream_t>(stream));
    if (got != zen_freq_core::kNotThisPart) return got;
  }
  return static_cast<int>(cudaErrorInvalidValue);  // not a built one-run shape
}

}  // namespace

extern "C" int zen_sliding_median_core(const float* x, float* out, int rows,
                                       int f_in, int f_out, int k, int mode,
                                       int shape, void* stream) {
  return launch_core(x, out, rows, f_in, f_out, k, mode, shape, stream);
}

extern "C" int zen_sliding_median_core_bf16(const __nv_bfloat16* x,
                                            __nv_bfloat16* out, int rows,
                                            int f_in, int f_out, int k,
                                            int mode, int shape, void* stream) {
  return launch_core(x, out, rows, f_in, f_out, k, mode, shape, stream);
}
