// K1's register route, second form: the shared core, for runs of outputs
// whose tap set is one or two runs of consecutive offsets.
//
// Replaces, in zen_tpu/ops/median_pallas.py, what K1's per-output network
// (csrc/median_time.cu, tap_median_time_network_kernel) replaces there
// (_time_kernel_pair, _time_kernel, _time_kernel_pipelined,
// _time_kernel_piped), on the calls where the wrapper's rule
// (ops/median_cuda.py, time_network_form) picks it: the same output, bit
// for bit.
//
//   out[c, i, f] = median over o in offsets of V[c, start + i + o, f]
//   V = rows of a [C, Ta, F] followed by rows of b [C, Tb, F]
//   rows outside [0, Ta + Tb) read `fill`
//
// What bounds the per-output network on this card is its selection: each
// output runs the whole pruned network on its own K taps (54 min/max at
// K = 11, 124 at K = 17) and reads its K taps back from a shared-memory
// slot table. Neighbouring outputs share most of their taps: a run of L
// consecutive offsets gives a run of R outputs L - R + 1 taps in common
// and each output R - 1 of its own, so centered K = 11 and median2d's
// filters are one run, hop 256's causal wrap (-21..-17) and (-5..0) two.
// What the design does about it:
// * A thread takes one column and R consecutive output rows (R = kR, a
//   compile-time constant; csrc/time_runs.cuh: 128 columns a block, so a
//   warp's loads and stores are coalesced rows).
// * It loads the rows its R outputs' taps reach, kStaged of them (K +
//   R - 1 for a run of taps, K + 2 (R - 1) for two), into registers: the
//   tap-run shape (each run's length) is compile-time, so every register
//   is indexed at compile time; each run's first offset is a launch
//   parameter. No shared memory, no slot table.
// * zen_core::Shape<ID>::medians (generated by ops/select_network.py,
//   core_program) sorts the shared taps once, pruned to the ranks any of
//   the R medians can read, then for each output sorts its own taps and
//   picks its rank by a merge-select against that window: 20.5 min/max
//   an output at K = 11 (one run, R = 4) in place of 54, 28 at hop 256's
//   two runs (R = 3), 32.5 at K = 17 (R = 4) in place of 124. It is all
//   fminf/fmaxf, so each median is one of its taps, bitwise the element
//   the per-output network and the plain twin pick.
// * bf16 taps convert to float exactly on load and the median converts
//   back to the same bits (zen_rank::to_float, from_float).
// The wrapper builds a shape for each tap-run shape of one or two runs up
// to 63 taps and the R values of fewest min/max an output
// (select_network.core_shapes); a tap set of another shape, or a call
// whose grid would not fill the card at the shape's R, takes the
// per-output network.
#include "time_core.cuh"

#if ZEN_CORE_PARTS != 4
#error "median_time_core_p0.cu .. p3.cu compile the shapes: one source a part"
#endif

namespace zen_core {
ZEN_CORE_DECLARE_PART(0)
ZEN_CORE_DECLARE_PART(1)
ZEN_CORE_DECLARE_PART(2)
ZEN_CORE_DECLARE_PART(3)
}  // namespace zen_core

namespace {

// `firsts` (tap_runs ints) is a host array, the first offset of each tap
// run (the wrapper's time_core_plan); `shape` the id of its tap-run shape
// and R (select_network.core_shapes), whose K must be `k`
template <typename T>
int launch_core(const T* a, const T* b, T* out, int c, int ta, int tb, int f,
                int start, int t_out, const int* firsts, int tap_runs,
                int shape, int k, float fill, void* stream) {
  if (c <= 0 || f <= 0 || t_out <= 0 || tap_runs < 1 ||
      tap_runs > ZEN_CORE_MAX_TAP_RUNS || shape < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  zen_core::Firsts fs{};
  for (int j = 0; j < tap_runs; ++j) fs.first[j] = firsts[j];
  static const zen_core::PartLaunch<T> parts[ZEN_CORE_PARTS] = {
      zen_core::launch_part_0<T>, zen_core::launch_part_1<T>,
      zen_core::launch_part_2<T>, zen_core::launch_part_3<T>};
  return parts[shape % ZEN_CORE_PARTS](a, b, out, c, ta, tb, f, start, t_out,
                                       fs, tap_runs, shape, k, fill,
                                       static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" int zen_tap_median_time_core(const float* a, const float* b,
                                        float* out, int c, int ta, int tb,
                                        int f, int start, int t_out,
                                        const int* firsts, int tap_runs,
                                        int shape, int k, float fill,
                                        void* stream) {
  return launch_core(a, b, out, c, ta, tb, f, start, t_out, firsts, tap_runs,
                     shape, k, fill, stream);
}

extern "C" int zen_tap_median_time_core_bf16(
    const __nv_bfloat16* a, const __nv_bfloat16* b, __nv_bfloat16* out, int c,
    int ta, int tb, int f, int start, int t_out, const int* firsts,
    int tap_runs, int shape, int k, float fill, void* stream) {
  return launch_core(a, b, out, c, ta, tb, f, start, t_out, firsts, tap_runs,
                     shape, k, fill, stream);
}
