// K2's shared core: the shapes of compile part 1 of ZEN_CORE_FREQ_PARTS
// (select_network.freq_core_part), in a source of their own so that nvcc
// builds the parts at once; the kernel and its notes are in freq_core.cuh
// and median_freq_core.cu.
#include "freq_core.cuh"

namespace zen_freq_core {
ZEN_FREQ_CORE_DEFINE_PART(1)
}  // namespace zen_freq_core
