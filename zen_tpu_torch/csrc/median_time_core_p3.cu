// K1's shared core: the shapes of compile part 3 of ZEN_CORE_PARTS
// (select_network.core_part), in a source of their own so that nvcc builds
// the parts at once; the kernel and its notes are in time_core.cuh and
// median_time_core.cu.
#include "time_core.cuh"

namespace zen_core {
ZEN_CORE_DEFINE_PART(3)
}  // namespace zen_core
