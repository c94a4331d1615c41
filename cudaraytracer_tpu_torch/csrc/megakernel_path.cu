// The path integrator's per-thread instances in table order (mega_path;
// megakernel.cuh), compiled apart so that the instances build in parallel.
#include "megakernel.cuh"

namespace crt {
template void launch_path<false, false>(const Params&, cudaStream_t);
template void launch_path<true, false>(const Params&, cudaStream_t);
template PathInstance path_of<false, false>(bool, bool, bool, bool);
template PathInstance path_of<true, false>(bool, bool, bool, bool);
}  // namespace crt
