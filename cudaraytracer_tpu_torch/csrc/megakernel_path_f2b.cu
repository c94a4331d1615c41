// The path integrator's per-thread instances with front-to-back shells
// (mega_path, K11; megakernel.cuh), compiled apart so that the instances
// build in parallel.
#include "megakernel.cuh"

namespace crt {
template void launch_path<false, true>(const Params&, cudaStream_t);
template void launch_path<true, true>(const Params&, cudaStream_t);
template PathInstance path_of<false, true>(bool, bool, bool, bool);
template PathInstance path_of<true, true>(bool, bool, bool, bool);
}  // namespace crt
