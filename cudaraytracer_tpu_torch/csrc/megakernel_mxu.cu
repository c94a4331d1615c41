// K12's instances (megakernel.cuh), compiled apart so that the instances
// build in parallel.
#include "megakernel.cuh"

namespace crt {
template void launch_mxu<PATH>(const Params&, cudaStream_t, bool);
template void launch_mxu<LAMBERT>(const Params&, cudaStream_t, bool);
template void launch_mxu<NORMAL>(const Params&, cudaStream_t, bool);
}  // namespace crt
