// The cooperative instances (the path integrator above 8,192 triangles: K6,
// K10 and K11; megakernel.cuh), compiled apart so that the instances build
// in parallel.
#include "megakernel.cuh"

namespace crt {
template void launch_family<PATH, true>(const Params&, cudaStream_t);
}  // namespace crt
