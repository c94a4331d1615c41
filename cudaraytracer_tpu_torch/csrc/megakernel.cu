// Fused path tracer for NVIDIA Hopper (sm_90a): the C interface, the draws
// kernel and the lambert and normal integrators' one-thread-per-ray
// instances.  The kernel, its modes and their design are in megakernel.cuh;
// the cooperative (the path integrator above 8,192 triangles: K6, K10 and
// K11), K12 and per-thread path (mega_path) instances are compiled in
// megakernel_coop.cu, megakernel_mxu.cu, megakernel_path.cu and
// megakernel_path_f2b.cu.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false -c
//        -Xcompiler -fPIC for each source, then nvcc -shared (plain C
//        interface, loaded with ctypes; ops/_cuda.py).

#include "megakernel.cuh"

using namespace crt;

// K2 (ops/pallas_intersect.py::_draws_kernel): out[s, i] = draw(seed, i,
// step + s) for n rays x n_steps bounces, every bounce of a trace in one
// launch.  What bounds it: integer issue (two Philox4x32-10 blocks a draw,
// 20 rounds of two 32-bit multiplies, their high words and two XORs),
// then the transform's FP32 work; the stores are 16 bytes a draw.  The grid
// holds the blocks the SMs keep resident and each thread walks its rays by
// the grid's stride, all of a ray's bounces in turn (the Philox work on
// the ray index alone is done once a ray); a warp's store of one bounce is
// 32 consecutive float4.
extern "C" __global__ void __launch_bounds__(BLOCK) crt_draws(
    float4* out, int n, int n_steps, unsigned long long seed, uint32_t step) {
  const int stride = gridDim.x * BLOCK;
  for (int i = blockIdx.x * BLOCK + threadIdx.x; i < n; i += stride)
    for (int s = 0; s < n_steps; ++s)
      out[(size_t)s * n + i] = draw(seed, (uint32_t)i, step + (uint32_t)s);
}

namespace {

// One launch: K12 when the caller gives the coefficients; the cooperative
// family for the path integrator above 8,192 triangles, unless per_thread
// asks for the one-thread-per-ray sweep or the launch has more shells than
// the cooperative walk keeps a byte for (MAX_SHELLS); else K1's family,
// whose segment level is a runtime branch.  The lambert and normal integrators trace
// camera rays only, coherent, on which the cooperative sweep's ballots and
// syncs cost more than they save (+7% on the 1M-triangle field's frame,
// PERF.md), so they keep one thread per ray.
template <int INTEG>
void launch(const Params& P, cudaStream_t s, bool per_thread) {
  if (P.tri_coef) launch_mxu<INTEG>(P, s, per_thread);
  else if (INTEG == PATH && P.n_tri_segs > 0 && !per_thread &&
           P.f2b <= MAX_SHELLS)
    launch_family<PATH, true>(P, s);
  else launch_family<INTEG, false>(P, s);
}

}  // namespace

extern "C" int crt_mega_trace(
    const void* sph, const void* sph_box, const void* sph_super,
    const void* tri, const void* tri_box, const void* tri_super,
    const void* rect, const void* tsph, const void* ttri,
    const void* sph_map, const void* tri_map,
    const void* o, const void* d, const void* stream, void* out,
    void* winners, void* counts, int n, int n_sph_chunks, int n_sph_supers,
    int n_tri_supers, int n_rects, int n_tsph, int n_ttri, int n_spheres,
    int n_triangles, int integrator, int max_depth, float t_min,
    float t_max, float ambient, int flags, unsigned long long seed,
    const void* images, int img_h, int img_w, const void* sph_seg,
    const void* tri_seg, int n_sph_segs, int n_tri_segs, int f2b,
    int step_lo, int n_steps, void* planes, const void* order, void* key,
    int key_mode, const void* key_bounds, const void* tri_coef, void* touched,
    void* work, void* next, int per_thread, const void* rect_box,
    const void* tsph_box, const void* ttri_box, const void* rect_ord,
    const void* tsph_ord, const void* ttri_ord, int n_rect_chunks,
    int n_tsph_chunks, int n_ttri_chunks, void* cuda_stream) {
  if (winners && (integrator != PATH || counts))
    return (int)cudaErrorInvalidValue;
  // the counting variant adds its schedule counters to work; the path
  // integrator's warps take their rays from the counter next (mega_path,
  // which zeroes it on the stream before its launch)
  if ((counts && !work) || (integrator == PATH && !next))
    return (int)cudaErrorInvalidValue;
  if (images && (integrator == NORMAL || counts))
    return (int)cudaErrorInvalidValue;
  if (step_lo < 0 || n_steps < 1 || step_lo + n_steps > max_depth + 1 ||
      f2b < 0 || (counts && !touched))
    return (int)cudaErrorInvalidValue;
  const bool window = planes || step_lo != 0 || n_steps != max_depth + 1;
  if (window && (integrator != PATH || winners))
    return (int)cudaErrorInvalidValue;
  // K10: a window after step 0 resumes from the planes; an order and keys
  // index them
  if ((step_lo > 0 || order || key) && !planes)
    return (int)cudaErrorInvalidValue;
  if (key && (key_mode < KEY_ALIVE || key_mode > KEY_MORTON))
    return (int)cudaErrorInvalidValue;
  // K12 (taken when tri_coef is given) runs on streamed triangles only,
  // records no winners, fetches no texel and visits no shells
  if (tri_coef && (n_tri_segs <= 0 || winners || images || f2b))
    return (int)cudaErrorInvalidValue;
  // the one-thread-per-ray K12 sweep has a counting instance only
  if (tri_coef && per_thread && !counts) return (int)cudaErrorInvalidValue;
  // K8's chunks: a class with chunks has its Morton order of rows, and
  // ceil(rows / XFORM_CHUNK) of them
  const int nx[3] = {n_rects, n_tsph, n_ttri};
  const int nxc[3] = {n_rect_chunks, n_tsph_chunks, n_ttri_chunks};
  const void* xbox[3] = {rect_box, tsph_box, ttri_box};
  const void* xord[3] = {rect_ord, tsph_ord, ttri_ord};
  Params P;
  for (int c = 0; c < 3; ++c) {
    if (nxc[c] < 0 || (nxc[c] > 0 && (nxc[c] != (nx[c] + XFORM_CHUNK - 1) /
                                                  XFORM_CHUNK ||
                                      !xbox[c] || !xord[c])))
      return (int)cudaErrorInvalidValue;
    P.xbox[c] = static_cast<const float*>(xbox[c]);
    P.xord[c] = static_cast<const int*>(xord[c]);
    P.n_xchunks[c] = nxc[c];
  }
  P.images = static_cast<const uint8_t*>(images);
  P.img_h = img_h;
  P.img_w = img_w;
  P.rect = static_cast<const float*>(rect);
  P.tsph = static_cast<const float*>(tsph);
  P.ttri = static_cast<const float*>(ttri);
  P.sph_map = static_cast<const int*>(sph_map);
  P.tri_map = static_cast<const int*>(tri_map);
  P.winners = static_cast<int*>(winners);
  P.n_rects = n_rects;
  P.n_tsph = n_tsph;
  P.n_ttri = n_ttri;
  P.n_spheres = n_spheres;
  P.n_triangles = n_triangles;
  P.sph = static_cast<const float*>(sph);
  P.sph_box = static_cast<const float*>(sph_box);
  P.sph_super = static_cast<const float*>(sph_super);
  P.tri = static_cast<const float*>(tri);
  P.tri_box = static_cast<const float*>(tri_box);
  P.tri_super = static_cast<const float*>(tri_super);
  P.o = static_cast<const float*>(o);
  P.d = static_cast<const float*>(d);
  P.stream = static_cast<const float*>(stream);
  P.out = static_cast<float*>(out);
  P.counts = static_cast<unsigned long long*>(counts);
  P.touched = static_cast<unsigned char*>(touched);
  P.seed = seed;
  P.n = n;
  P.n_sph_chunks = n_sph_chunks;
  P.n_sph_supers = n_sph_supers;
  P.n_tri_supers = n_tri_supers;
  P.max_depth = max_depth;
  P.flags = flags;
  P.t_min = t_min;
  P.t_max = t_max;
  P.ambient = ambient;
  P.sph_seg = static_cast<const float*>(sph_seg);
  P.tri_seg = static_cast<const float*>(tri_seg);
  P.n_sph_segs = n_sph_segs;
  P.n_tri_segs = n_tri_segs;
  P.f2b = n_tri_supers > 0 ? f2b : 0;
  P.step_lo = step_lo;
  P.n_steps = n_steps;
  P.planes = static_cast<float*>(planes);
  P.order = static_cast<const int*>(order);
  P.key = static_cast<int*>(key);
  P.key_mode = key_mode;
  P.bounds = static_cast<const float*>(key_bounds);
  P.tri_coef = static_cast<const float*>(tri_coef);
  P.work = static_cast<unsigned long long*>(work);
  P.next = static_cast<int*>(next);
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  switch (integrator) {
    case PATH: launch<PATH>(P, s, per_thread); break;
    case LAMBERT: launch<LAMBERT>(P, s, per_thread); break;
    case NORMAL: launch<NORMAL>(P, s, per_thread); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The mega_path instance that a path launch of n rays one thread per ray
// takes (xform: rects or TRS prims; shells: front-to-back shells; count,
// window, winners, tex: the counting variant, a bounce window, K7, K9), on
// the current device, launching nothing: out[0:7] = grid blocks, threads a
// block, resident blocks an SM, SMs, registers and local memory bytes a
// thread, and REFILL_IDLE.
extern "C" int crt_mega_path_instance(int xform, int shells, int count,
                                      int window, int winners, int tex,
                                      int n, int* out) {
  const PathInstance k =
      xform ? (shells ? path_of<true, true>(count, window, winners, tex)
                      : path_of<true, false>(count, window, winners, tex))
            : (shells ? path_of<false, true>(count, window, winners, tex)
                      : path_of<false, false>(count, window, winners, tex));
  cudaFuncAttributes a{};
  int dev = 0, sms = 0;
  cudaError_t e = cudaFuncGetAttributes(&a, k.kernel);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int v[7] = {path_grid(k, n), BLOCK, k.per_sm, sms, a.numRegs,
                    (int)a.localSizeBytes, REFILL_IDLE};
  for (int j = 0; j < 7; ++j) out[j] = v[j];
  return 0;
}

// K2 over bounces [step, step + n_steps): out float32[n_steps, n, 4].  The
// grid: crt_draws's resident blocks an SM (queried once) x the SMs, fewer
// for fewer rays.
extern "C" int crt_scatter_draws(void* out, int n, int n_steps,
                                 unsigned long long seed, int step,
                                 void* cuda_stream) {
  if (n_steps < 1 || step < 0) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  static const int per_sm = [] {
    int blocks = 0;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &blocks, crt_draws, BLOCK, 0) == cudaSuccess ? blocks : 0;
  }();
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid = (int)std::min<long long>(
      (long long)per_sm * sms, ((long long)n + BLOCK - 1) / BLOCK);
  crt_draws<<<grid, BLOCK, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<float4*>(out), n, n_steps, seed, (uint32_t)step);
  return (int)cudaGetLastError();
}

extern "C" const char* crt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
