// Closest-hit sweeps over one primitive type for NVIDIA Hopper (sm_90a):
// one thread per ray, kernels K3, K4 and K5 of the port.
//
// Replaces (cudaraytracer_tpu/ops/pallas_intersect.py):
//   * K3 sphere_sweep<CULL, false>: _sphere_kernel (culled) and
//     _sphere_kernel_plain, launched by sphere_best_hit_raw;
//   * K5 sphere_sweep<CULL, true>: _sphere_kernel_attrs, launched by
//     sphere_best_hit_attrs_raw (K3 plus the winner's attribute row);
//   * K4 triangle_sweep<CULL>: _triangle_kernel_culled and _triangle_kernel,
//     launched by _triangle_best_hit_culled / _triangle_best_hit_plain.
//
// What bounds them on this card: FP32 issue on the per-prim tests of the
// chunks a ray reaches (the sphere quadratic, Moller-Trumbore), and
// divergence between the rays of a warp, which reach different chunks.
// Memory traffic is one read of the rays and one write of (t, idx) (and the
// 21-float attribute row for K5); the tables (a few KB to a few hundred
// KB) stay in L1/L2.
//
// What the simple design does about that: each thread walks the chunks of
// 16 prims in table order and, in the culled forms, tests the chunk's box
// against its own running best t, so a chunk costs its 16 tests only for
// the rays that can reach it (the TPU kernel voted per 32x128 tile).  The
// winner is taken on a strict <, so the lowest prim id wins ties within and
// across chunks.  A dead lane (alive false) writes (BIG, -1) and does no
// work.  K5 loads the winner's attribute row once after the sweep instead
// of carrying it through every chunk merge.  Built with --fmad=false, so
// every product and sum rounds on its own, as in the plain PyTorch
// versions (ops/sweeps.py), and the two agree ray for ray.
//
// The slab test, the sphere quadratic and the Moller-Trumbore test are the
// formulas of csrc/megakernel.cu (K1), kept in this file so that the two
// libraries build and change independently.
//
// COUNT: a separately compiled variant that adds the box and prim tests it
// makes to a counts array (measurement only; production launches carry no
// counters).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
//        -shared -Xcompiler -fPIC  (plain C interface, loaded with ctypes;
//        ops/_cuda.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float BIG = 3.4028235e38f;
constexpr float TRI_EPSILON = 1e-6f;
constexpr int PRIM_CHUNK = 16;
constexpr int BOX_COLS = 8;    // lo.xyz hi.xyz | 2 pad
constexpr int TRI_COLS = 12;   // v0 e1 e2 normal
constexpr int BLOCK = 128;
enum TriFlags { BACKFACE_ONLY = 1, NO_T_CLIP = 2, BACK_CULLING = 4 };

struct SphereArgs {
  const float* o; const float* d;
  const float4* tbl;            // [n_chunks * 16] cx cy cz r^2
  const float* box;             // [n_chunks, 8] or null (plain form)
  const unsigned char* alive;   // [n] or null
  const float* attr;            // [n_chunks * 16, n_attr] or null (K3)
  float* out_t; int* out_i; float* out_attr;
  unsigned long long* counts;   // [2] box, sphere tests (COUNT only)
  int n, n_chunks, n_attr;
  float t_min, t_max;
};

struct TriangleArgs {
  const float* o; const float* d;
  const float* tbl;             // [n_chunks * 16, 12]
  const float* box;             // [n_chunks, 8] or null (plain form)
  const unsigned char* alive;
  float* out_t; int* out_i;
  unsigned long long* counts;   // [2] box, triangle tests (COUNT only)
  int n, n_chunks, flags;
  float t_min, t_max;
};

// jnp.minimum / jnp.maximum semantics: NaN in, NaN out (fminf would drop it)
__device__ __forceinline__ float nmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// Negated slab test (pallas_intersect.py:75-99): a ray with d_axis = 0
// whose origin lies on a box plane gives 0 * inf = NaN, and NaN keeps the
// box reachable.
__device__ __forceinline__ bool slab(const float* box, float ox, float oy,
                                     float oz, float ix, float iy, float iz,
                                     float best_t, float lo_cut) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(box));
  const float4 b = __ldg(reinterpret_cast<const float4*>(box + 4));
  const float tx0 = (a.x - ox) * ix, tx1 = (a.w - ox) * ix;
  const float ty0 = (a.y - oy) * iy, ty1 = (b.x - oy) * iy;
  const float tz0 = (a.z - oz) * iz, tz1 = (b.y - oz) * iz;
  const float near = nmax(nmax(nmin(tx0, tx1), nmin(ty0, ty1)),
                          nmin(tz0, tz1));
  const float far = nmin(nmin(nmax(tx0, tx1), nmax(ty0, ty1)),
                         nmax(tz0, tz1));
  return !((far < near) || (far < lo_cut) || (near >= best_t));
}

__device__ __forceinline__ void add_counts(unsigned long long* counts,
                                           unsigned long long box,
                                           unsigned long long prim) {
  for (int off = 16; off > 0; off >>= 1) {
    box += __shfl_down_sync(0xffffffffu, box, off);
    prim += __shfl_down_sync(0xffffffffu, prim, off);
  }
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(counts, box);
    atomicAdd(counts + 1, prim);
  }
}

template <bool CULL, bool ATTRS, bool COUNT>
__global__ void __launch_bounds__(BLOCK) sphere_sweep(SphereArgs P) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  unsigned long long n_box = 0, n_prim = 0;
  if (i < P.n) {
    float best_t = BIG;
    int best_i = -1;
    if (P.alive == nullptr || P.alive[i]) {
      const float ox = P.o[3 * (size_t)i], oy = P.o[3 * (size_t)i + 1],
                  oz = P.o[3 * (size_t)i + 2];
      const float dx = P.d[3 * (size_t)i], dy = P.d[3 * (size_t)i + 1],
                  dz = P.d[3 * (size_t)i + 2];
      const float a = dx * dx + dy * dy + dz * dz;
      const float inv_a = 1.f / a;
      const float ix = 1.f / dx, iy = 1.f / dy, iz = 1.f / dz;
      for (int c = 0; c < P.n_chunks; ++c) {
        if (CULL) {
          if (COUNT) ++n_box;
          // spheres respect [t_min, t_max], so the cut is t_min
          if (!slab(P.box + (size_t)c * BOX_COLS, ox, oy, oz, ix, iy, iz,
                    best_t, P.t_min))
            continue;
        }
        if (COUNT) n_prim += PRIM_CHUNK;
        // half-b quadratic, strict disc > 0, each root times 1/a, nearest
        // root inside (t_min, t_max) (pallas_intersect.py:112-133)
        for (int k = 0; k < PRIM_CHUNK; ++k) {
          const int j = c * PRIM_CHUNK + k;
          const float4 g = __ldg(P.tbl + j);
          const float ocx = ox - g.x, ocy = oy - g.y, ocz = oz - g.z;
          const float b = ocx * dx + ocy * dy + ocz * dz;
          const float cc = ocx * ocx + ocy * ocy + ocz * ocz - g.w;
          const float disc = b * b - a * cc;
          if (disc > 0.f) {
            const float sq = sqrtf(disc);
            const float t0 = (-b - sq) * inv_a;
            const float t1 = (-b + sq) * inv_a;
            const float t = (t0 < P.t_max && t0 > P.t_min) ? t0
                          : ((t1 < P.t_max && t1 > P.t_min) ? t1 : BIG);
            if (t < best_t) { best_t = t; best_i = j; }
          }
        }
      }
    }
    P.out_t[i] = best_t;
    P.out_i[i] = best_i;
    if (ATTRS) {   // miss and dead lanes carry prim 0's row
      const float* row = P.attr + (size_t)(best_i >= 0 ? best_i : 0)
                                  * P.n_attr;
      float* out = P.out_attr + (size_t)i * P.n_attr;
      for (int k = 0; k < P.n_attr; ++k) out[k] = __ldg(row + k);
    }
  }
  if (COUNT) add_counts(P.counts, n_box, n_prim);
}

template <bool CULL, bool COUNT>
__global__ void __launch_bounds__(BLOCK) triangle_sweep(TriangleArgs P) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  unsigned long long n_box = 0, n_prim = 0;
  if (i < P.n) {
    float best_t = BIG;
    int best_i = -1;
    if (P.alive == nullptr || P.alive[i]) {
      const float ox = P.o[3 * (size_t)i], oy = P.o[3 * (size_t)i + 1],
                  oz = P.o[3 * (size_t)i + 2];
      const float dx = P.d[3 * (size_t)i], dy = P.d[3 * (size_t)i + 1],
                  dz = P.d[3 * (size_t)i + 2];
      const float ix = 1.f / dx, iy = 1.f / dy, iz = 1.f / dz;
      // negative t can win under the no-t-clip quirk, so nothing behind
      // the origin is cut there
      const float lo_cut = (P.flags & NO_T_CLIP) ? -BIG : P.t_min;
      for (int c = 0; c < P.n_chunks; ++c) {
        if (CULL) {
          if (COUNT) ++n_box;
          if (!slab(P.box + (size_t)c * BOX_COLS, ox, oy, oz, ix, iy, iz,
                    best_t, lo_cut))
            continue;
        }
        if (COUNT) n_prim += PRIM_CHUNK;
        // Moller-Trumbore with the quirk gates (pallas_intersect.py:
        // 136-174, triangle.h:57-100)
        for (int k = 0; k < PRIM_CHUNK; ++k) {
          const int j = c * PRIM_CHUNK + k;
          const float* row = P.tbl + (size_t)j * TRI_COLS;
          const float4 r0 = __ldg(reinterpret_cast<const float4*>(row));
          const float4 r1 = __ldg(reinterpret_cast<const float4*>(row + 4));
          const float4 r2 = __ldg(reinterpret_cast<const float4*>(row + 8));
          const float e1x = r0.w, e1y = r1.x, e1z = r1.y;
          const float e2x = r1.z, e2y = r1.w, e2z = r2.x;
          const float hx = dy * e2z - dz * e2y;
          const float hy = dz * e2x - dx * e2z;
          const float hz = dx * e2y - dy * e2x;
          const float a = e1x * hx + e1y * hy + e1z * hz;
          if (!(fabsf(a) >= TRI_EPSILON)) continue;
          if ((P.flags & BACK_CULLING) && !(a >= TRI_EPSILON)) continue;
          const float f = 1.f / a;
          const float sx = ox - r0.x, sy = oy - r0.y, sz = oz - r0.z;
          const float u = f * (sx * hx + sy * hy + sz * hz);
          const float qx = sy * e1z - sz * e1y;
          const float qy = sz * e1x - sx * e1z;
          const float qz = sx * e1y - sy * e1x;
          const float v = f * (dx * qx + dy * qy + dz * qz);
          const float t = f * (e2x * qx + e2y * qy + e2z * qz);
          bool valid = (u >= 0.f) && (u <= 1.f) && (v >= 0.f)
                       && (u + v <= 1.f);
          if (P.flags & BACKFACE_ONLY)
            valid = valid && (dx * r2.y + dy * r2.z + dz * r2.w) >= 0.f;
          if (P.flags & NO_T_CLIP) valid = valid && (t < P.t_max);
          else valid = valid && (t > P.t_min) && (t < P.t_max);
          if (valid && t < best_t) { best_t = t; best_i = j; }
        }
      }
    }
    P.out_t[i] = best_t;
    P.out_i[i] = best_i;
  }
  if (COUNT) add_counts(P.counts, n_box, n_prim);
}

template <bool CULL, bool ATTRS>
void launch_sphere(const SphereArgs& P, cudaStream_t s) {
  const dim3 grid((P.n + BLOCK - 1) / BLOCK);
  if (P.counts) sphere_sweep<CULL, ATTRS, true><<<grid, BLOCK, 0, s>>>(P);
  else sphere_sweep<CULL, ATTRS, false><<<grid, BLOCK, 0, s>>>(P);
}

template <bool CULL>
void launch_triangle(const TriangleArgs& P, cudaStream_t s) {
  const dim3 grid((P.n + BLOCK - 1) / BLOCK);
  if (P.counts) triangle_sweep<CULL, true><<<grid, BLOCK, 0, s>>>(P);
  else triangle_sweep<CULL, false><<<grid, BLOCK, 0, s>>>(P);
}

}  // namespace

// box null: plain form; attr null: K3, else K5; counts null: production.
extern "C" int crt_sphere_sweep(
    const void* o, const void* d, const void* tbl, const void* box,
    const void* alive, const void* attr, void* out_t, void* out_i,
    void* out_attr, void* counts, int n, int n_chunks, int n_attr,
    float t_min, float t_max, void* cuda_stream) {
  SphereArgs P;
  P.o = static_cast<const float*>(o);
  P.d = static_cast<const float*>(d);
  P.tbl = static_cast<const float4*>(tbl);
  P.box = static_cast<const float*>(box);
  P.alive = static_cast<const unsigned char*>(alive);
  P.attr = static_cast<const float*>(attr);
  P.out_t = static_cast<float*>(out_t);
  P.out_i = static_cast<int*>(out_i);
  P.out_attr = static_cast<float*>(out_attr);
  P.counts = static_cast<unsigned long long*>(counts);
  P.n = n;
  P.n_chunks = n_chunks;
  P.n_attr = n_attr;
  P.t_min = t_min;
  P.t_max = t_max;
  if (n <= 0) return 0;
  if (attr && !out_attr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  if (box) {
    if (attr) launch_sphere<true, true>(P, s);
    else launch_sphere<true, false>(P, s);
  } else {
    if (attr) launch_sphere<false, true>(P, s);
    else launch_sphere<false, false>(P, s);
  }
  return (int)cudaGetLastError();
}

// box null: plain form; counts null: production.
extern "C" int crt_triangle_sweep(
    const void* o, const void* d, const void* tbl, const void* box,
    const void* alive, void* out_t, void* out_i, void* counts, int n,
    int n_chunks, int flags, float t_min, float t_max, void* cuda_stream) {
  TriangleArgs P;
  P.o = static_cast<const float*>(o);
  P.d = static_cast<const float*>(d);
  P.tbl = static_cast<const float*>(tbl);
  P.box = static_cast<const float*>(box);
  P.alive = static_cast<const unsigned char*>(alive);
  P.out_t = static_cast<float*>(out_t);
  P.out_i = static_cast<int*>(out_i);
  P.counts = static_cast<unsigned long long*>(counts);
  P.n = n;
  P.n_chunks = n_chunks;
  P.flags = flags;
  P.t_min = t_min;
  P.t_max = t_max;
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  if (box) launch_triangle<true>(P, s);
  else launch_triangle<false>(P, s);
  return (int)cudaGetLastError();
}

extern "C" const char* crt_sweeps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
