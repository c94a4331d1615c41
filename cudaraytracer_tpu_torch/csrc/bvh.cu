// BVH traversal for NVIDIA Hopper (sm_90a): crt_bvh_traverse.
//
// Replaces no pallas_call.  It replaces the JAX package's traverse_bvh
// (cudaraytracer_tpu/ops/bvh.py:296), a lax.while_loop of jnp gathers in
// which every ray advances its node pointer in lock-step.  As torch ops on
// the card that loop costs some 20 small launches a node visited, so the
// traversal is this kernel: one thread per ray walking the skip links of a
// FlatBVH (ops/bvh.py) from node 0 until node >= n_nodes, the reference's
// own shape (bvh.h:160-190) without its recursion.
//
// Contract (ops/bvh.py traverse_bvh_plain, bit for bit): per step one slab
// test of the node's box (aabb.h:30-43: the strict t_max <= t_min miss, NaN
// a miss); on a hit at an internal node go to node + 1; on a hit at a leaf
// test prim0, then prim1 unless prim1 == prim0, the first strictly smaller
// t winning, in that order; otherwise go to skip[node].  Per ray
// (best_t, best_prim), (BIG, -1) on a miss and on a dead lane.  Built with
// --fmad=false, in the plain version's order of operations:
//   * the slab's min and max propagate NaN, as torch.minimum / maximum and
//     jnp.minimum / maximum do: (lo - o) * inf is NaN where lo == o, and
//     the node is then missed.  fminf / fmaxf and plain min.f32 drop the
//     NaN and would hit it, so they are PTX min.NaN / max.NaN;
//   * Moller-Trumbore is the formula of csrc/sweeps.cu (K4) and of the
//     plain version, its gates |a| >= TRI_EPSILON, u and v in range,
//     back-culling a >= TRI_EPSILON, backface-only dot(d, n) >= 0 and the
//     t window: t < prune_t under no-t-clip (negative t can win), else
//     t_min < t < prune_t;
//   * prune_t is min(best_t, t_max) under SHRINK, else t_max (the
//     reference passes the caller's range down the tree unchanged, so it
//     walks every box the ray crosses), taken at the start of the step for
//     both prims of a leaf;
//   * internal nodes carry prim ids -1: they are never read as ids.
// The modes (SHRINK, BACK_CULLING, BACKFACE_ONLY, NO_T_CLIP and COUNT) are
// template parameters; COUNT is a separately compiled instance that writes
// each ray's box and triangle tests and marks the nodes and triangles any
// ray tested (measurement only; production launches carry no counters).
//
// What bounds it on this card: FP32 issue on the slab tests (24 FLOPs a
// node visited, 46 a triangle tested), and the divergence of a warp whose
// rays walk different paths: a warp steps until its longest walk ends.
// Memory traffic is the rays (24 B in, 8 B out a ray) and the nodes and
// triangles the walks touch (37 B a node, 48 B a triangle), which stay in
// L1 / L2 for the meshes of the animation cells.
//
// What this simple design does about it: nothing yet beyond one thread per
// ray, read-only loads (__ldg) and no stack.  Node packing into two
// float4s, warp-cooperative walks and a shrink-aware near-first order are
// later work (ROADMAP); near-first order would change the visiting order,
// and so the ids under ties.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
//        -shared -Xcompiler -fPIC  (plain C interface, loaded with ctypes;
//        ops/_cuda.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace crt_bvh {

constexpr float BIG = 3.4028235e38f;
constexpr float TRI_EPSILON = 1e-6f;
constexpr int BLOCK = 128;
// ops/bvh.py M_*: the template modes
enum Mode {
  SHRINK = 1, BACK_CULLING = 2, BACKFACE_ONLY = 4, NO_T_CLIP = 8, COUNT = 16
};

struct Args {
  const float* o; const float* d;           // [n, 3]
  const float* bmin; const float* bmax;     // [n_nodes, 3]
  const int* skip; const int* prim0; const int* prim1;   // [n_nodes]
  const unsigned char* is_leaf;             // [n_nodes]
  const float* v0; const float* v1; const float* v2;     // [T, 3]
  const float* nrm;                         // [T, 3]
  const unsigned char* alive;               // [n] or null
  float* out_t; int* out_i;                 // [n]
  int* ray_tests;                           // [2, n] (COUNT)
  unsigned char* node_seen;                 // [n_nodes] (COUNT)
  unsigned char* tri_seen;                  // [T] (COUNT)
  int n, n_nodes;
  float t_min, t_max;
};

// jnp.minimum / jnp.maximum: NaN in, NaN out (fminf would drop it)
__device__ __forceinline__ float nmin(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nmax(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

struct Ray { float ox, oy, oz, dx, dy, dz, ix, iy, iz; };

// The slab test of node k (bvh.py:258-266): t0, t1 per axis, near / far by
// NaN-propagating min / max, then the ray's window.
__device__ __forceinline__ bool box_hit(const Args& P, const Ray& r, int k,
                                        float prune) {
  const float* lo = P.bmin + 3 * (size_t)k;
  const float* hi = P.bmax + 3 * (size_t)k;
  const float tx0 = (__ldg(lo) - r.ox) * r.ix;
  const float ty0 = (__ldg(lo + 1) - r.oy) * r.iy;
  const float tz0 = (__ldg(lo + 2) - r.oz) * r.iz;
  const float tx1 = (__ldg(hi) - r.ox) * r.ix;
  const float ty1 = (__ldg(hi + 1) - r.oy) * r.iy;
  const float tz1 = (__ldg(hi + 2) - r.oz) * r.iz;
  const float near = nmax(nmax(nmax(nmin(tx0, tx1), nmin(ty0, ty1)),
                               nmin(tz0, tz1)), P.t_min);
  const float far = nmin(nmin(nmin(nmax(tx0, tx1), nmax(ty0, ty1)),
                              nmax(tz0, tz1)), prune);
  return far > near;
}

// Moller-Trumbore of triangle j with the quirk gates (bvh.py:269-293) in
// the plain version's order of operations; true with t when it passes.
template <int M>
__device__ __forceinline__ bool tri_test(const Args& P, const Ray& r, int j,
                                         float prune, float& t) {
  const float* p0 = P.v0 + 3 * (size_t)j;
  const float* p1 = P.v1 + 3 * (size_t)j;
  const float* p2 = P.v2 + 3 * (size_t)j;
  const float ax = __ldg(p0), ay = __ldg(p0 + 1), az = __ldg(p0 + 2);
  const float e1x = __ldg(p1) - ax, e1y = __ldg(p1 + 1) - ay,
              e1z = __ldg(p1 + 2) - az;
  const float e2x = __ldg(p2) - ax, e2y = __ldg(p2 + 1) - ay,
              e2z = __ldg(p2 + 2) - az;
  const float hx = r.dy * e2z - r.dz * e2y;
  const float hy = r.dz * e2x - r.dx * e2z;
  const float hz = r.dx * e2y - r.dy * e2x;
  const float a = e1x * hx + e1y * hy + e1z * hz;
  if (!(fabsf(a) >= TRI_EPSILON)) return false;
  if ((M & BACK_CULLING) && !(a >= TRI_EPSILON)) return false;
  const float f = 1.f / a;
  const float sx = r.ox - ax, sy = r.oy - ay, sz = r.oz - az;
  const float u = f * (sx * hx + sy * hy + sz * hz);
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  const float v = f * (r.dx * qx + r.dy * qy + r.dz * qz);
  t = f * (e2x * qx + e2y * qy + e2z * qz);
  if (!((u >= 0.f) && (u <= 1.f) && (v >= 0.f) && (u + v <= 1.f)))
    return false;
  if (M & BACKFACE_ONLY) {
    const float* n = P.nrm + 3 * (size_t)j;
    if (!((r.dx * __ldg(n) + r.dy * __ldg(n + 1) + r.dz * __ldg(n + 2))
          >= 0.f))
      return false;
  }
  if (M & NO_T_CLIP) return t < prune;
  return (t > P.t_min) && (t < prune);
}

template <int M>
__device__ __forceinline__ void traverse(const Args& P) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i >= P.n) return;
  float best_t = BIG;
  int best_i = -1;
  int n_box = 0, n_tri = 0;
  if (!P.alive || P.alive[i]) {
    Ray r;
    r.ox = __ldg(P.o + 3 * (size_t)i);
    r.oy = __ldg(P.o + 3 * (size_t)i + 1);
    r.oz = __ldg(P.o + 3 * (size_t)i + 2);
    r.dx = __ldg(P.d + 3 * (size_t)i);
    r.dy = __ldg(P.d + 3 * (size_t)i + 1);
    r.dz = __ldg(P.d + 3 * (size_t)i + 2);
    r.ix = 1.f / r.dx;
    r.iy = 1.f / r.dy;
    r.iz = 1.f / r.dz;
    int node = 0;
    while (node < P.n_nodes) {
      const float prune = (M & SHRINK) ? nmin(best_t, P.t_max) : P.t_max;
      const bool hit = box_hit(P, r, node, prune);
      const bool leaf = __ldg(P.is_leaf + node) != 0;
      if (M & COUNT) {
        ++n_box;
        P.node_seen[node] = 1;
      }
      if (hit && leaf) {
        const int p0 = __ldg(P.prim0 + node), p1 = __ldg(P.prim1 + node);
        float t;
        if (M & COUNT) {
          ++n_tri;
          P.tri_seen[p0] = 1;
        }
        if (tri_test<M>(P, r, p0, prune, t) && t < best_t) {
          best_t = t;
          best_i = p0;
        }
        if (p1 != p0) {
          if (M & COUNT) {
            ++n_tri;
            P.tri_seen[p1] = 1;
          }
          if (tri_test<M>(P, r, p1, prune, t) && t < best_t) {
            best_t = t;
            best_i = p1;
          }
        }
      }
      node = (hit && !leaf) ? node + 1 : __ldg(P.skip + node);
    }
  }
  P.out_t[i] = best_t;
  P.out_i[i] = best_i;
  if (M & COUNT) {
    P.ray_tests[i] = n_box;
    P.ray_tests[P.n + i] = n_tri;
  }
}

}  // namespace crt_bvh

using namespace crt_bvh;

// The instances, by mode (ptxas -v reports each as crt_bvh_<mode>): the
// bits of ops/bvh.py mode_of.
#define CRT_BVH(M)                                                        \
  extern "C" __global__ void __launch_bounds__(BLOCK) crt_bvh_##M(Args P) { \
    traverse<M>(P);                                                       \
  }
CRT_BVH(0) CRT_BVH(1) CRT_BVH(2) CRT_BVH(3) CRT_BVH(4) CRT_BVH(5)
CRT_BVH(6) CRT_BVH(7) CRT_BVH(8) CRT_BVH(9) CRT_BVH(10) CRT_BVH(11)
CRT_BVH(12) CRT_BVH(13) CRT_BVH(14) CRT_BVH(15) CRT_BVH(16) CRT_BVH(17)
CRT_BVH(18) CRT_BVH(19) CRT_BVH(20) CRT_BVH(21) CRT_BVH(22) CRT_BVH(23)
CRT_BVH(24) CRT_BVH(25) CRT_BVH(26) CRT_BVH(27) CRT_BVH(28) CRT_BVH(29)
CRT_BVH(30) CRT_BVH(31)
#undef CRT_BVH

namespace {

typedef void (*Kernel)(Args);

const Kernel KERNELS[32] = {
    crt_bvh_0,  crt_bvh_1,  crt_bvh_2,  crt_bvh_3,  crt_bvh_4,  crt_bvh_5,
    crt_bvh_6,  crt_bvh_7,  crt_bvh_8,  crt_bvh_9,  crt_bvh_10, crt_bvh_11,
    crt_bvh_12, crt_bvh_13, crt_bvh_14, crt_bvh_15, crt_bvh_16, crt_bvh_17,
    crt_bvh_18, crt_bvh_19, crt_bvh_20, crt_bvh_21, crt_bvh_22, crt_bvh_23,
    crt_bvh_24, crt_bvh_25, crt_bvh_26, crt_bvh_27, crt_bvh_28, crt_bvh_29,
    crt_bvh_30, crt_bvh_31};

}  // namespace

// mode: ops/bvh.py mode_of; the COUNT bit takes ray_tests, node_seen and
// tri_seen (else null).  alive null: every ray is live.
extern "C" int crt_bvh_traverse(
    const void* o, const void* d, const void* bmin, const void* bmax,
    const void* skip, const void* prim0, const void* prim1,
    const void* is_leaf, const void* v0, const void* v1, const void* v2,
    const void* nrm, const void* alive, void* out_t, void* out_i,
    void* ray_tests, void* node_seen, void* tri_seen, int n, int n_nodes,
    int mode, float t_min, float t_max, void* cuda_stream) {
  if (n <= 0) return 0;
  if (mode < 0 || mode > 31) return (int)cudaErrorInvalidValue;
  if ((mode & COUNT) && !(ray_tests && node_seen && tri_seen))
    return (int)cudaErrorInvalidValue;
  Args P{};
  P.o = static_cast<const float*>(o);
  P.d = static_cast<const float*>(d);
  P.bmin = static_cast<const float*>(bmin);
  P.bmax = static_cast<const float*>(bmax);
  P.skip = static_cast<const int*>(skip);
  P.prim0 = static_cast<const int*>(prim0);
  P.prim1 = static_cast<const int*>(prim1);
  P.is_leaf = static_cast<const unsigned char*>(is_leaf);
  P.v0 = static_cast<const float*>(v0);
  P.v1 = static_cast<const float*>(v1);
  P.v2 = static_cast<const float*>(v2);
  P.nrm = static_cast<const float*>(nrm);
  P.alive = static_cast<const unsigned char*>(alive);
  P.out_t = static_cast<float*>(out_t);
  P.out_i = static_cast<int*>(out_i);
  P.ray_tests = static_cast<int*>(ray_tests);
  P.node_seen = static_cast<unsigned char*>(node_seen);
  P.tri_seen = static_cast<unsigned char*>(tri_seen);
  P.n = n;
  P.n_nodes = n_nodes;
  P.t_min = t_min;
  P.t_max = t_max;
  const dim3 grid((n + BLOCK - 1) / BLOCK);
  KERNELS[mode]<<<grid, BLOCK, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
      P);
  return (int)cudaGetLastError();
}

extern "C" const char* crt_bvh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
