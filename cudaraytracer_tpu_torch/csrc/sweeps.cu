// Closest-hit sweeps over one primitive type for NVIDIA Hopper (sm_90a):
// kernels K3, K4 and K5 of the port, and the winner sum crt_winner_add
// that their winner-only backwards use (its own note, below the sweeps).
//
// Replaces (cudaraytracer_tpu/ops/pallas_intersect.py):
//   * K3 crt_sph_*: _sphere_kernel (culled) and _sphere_kernel_plain,
//     launched by sphere_best_hit_raw;
//   * K5 crt_sph_*_attrs: _sphere_kernel_attrs, launched by
//     sphere_best_hit_attrs_raw (K3 plus the winner's attribute row);
//   * K4 crt_tri_*: _triangle_kernel_culled and _triangle_kernel, launched
//     by _triangle_best_hit_culled / _triangle_best_hit_plain.
//
// Contract kept from the TPU kernels: per-ray (t, idx), (BIG, -1) on a miss
// and on a dead lane; the nearest in-range sphere root; Moller-Trumbore
// with the quirk gates as launch flags; the first prim wins ties (a strict
// < in table order); padding (the last prim repeated) never wins; the
// negated slab test, where NaN keeps a box reachable.  Built with
// --fmad=false, so every product and sum rounds on its own, as in the
// plain PyTorch versions (ops/sweeps.py).
//
// What the culled forms guarantee against the plain ones (brute force):
//   * triangles: each box is widened by TRI_MARGIN x (its largest
//     |coordinate|, in the table, + the ray origin's, here).  ops/sweeps.py
//     (TRI_MARGIN) derives the bound: a hit that Moller-Trumbore accepts
//     with |a| >= TRI_WELL |d| |e1| |e2| lies inside that box with room
//     for the slab's own rounding, so no level culls it while it would
//     beat the running best.  A ray whose plain winner is such a hit (or
//     that the plain version misses) gets the plain version's (t, idx);
//     a ray grazing a sliver below that may lose its hit to the cull, as
//     to the TPU kernel's exact boxes (chip_smoke.py and the card tests
//     count them on a cylinder of slivers);
//   * spheres: each box is widened by SPH_MARGIN x (its largest
//     |coordinate| + the ray origin's).  ops/sweeps.py (SPH_MARGIN)
//     derives it from the half-b quadratic's rounding, the |oc|^2 - r^2
//     cancellation included: a root the quadratic accepts lies inside that
//     box, so the culled sweep gives the plain version's (t, idx) on every
//     ray.  The TPU kernel's exact boxes can lose a ray tangent to a
//     sphere, whose computed discriminant is positive on a line that
//     misses the sphere by up to sqrt(u) |oc|.
//
// What bounds them on this card: FP32 issue, first on the box walk (a slab
// test per box per ray: on a 5,120-triangle mesh 320 chunk boxes, three
// quarters of the counted work), then on the prim tests of the chunks a
// ray reaches; on bounce launches also the divergence between the rays of
// a warp, which reach different chunks, and the dead lanes of the alive
// mask.  Memory traffic is one read of the rays and one write of (t, idx)
// (and K5's 21-float row, 84 bytes a ray: on a few spheres that write is
// K5's whole cost); the tables stay in L1/L2.
//
// What the design does about that:
//   * two box levels: a super box over 16 chunk boxes (256 prims), walked
//     in table order and gated by the same slab against the running best
//     t.  Rounding is monotone, so a super culls a ray only where each of
//     its chunks would; the one exception, a chunk whose slab reads NaN
//     (an axis-parallel ray whose origin lies on one of its planes), is
//     ruled out by taking the super level only for rays whose three
//     inverse direction components are finite and non-zero (monotone);
//   * a block compacts the live rays of its 128-ray tile (ballot and
//     prefix sum into shared memory) and its warps serve only those; the
//     dead ones get (BIG, -1) in the tile pass (K3, K4; K5 keeps each ray
//     on its own lane, below);
//   * COOP (culled triangle launches, and sphere launches with an alive
//     mask: the wrapper's choice, measured on the card) walks the boxes
//     with the warp in lockstep and the lanes split a reached chunk's
//     (ray, prim) tests, 16 prims x 2 rays a pass, each ray's least
//     (t, row) coming back by a shared-memory atomicMin on an
//     order-preserving key (as K6's tri_chunk_coop, csrc/megakernel.cuh).
//     A chunk reached by more than COOP_LANE_RAYS rays is tested one ray
//     per lane.  Sphere camera launches keep one thread per ray: there the
//     split's shuffles cost more than the short sphere test saves;
//   * the slab's NaN-keeping min / max are PTX min.NaN / max.NaN, one
//     instruction each.  Only the cull decisions read the slab, and a
//     -0 / +0 difference changes none of them.
// So every test and decision is the one-thread-per-ray sweep's; only the
// thread that serves a ray changes.  K5 loads the winner's attribute row
// once after the sweep and writes it as planes, one per attribute (the TPU
// kernel's own output form), so that a warp's store of an attribute covers
// 32 consecutive floats where a row a thread touched 32 sectors a store.
// The slab test, the sphere quadratic and the Moller-Trumbore test are the
// formulas of csrc/megakernel.cuh (K1), kept in this file so that the two
// libraries build and change independently.
//
// COUNT: separately compiled instances that add their tests to a counts
// array (measurement only; production launches carry no counters): box
// and prim tests, and the warp steps of each (a slab or a prim test issued
// by a warp), so that tests / (32 x steps) is the lanes' use.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
//        -shared -Xcompiler -fPIC  (plain C interface, loaded with ctypes;
//        ops/_cuda.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace crt_sweeps {

constexpr float BIG = 3.4028235e38f;
constexpr float TRI_EPSILON = 1e-6f;
// ops/sweeps.py TRI_MARGIN: the share of the ray origin's largest
// |coordinate| by which a ray widens every triangle box it tests
constexpr float TRI_MARGIN = 9.765625e-4f;   // 2^-10
// ops/sweeps.py SPH_MARGIN: the same for sphere boxes
constexpr float SPH_MARGIN = 3.90625e-3f;    // 2^-8
constexpr int PRIM_CHUNK = 16;
constexpr int CHUNKS_PER_SUPER = 16;   // 256 prims per super box
constexpr int BOX_COLS = 8;    // lo.xyz hi.xyz | 2 pad
constexpr int TRI_COLS = 12;   // v0 e1 e2 normal
// K5's attributes a prim on the main path: centre, radius, material and
// the 16 decode columns (ops/intersect.py sphere_attr_table)
constexpr int PATH_ATTRS = 21;
constexpr int BLOCK = 128;
constexpr int WARPS = BLOCK / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long NO_KEY = ~0ull;
// the most rays of a reached chunk that the lanes still split (above it
// each lane tests its own ray's 16 prims), as K6's
constexpr int COOP_LANE_RAYS = 16;
enum TriFlags { BACKFACE_ONLY = 1, NO_T_CLIP = 2, BACK_CULLING = 4 };
// ops/sweeps.py COUNT_NAMES
enum CountIdx { C_BOX = 0, C_PRIM, C_BOX_STEP, C_PRIM_STEP, N_COUNTS };

struct Args {
  const float* o; const float* d;
  const float* tbl;             // spheres [n_chunks * 16, 4] cx cy cz r^2;
                                // triangles [n_chunks * 16, 12]
  const float* box;             // [n_chunks, 8] or null (plain form)
  const float* sup;             // [ceil(n_chunks / 16), 8] or null
  const unsigned char* alive;   // [n] or null
  const float* attr;            // [n_chunks * 16, n_attr] or null (K3)
  float* out_t; int* out_i;
  float* out_attr;              // [n_attr, n] (K5)
  unsigned long long* counts;   // [N_COUNTS] (COUNT only)
  int n, n_chunks, n_attr, flags;
  float t_min, t_max;
};

struct Ray { float ox, oy, oz, dx, dy, dz; };

// What a ray's slab tests read: its inverse direction, and its origin as
// seen from a box's lo planes (ox + m) and hi planes (ox - m), so that
// every box it tests is widened by m on each side (m = 0: exact boxes).
struct SlabRay { float ix, iy, iz, lx, ly, lz, hx, hy, hz; };

__device__ __forceinline__ SlabRay slab_ray(const Ray& r, float margin) {
  const float ix = 1.f / r.dx, iy = 1.f / r.dy, iz = 1.f / r.dz;
  if (margin == 0.f) return {ix, iy, iz, r.ox, r.oy, r.oz, r.ox, r.oy, r.oz};
  const float m =
      margin * fmaxf(fmaxf(fabsf(r.ox), fabsf(r.oy)), fabsf(r.oz));
  return {ix, iy, iz, r.ox + m, r.oy + m, r.oz + m,
          r.ox - m, r.oy - m, r.oz - m};
}

struct Counts { unsigned long long v[N_COUNTS] = {0, 0, 0, 0}; };

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

// Negated slab test (pallas_intersect.py:75-99): a ray with d_axis = 0
// whose origin lies on a box plane gives 0 * inf = NaN, and NaN keeps the
// box reachable.
__device__ __forceinline__ bool slab(const float* box, const SlabRay& r,
                                     float best_t, float lo_cut) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(box));
  const float4 b = __ldg(reinterpret_cast<const float4*>(box + 4));
  const float tx0 = (a.x - r.lx) * r.ix, tx1 = (a.w - r.hx) * r.ix;
  const float ty0 = (a.y - r.ly) * r.iy, ty1 = (b.x - r.hy) * r.iy;
  const float tz0 = (a.z - r.lz) * r.iz, tz1 = (b.y - r.hz) * r.iz;
  const float near = nmax(nmax(nmin(tx0, tx1), nmin(ty0, ty1)),
                          nmin(tz0, tz1));
  const float far = nmin(nmin(nmax(tx0, tx1), nmax(ty0, ty1)),
                         nmax(tz0, tz1));
  return !((far < near) || (far < lo_cut) || (near >= best_t));
}

// A finite, non-zero inverse component: (x - o) * i is then monotone in x
// and never NaN, so a super box's slab culls only where its chunks' would.
__device__ __forceinline__ bool monotone(float i) {
  return fabsf(i) <= BIG && i != 0.f;
}

// The sphere test (pallas_intersect.py:112-133): half-b quadratic, strict
// disc > 0, each root times 1/a, the nearest root inside (t_min, t_max).
struct Sphere {
  struct Pre { float a, inv_a; };
  typedef float4 Prim;
  static constexpr float MARGIN = SPH_MARGIN;
  static __device__ __forceinline__ Pre pre(const Ray& r) {
    const float a = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
    return {a, 1.f / a};
  }
  // spheres respect [t_min, t_max], so the cut is t_min
  static __device__ __forceinline__ float lo_cut(const Args& P) {
    return P.t_min;
  }
  static __device__ __forceinline__ Prim load(const Args& P, int j) {
    return __ldg(reinterpret_cast<const float4*>(P.tbl) + j);
  }
  static __device__ __forceinline__ bool test(const Args& P, const Ray& r,
                                              const Pre& q, const Prim& g,
                                              float& t) {
    const float ocx = r.ox - g.x, ocy = r.oy - g.y, ocz = r.oz - g.z;
    const float b = ocx * r.dx + ocy * r.dy + ocz * r.dz;
    const float cc = ocx * ocx + ocy * ocy + ocz * ocz - g.w;
    const float disc = b * b - q.a * cc;
    if (!(disc > 0.f)) return false;
    const float sq = sqrtf(disc);
    const float t0 = (-b - sq) * q.inv_a;
    const float t1 = (-b + sq) * q.inv_a;
    t = (t0 < P.t_max && t0 > P.t_min) ? t0
      : ((t1 < P.t_max && t1 > P.t_min) ? t1 : BIG);
    return t < BIG;
  }
  static __device__ __forceinline__ Pre shfl(const Pre& q, int src) {
    return {__shfl_sync(FULL, q.a, src), __shfl_sync(FULL, q.inv_a, src)};
  }
};

// Moller-Trumbore with the quirk gates (pallas_intersect.py:136-174,
// triangle.h:57-100).
struct Triangle {
  struct Pre {};
  struct Prim { float4 r0, r1, r2; };
  static constexpr float MARGIN = TRI_MARGIN;
  static __device__ __forceinline__ Pre pre(const Ray&) { return {}; }
  // negative t can win under the no-t-clip quirk, so nothing behind the
  // origin is cut there
  static __device__ __forceinline__ float lo_cut(const Args& P) {
    return (P.flags & NO_T_CLIP) ? -BIG : P.t_min;
  }
  static __device__ __forceinline__ Prim load(const Args& P, int j) {
    const float4* row = reinterpret_cast<const float4*>(
        P.tbl + (size_t)j * TRI_COLS);
    return {__ldg(row), __ldg(row + 1), __ldg(row + 2)};
  }
  static __device__ __forceinline__ bool test(const Args& P, const Ray& r,
                                              const Pre&, const Prim& p,
                                              float& t) {
    const float4 r0 = p.r0, r1 = p.r1, r2 = p.r2;
    const float e1x = r0.w, e1y = r1.x, e1z = r1.y;
    const float e2x = r1.z, e2y = r1.w, e2z = r2.x;
    const float hx = r.dy * e2z - r.dz * e2y;
    const float hy = r.dz * e2x - r.dx * e2z;
    const float hz = r.dx * e2y - r.dy * e2x;
    const float a = e1x * hx + e1y * hy + e1z * hz;
    if (!(fabsf(a) >= TRI_EPSILON)) return false;
    if ((P.flags & BACK_CULLING) && !(a >= TRI_EPSILON)) return false;
    const float f = 1.f / a;
    const float sx = r.ox - r0.x, sy = r.oy - r0.y, sz = r.oz - r0.z;
    const float u = f * (sx * hx + sy * hy + sz * hz);
    const float qx = sy * e1z - sz * e1y;
    const float qy = sz * e1x - sx * e1z;
    const float qz = sx * e1y - sy * e1x;
    const float v = f * (r.dx * qx + r.dy * qy + r.dz * qz);
    t = f * (e2x * qx + e2y * qy + e2z * qz);
    bool valid = (u >= 0.f) && (u <= 1.f) && (v >= 0.f) && (u + v <= 1.f);
    if (P.flags & BACKFACE_ONLY)
      valid = valid && (r.dx * r2.y + r.dy * r2.z + r.dz * r2.w) >= 0.f;
    if (P.flags & NO_T_CLIP) valid = valid && (t < P.t_max);
    else valid = valid && (t > P.t_min) && (t < P.t_max);
    return valid;
  }
  static __device__ __forceinline__ Pre shfl(const Pre&, int) { return {}; }
};

// One chunk's 16 prims for this thread's ray, in table order (unrolled by
// 4, not 16: K4's camera launch 5% faster, measured).
template <class T>
__device__ __forceinline__ void chunk_thread(const Args& P, const Ray& r,
                                             const typename T::Pre& q,
                                             int base, float& best_t,
                                             int& best_i) {
#pragma unroll 4
  for (int k = 0; k < PRIM_CHUNK; ++k) {
    float t;
    if (T::test(P, r, q, T::load(P, base + k), t) && t < best_t) {
      best_t = t;
      best_i = base + k;
    }
  }
}

// COUNT: one warp step of `k` issued by the lanes that run this together
// (the lowest of them counts it).
template <bool COUNT>
__device__ __forceinline__ void warp_step(Counts& cnt, int idx, int k) {
  if (COUNT) {
    const unsigned m = __activemask();
    if ((int)(threadIdx.x & 31) == __ffs(m) - 1) cnt.v[idx] += k;
  }
}

// One thread per ray: the supers and chunks in table order, each gated by
// its slab against the running best t (CULL; else every chunk).
template <class T, bool CULL, bool COUNT>
__device__ __forceinline__ void walk_thread(const Args& P, const Ray& r,
                                            float& best_t, int& best_i,
                                            Counts& cnt) {
  const typename T::Pre q = T::pre(r);
  const SlabRay sr = slab_ray(r, T::MARGIN);
  const float lo_cut = T::lo_cut(P);
  const bool sup = CULL && P.sup && monotone(sr.ix) && monotone(sr.iy)
                   && monotone(sr.iz);
  for (int c0 = 0; c0 < P.n_chunks; c0 += CHUNKS_PER_SUPER) {
    if (sup) {
      if (COUNT) { ++cnt.v[C_BOX]; warp_step<COUNT>(cnt, C_BOX_STEP, 1); }
      if (!slab(P.sup + (size_t)(c0 / CHUNKS_PER_SUPER) * BOX_COLS, sr,
                best_t, lo_cut))
        continue;
    }
    const int c1 = min(c0 + CHUNKS_PER_SUPER, P.n_chunks);
    for (int c = c0; c < c1; ++c) {
      if (CULL) {
        if (COUNT) { ++cnt.v[C_BOX]; warp_step<COUNT>(cnt, C_BOX_STEP, 1); }
        if (!slab(P.box + (size_t)c * BOX_COLS, sr, best_t, lo_cut))
          continue;
      }
      if (COUNT) {
        cnt.v[C_PRIM] += PRIM_CHUNK;
        warp_step<COUNT>(cnt, C_PRIM_STEP, PRIM_CHUNK);
      }
      chunk_thread<T>(P, r, q, c * PRIM_CHUNK, best_t, best_i);
    }
  }
}

// An order-preserving key of a hit (t, row): the least t first, then the
// lowest row (a strict < scan in row order); a zero t keeps its sign in bit
// 0, so that key_t gives back t's bits (csrc/megakernel.cuh hit_key).
__device__ __forceinline__ unsigned long long hit_key(float t, int row) {
  const uint32_t b = t == 0.f ? 0u : __float_as_uint(t);
  const uint32_t ord = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  const uint32_t neg0 = t == 0.f ? __float_as_uint(t) >> 31 : 0u;
  return ((unsigned long long)ord << 32) | ((uint32_t)row << 1) | neg0;
}

__device__ __forceinline__ float key_t(unsigned long long k) {
  if (k & 1ull) return -0.f;
  const uint32_t ord = (uint32_t)(k >> 32);
  return __uint_as_float((ord & 0x80000000u) ? (ord & 0x7fffffffu) : ~ord);
}

// One chunk's 16 prims for the rays of `mask` (at: this lane's ray is
// one).  Above COOP_LANE_RAYS rays each lane tests its own ray's 16;
// else the lanes split the pairs, 16 prims x 2 rays a pass, lane l
// testing prim l % 16 of ray `lo` (lanes 0-15) or `hi` (16-31), and each
// ray takes its least key with the strict < of chunk_thread.
template <class T, bool COUNT>
__device__ __forceinline__ void chunk_coop(const Args& P, const Ray& r,
                                           const typename T::Pre& q,
                                           int base, unsigned mask, bool at,
                                           unsigned long long* keys,
                                           float& best_t, int& best_i,
                                           Counts& cnt) {
  const int lane = threadIdx.x & 31;
  const int k = __popc(mask);
  if (k > COOP_LANE_RAYS) {
    if (COUNT && lane == 0) cnt.v[C_PRIM_STEP] += PRIM_CHUNK;
    if (at) chunk_thread<T>(P, r, q, base, best_t, best_i);
    return;
  }
  if (COUNT && lane == 0) cnt.v[C_PRIM_STEP] += (k + 1) / 2;
  const int row = base + (lane & (PRIM_CHUNK - 1));
  const typename T::Prim g = T::load(P, row);
  for (unsigned m = mask; m;) {
    const int lo = __ffs(m) - 1;
    m &= m - 1;
    const int hi = m ? __ffs(m) - 1 : -1;
    if (m) m &= m - 1;
    const int src = lane < PRIM_CHUNK ? lo : hi;
    const int from = src < 0 ? lo : src;
    const Ray s{__shfl_sync(FULL, r.ox, from), __shfl_sync(FULL, r.oy, from),
                __shfl_sync(FULL, r.oz, from), __shfl_sync(FULL, r.dx, from),
                __shfl_sync(FULL, r.dy, from), __shfl_sync(FULL, r.dz, from)};
    const typename T::Pre sq = T::shfl(q, from);
    float t;
    if (src >= 0 && T::test(P, s, sq, g, t))
      atomicMin(keys + src, hit_key(t, row));
  }
  __syncwarp();
  const unsigned long long key = keys[lane];
  if (at && key != NO_KEY) {
    const float t = key_t(key);
    if (t < best_t) {
      best_t = t;
      best_i = (int)((uint32_t)key >> 1);
    }
    keys[lane] = NO_KEY;
  }
  __syncwarp();
}

// The warp in lockstep over the supers and chunks (every lane of the warp
// runs it; in: this lane serves a live ray); each lane's slab decisions
// are its own ray's, against its own running best t.
template <class T, bool COUNT>
__device__ __forceinline__ void walk_coop(const Args& P, const Ray& r,
                                          bool live, unsigned long long* keys,
                                          float& best_t, int& best_i,
                                          Counts& cnt) {
  const int lane = threadIdx.x & 31;
  const typename T::Pre q = T::pre(r);
  const SlabRay sr = slab_ray(r, T::MARGIN);
  const float lo_cut = T::lo_cut(P);
  const bool sup = P.sup && monotone(sr.ix) && monotone(sr.iy)
                   && monotone(sr.iz);
  keys[lane] = NO_KEY;
  __syncwarp();
  for (int c0 = 0; c0 < P.n_chunks; c0 += CHUNKS_PER_SUPER) {
    bool in = live;
    if (P.sup) {
      const bool test = in && sup;
      if (COUNT) {
        cnt.v[C_BOX] += test;
        if (__any_sync(FULL, test) && lane == 0) ++cnt.v[C_BOX_STEP];
      }
      if (test)
        in = slab(P.sup + (size_t)(c0 / CHUNKS_PER_SUPER) * BOX_COLS, sr,
                  best_t, lo_cut);
    }
    if (!__any_sync(FULL, in)) continue;
    const int c1 = min(c0 + CHUNKS_PER_SUPER, P.n_chunks);
    for (int c = c0; c < c1; ++c) {
      if (COUNT) {
        cnt.v[C_BOX] += in;
        if (lane == 0) ++cnt.v[C_BOX_STEP];
      }
      const bool at = in && slab(P.box + (size_t)c * BOX_COLS, sr, best_t,
                                 lo_cut);
      const unsigned mask = __ballot_sync(FULL, at);
      if (!mask) continue;
      if (COUNT && at) cnt.v[C_PRIM] += PRIM_CHUNK;
      chunk_coop<T, COUNT>(P, r, q, c * PRIM_CHUNK, mask, at, keys, best_t,
                           best_i, cnt);
    }
  }
}

__device__ __forceinline__ void add_counts(unsigned long long* counts,
                                           Counts& cnt) {
  for (int k = 0; k < N_COUNTS; ++k) {
    unsigned long long v = cnt.v[k];
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(FULL, v, off);
    if ((threadIdx.x & 31) == 0) atomicAdd(counts + k, v);
  }
}

// (t, idx) and, for K5, the winner's attribute row as A planes of n floats
// (plane k at out_attr + k n: a warp's store of one attribute covers its
// rays' consecutive floats); a miss and a dead lane carry prim 0's row.  A
// row of the main path's PATH_ATTRS is read whole before it is stored.
template <bool ATTRS>
__device__ __forceinline__ void write_hit(const Args& P, int i, float t,
                                          int idx) {
  P.out_t[i] = t;
  P.out_i[i] = idx;
  if (ATTRS) {
    const float* row = P.attr + (size_t)(idx >= 0 ? idx : 0) * P.n_attr;
    float* out = P.out_attr + i;
    if (P.n_attr == PATH_ATTRS) {
      float v[PATH_ATTRS];
#pragma unroll
      for (int k = 0; k < PATH_ATTRS; ++k) v[k] = __ldg(row + k);
#pragma unroll
      for (int k = 0; k < PATH_ATTRS; ++k) out[(size_t)k * P.n] = v[k];
    } else {
      for (int k = 0; k < P.n_attr; ++k)
        out[(size_t)k * P.n] = __ldg(row + k);
    }
  }
}

// The tile pass: the block's 128 rays; with an alive mask the dead ones
// are written as misses and the live ones packed, in order, into the
// first slots (ballot and prefix sum), so that the block's warps serve
// only live rays.  Slot threadIdx.x's ray id, or -1.  K5 (ATTRS) packs
// nothing and writes nothing here: each lane keeps its own ray, dead or
// alive, and writes it after the sweep, so that a warp's store of an
// attribute plane is one coalesced store of 32 floats (packing measured 3%
// slower on an H100 on the fit's bounce over four spheres; dead lanes
// written apart from the live ones split each plane's sectors over two
// stores).
template <bool ATTRS>
__device__ __forceinline__ int tile_ray(const Args& P) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (ATTRS) return i < P.n && (P.alive == nullptr || P.alive[i]) ? i : -1;
  if (P.alive == nullptr) return i < P.n ? i : -1;
  __shared__ int slots[BLOCK];
  __shared__ int warp_live[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool live = i < P.n && P.alive[i];
  if (i < P.n && !live) write_hit<ATTRS>(P, i, BIG, -1);
  const unsigned b = __ballot_sync(FULL, live);
  if (lane == 0) warp_live[warp] = __popc(b);
  __syncthreads();
  int before = 0, total = 0;
  for (int w = 0; w < WARPS; ++w) {
    before += w < warp ? warp_live[w] : 0;
    total += warp_live[w];
  }
  if (live) slots[before + __popc(b & ((1u << lane) - 1u))] = i;
  __syncthreads();
  return (int)threadIdx.x < total ? slots[threadIdx.x] : -1;
}

template <class T, bool CULL, bool COOP, bool ATTRS, bool COUNT>
__device__ __forceinline__ void sweep(const Args& P) {
  const int i = tile_ray<ATTRS>(P);
  const int own = blockIdx.x * BLOCK + threadIdx.x;   // K5's lane's ray
  if (!__any_sync(FULL, i >= 0)) {            // a warp with no live ray
    if (ATTRS && own < P.n) write_hit<ATTRS>(P, own, BIG, -1);
    return;
  }
  Ray r{0.f, 0.f, 0.f, 1.f, 1.f, 1.f};
  if (i >= 0) {
    r = {P.o[3 * (size_t)i], P.o[3 * (size_t)i + 1], P.o[3 * (size_t)i + 2],
         P.d[3 * (size_t)i], P.d[3 * (size_t)i + 1], P.d[3 * (size_t)i + 2]};
  }
  float best_t = BIG;
  int best_i = -1;
  Counts cnt;
  if (COOP) {
    __shared__ unsigned long long keys[BLOCK];
    walk_coop<T, COUNT>(P, r, i >= 0, keys + (threadIdx.x & ~31u), best_t,
                        best_i, cnt);
  } else if (i >= 0) {
    walk_thread<T, CULL, COUNT>(P, r, best_t, best_i, cnt);
  }
  // K5: a dead lane's best is still (BIG, -1)
  if (ATTRS ? own < P.n : i >= 0)
    write_hit<ATTRS>(P, ATTRS ? own : i, best_t, best_i);
  if (COUNT) add_counts(P.counts, cnt);
}

// ---------------------------------------------------------------------------
// The winner sum crt_winner_add: out[idx[i], :] += row i of up to three
// row blocks [n, k_j] (any strides), out float32 [c, k], k = sum of k_j.
// The sweeps' winner-only backwards sum their per-ray gradients into
// per-prim gradients with it (ops/sweeps.py winner_add).
//
// Replaces no pallas_call: the JAX package leaves this sum to XLA's
// scatter (pallas_intersect.py:1038-1043, .at[safe].add), as the port's
// index_add_ did.  What bounds it on this card: bytes, one read of idx and
// of each row (104 B a ray for K5's k = 25).  What stood in the way is
// contention: index_add_ makes one atomic add an element, every miss and
// dead lane adds 0 to prim 0, and a few hot winners take most hits, so the
// adds queue on a few addresses.  What the design does about that:
//   * a lane whose idx is negative (a miss, a dead lane) reads and adds
//     nothing; a warp with no live lane skips its step;
//   * the lanes of a warp with the same winner (__match_any_sync) sum each
//     column by shuffles, a binary tree over their ranks, and the lowest of
//     them alone adds the sum: one add a winner, a column and a warp step;
//     neighbouring rays mostly hit the same prim, so a coherent warp makes
//     one add a column;
//   * shared form (c x k floats within WIN_SHARED_BYTES): a grid of the
//     resident blocks, each over a contiguous range of rays, adds into its
//     own accumulator in dynamic shared memory and at its end flushes each
//     nonzero slot with one atomicAdd to the output;
//   * global form (above it, e.g. 10^5 triangles): the warp's adders add
//     straight to the output, at most one atomic a group where index_add_
//     made one an element.
// The form follows from c x k alone.  The output is zeroed on the stream
// before the launch.  float32 throughout: only the order of the sums
// differs from index_add_'s, whose order on the card is run-dependent too.
// Where the caller asks for a sum that repeats bit for bit (PyTorch's
// deterministic algorithms, under which index_add_ sums in a fixed order),
// the ordered form runs instead: one-warp blocks, each over a contiguous
// range of rays, each adding into its own zeroed slice of a scratch
// [blocks, c, k] in program order, then crt_winner_add_finish sums the
// slices in block order.  A winner outside [0, c) is dropped (the caller's
// sweeps give none).
// ---------------------------------------------------------------------------

constexpr int WIN_BLOCK = 512;
constexpr int WIN_MAX_BLOCKS = 3;                 // row blocks a launch sums
constexpr int WIN_SHARED_BYTES = 96 * 1024;       // two blocks an SM
constexpr int WIN_TREE = 5;                       // log2(32) tree steps
constexpr int WIN_UNROLL = 4;                     // columns in flight

struct WinnerArgs {
  const int* idx;                                 // [n], -1: no winner
  const float* rows[WIN_MAX_BLOCKS];
  long long row_stride[WIN_MAX_BLOCKS], col_stride[WIN_MAX_BLOCKS];
  int cols[WIN_MAX_BLOCKS];
  int n_blocks;
  float* out;                                     // [c, k]; ordered:
                                                  // [blocks, c, k]
  long long n, per_block;                         // rays; a block's range
  int c, k;
};

// The tree over the lanes that share a winner (peers, this lane's bit
// included): at step s a lane adds lane src[s]'s value where bit s of take
// is set.  After step s the lanes whose rank is a multiple of 2^(s+1) hold
// the sums of their 2^(s+1) ranks, so the lowest lane ends with its
// group's.  steps is uniform over the warp: every lane runs every step,
// which the shuffles need.
struct Tree { int src[WIN_TREE]; unsigned take; int steps; };

__device__ __forceinline__ Tree tree_of(unsigned peers, int lane) {
  Tree t{};
  const unsigned below = (1u << lane) - 1u;
  unsigned higher = peers & ~below & ~(1u << lane);
  int rank = __popc(peers & below);
#pragma unroll
  for (int s = 0; s < WIN_TREE; ++s) {
    t.src[s] = lane;
    if (__any_sync(FULL, higher)) {
      const int next = __ffs(higher);             // the next peer still on
      if (next) {
        t.src[s] = next - 1;
        t.take |= 1u << s;
      }
      higher &= ~__ballot_sync(FULL, rank & 1);   // odd ranks are summed
      rank >>= 1;
      t.steps = s + 1;
    }
  }
  return t;
}

// ORDERED: a block is one warp, adding into its own slice of P.out in
// program order (its adders hold distinct slots), so the sums repeat.
template <bool SHARED, bool ORDERED>
__device__ __forceinline__ void winner_sum(const WinnerArgs& P) {
  extern __shared__ float acc[];                  // SHARED: [c, k]
  constexpr int threads = ORDERED ? 32 : WIN_BLOCK;
  const int lane = threadIdx.x & 31;
  const int slots = P.c * P.k;
  if (SHARED) {
    for (int s = threadIdx.x; s < slots; s += WIN_BLOCK) acc[s] = 0.f;
    __syncthreads();
  }
  float* const dst = SHARED ? acc
                            : P.out + (ORDERED ? blockIdx.x * (size_t)slots
                                               : 0);
  const long long lo = (long long)blockIdx.x * P.per_block;
  const long long hi = P.n < lo + P.per_block ? P.n : lo + P.per_block;
  for (long long base = lo + (threadIdx.x & ~31); base < hi;
       base += threads) {
    const long long i = base + lane;
    int w = i < hi ? __ldg(P.idx + i) : -1;
    if (w >= P.c) w = -1;
    const bool live = w >= 0;
    if (!__any_sync(FULL, live)) continue;
    unsigned peers = __match_any_sync(FULL, w);
    if (!live) peers = 1u << lane;
    const Tree t = tree_of(peers, lane);
    const bool adds = live && !(peers & ((1u << lane) - 1u));
    float* const slot = dst + (size_t)(live ? w : 0) * P.k;
    int col = 0;
    for (int b = 0; b < P.n_blocks; ++b) {
      const float* row = P.rows[b] + (live ? i * P.row_stride[b] : 0);
      const long long cs = P.col_stride[b];
      const int cols = P.cols[b];
      for (int j0 = 0; j0 < cols; j0 += WIN_UNROLL) {
        float x[WIN_UNROLL];
#pragma unroll
        for (int u = 0; u < WIN_UNROLL; ++u)
          x[u] = live && j0 + u < cols ? __ldg(row + (j0 + u) * cs) : 0.f;
#pragma unroll
        for (int s = 0; s < WIN_TREE; ++s) {
          if (s < t.steps) {
#pragma unroll
            for (int u = 0; u < WIN_UNROLL; ++u) {
              const float y = __shfl_sync(FULL, x[u], t.src[s]);
              if (t.take >> s & 1u) x[u] += y;
            }
          }
        }
        if (adds) {
#pragma unroll
          for (int u = 0; u < WIN_UNROLL; ++u) {
            if (j0 + u >= cols) continue;
            if (ORDERED)
              slot[col + j0 + u] += x[u];
            else
              atomicAdd(slot + col + j0 + u, x[u]);
          }
        }
      }
      col += cols;
    }
    if (ORDERED) __syncwarp();    // this step's adds before the next's
  }
  if (SHARED) {
    __syncthreads();
    for (int s = threadIdx.x; s < slots; s += WIN_BLOCK)
      if (acc[s] != 0.f) atomicAdd(P.out + s, acc[s]);
  }
}

}  // namespace crt_sweeps

using namespace crt_sweeps;

// The instances, by name (ptxas -v reports each under it): sph / tri,
// plain (every chunk) or cull (chunk and super boxes), coop (the
// warp-cooperative chunk tests), attrs (K5), count (COUNT).
#define CRT_SWEEP(NAME, T, CULL, COOP, ATTRS)                                \
  extern "C" __global__ void __launch_bounds__(BLOCK) NAME(Args P) {         \
    sweep<T, CULL, COOP, ATTRS, false>(P);                                   \
  }                                                                          \
  extern "C" __global__ void __launch_bounds__(BLOCK) NAME##_count(Args P) { \
    sweep<T, CULL, COOP, ATTRS, true>(P);                                    \
  }
CRT_SWEEP(crt_sph_plain, Sphere, false, false, false)
CRT_SWEEP(crt_sph_plain_attrs, Sphere, false, false, true)
CRT_SWEEP(crt_sph_cull, Sphere, true, false, false)
CRT_SWEEP(crt_sph_cull_attrs, Sphere, true, false, true)
CRT_SWEEP(crt_sph_coop, Sphere, true, true, false)
CRT_SWEEP(crt_sph_coop_attrs, Sphere, true, true, true)
CRT_SWEEP(crt_tri_plain, Triangle, false, false, false)
CRT_SWEEP(crt_tri_cull, Triangle, true, false, false)
CRT_SWEEP(crt_tri_coop, Triangle, true, true, false)
#undef CRT_SWEEP

// The winner sum's forms, and the ordered form's sum over its blocks'
// slices (one thread a slot, blocks in order)
extern "C" __global__ void __launch_bounds__(WIN_BLOCK)
    crt_winner_add_shared(WinnerArgs P) {
  winner_sum<true, false>(P);
}
extern "C" __global__ void __launch_bounds__(WIN_BLOCK)
    crt_winner_add_global(WinnerArgs P) {
  winner_sum<false, false>(P);
}
extern "C" __global__ void __launch_bounds__(32)
    crt_winner_add_ordered(WinnerArgs P) {
  winner_sum<false, true>(P);
}
extern "C" __global__ void __launch_bounds__(WIN_BLOCK)
    crt_winner_add_finish(const float* slices, float* out, long long slots,
                          int blocks) {
  const long long s = (long long)blockIdx.x * WIN_BLOCK + threadIdx.x;
  if (s >= slots) return;
  float sum = 0.f;
  for (int b = 0; b < blocks; ++b) sum += slices[b * slots + s];
  out[s] = sum;
}

namespace {

typedef void (*Kernel)(Args);

// [cull + coop][attrs][count] of the sphere instances; coop implies cull
const Kernel SPHERE_KERNELS[3][2][2] = {
    {{crt_sph_plain, crt_sph_plain_count},
     {crt_sph_plain_attrs, crt_sph_plain_attrs_count}},
    {{crt_sph_cull, crt_sph_cull_count},
     {crt_sph_cull_attrs, crt_sph_cull_attrs_count}},
    {{crt_sph_coop, crt_sph_coop_count},
     {crt_sph_coop_attrs, crt_sph_coop_attrs_count}}};
const Kernel TRIANGLE_KERNELS[3][2] = {
    {crt_tri_plain, crt_tri_plain_count},
    {crt_tri_cull, crt_tri_cull_count},
    {crt_tri_coop, crt_tri_coop_count}};

int launch(Kernel k, const Args& P, void* cuda_stream) {
  const dim3 grid((P.n + BLOCK - 1) / BLOCK);
  k<<<grid, BLOCK, 0, static_cast<cudaStream_t>(cuda_stream)>>>(P);
  return (int)cudaGetLastError();
}

Args make_args(const void* o, const void* d, const void* tbl,
               const void* box, const void* sup, const void* alive,
               void* out_t, void* out_i, void* counts, int n, int n_chunks,
               float t_min, float t_max) {
  Args P{};
  P.o = static_cast<const float*>(o);
  P.d = static_cast<const float*>(d);
  P.tbl = static_cast<const float*>(tbl);
  P.box = static_cast<const float*>(box);
  P.sup = box ? static_cast<const float*>(sup) : nullptr;
  P.alive = static_cast<const unsigned char*>(alive);
  P.out_t = static_cast<float*>(out_t);
  P.out_i = static_cast<int*>(out_i);
  P.counts = static_cast<unsigned long long*>(counts);
  P.n = n;
  P.n_chunks = n_chunks;
  P.t_min = t_min;
  P.t_max = t_max;
  return P;
}

}  // namespace

// box null: the plain form (sup and coop ignored); sup null: one box
// level; coop: the warp-cooperative chunk tests; attr null: K3, else K5;
// counts null: production.
extern "C" int crt_sphere_sweep(
    const void* o, const void* d, const void* tbl, const void* box,
    const void* sup, const void* alive, const void* attr, void* out_t,
    void* out_i, void* out_attr, void* counts, int n, int n_chunks,
    int n_attr, int coop, float t_min, float t_max, void* cuda_stream) {
  Args P = make_args(o, d, tbl, box, sup, alive, out_t, out_i, counts, n,
                     n_chunks, t_min, t_max);
  P.attr = static_cast<const float*>(attr);
  P.out_attr = static_cast<float*>(out_attr);
  P.n_attr = n_attr;
  if (n <= 0) return 0;
  if (attr && !out_attr) return (int)cudaErrorInvalidValue;
  const int form = box ? (coop ? 2 : 1) : 0;
  return launch(SPHERE_KERNELS[form][attr != nullptr][counts != nullptr], P,
                cuda_stream);
}

// box null: the plain form; sup, coop, counts as crt_sphere_sweep.
extern "C" int crt_triangle_sweep(
    const void* o, const void* d, const void* tbl, const void* box,
    const void* sup, const void* alive, void* out_t, void* out_i,
    void* counts, int n, int n_chunks, int flags, int coop, float t_min,
    float t_max, void* cuda_stream) {
  Args P = make_args(o, d, tbl, box, sup, alive, out_t, out_i, counts, n,
                     n_chunks, t_min, t_max);
  P.flags = flags;
  if (n <= 0) return 0;
  const int form = box ? (coop ? 2 : 1) : 0;
  return launch(TRIANGLE_KERNELS[form][counts != nullptr], P, cuda_stream);
}

// out[idx[i], :] += the rows i of rows[0 .. n_blocks) (block j:
// cols[j] columns, element (i, c) at rows[j][i * strides[2 j] + c *
// strides[2 j + 1]]), out float32 [c, sum of cols] zeroed here first.
// scratch (float32 [scratch_blocks, c, sum of cols]) non-null: the ordered
// form over scratch_blocks one-warp blocks.  *form: 0 shared, 1 global, 2
// ordered, -1 when no kernel ran (no ray, no slot).
extern "C" int crt_winner_add(const void* idx, const void* const* rows,
                              const long long* strides, const int* cols,
                              int n_blocks, void* out, long long n, int c,
                              void* scratch, int scratch_blocks, int* form,
                              void* cuda_stream) {
  *form = -1;
  if (n_blocks < 1 || n_blocks > WIN_MAX_BLOCKS || n < 0 || c < 0 ||
      (scratch && scratch_blocks < 1))
    return (int)cudaErrorInvalidValue;
  WinnerArgs P{};
  P.idx = static_cast<const int*>(idx);
  for (int b = 0; b < n_blocks; ++b) {
    P.rows[b] = static_cast<const float*>(rows[b]);
    P.row_stride[b] = strides[2 * b];
    P.col_stride[b] = strides[2 * b + 1];
    P.cols[b] = cols[b];
    P.k += cols[b];
  }
  P.n_blocks = n_blocks;
  P.out = static_cast<float*>(out);
  P.n = n;
  P.c = c;
  const cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  const size_t bytes = (size_t)c * P.k * sizeof(float);
  if (bytes == 0) return 0;
  cudaError_t e = cudaMemsetAsync(out, 0, bytes, s);
  if (e != cudaSuccess || n == 0) return (int)e;
  if (scratch) {
    e = cudaMemsetAsync(scratch, 0, bytes * scratch_blocks, s);
    if (e != cudaSuccess) return (int)e;
    const long long warps = (n + 31) / 32;
    P.per_block = (warps + scratch_blocks - 1) / scratch_blocks * 32;
    P.out = static_cast<float*>(scratch);
    crt_winner_add_ordered<<<(unsigned)((n + P.per_block - 1) /
                                        P.per_block), 32, 0, s>>>(P);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const long long slots = (long long)c * P.k;
    crt_winner_add_finish<<<(unsigned)((slots + WIN_BLOCK - 1) / WIN_BLOCK),
                            WIN_BLOCK, 0, s>>>(
        static_cast<const float*>(scratch), static_cast<float*>(out), slots,
        scratch_blocks);
    *form = 2;
    return (int)cudaGetLastError();
  }
  const bool shared = bytes <= (size_t)WIN_SHARED_BYTES;
  void (*kernel)(WinnerArgs) =
      shared ? crt_winner_add_shared : crt_winner_add_global;
  const int smem = shared ? (int)bytes : 0;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
  }
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    WIN_BLOCK, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // the resident blocks, fewer for fewer rays, each over a contiguous
  // range of whole warps
  const long long warps = (n + 31) / 32;
  const long long most = (long long)per_sm * sms;
  const long long want = (n + WIN_BLOCK - 1) / WIN_BLOCK;
  const long long grid0 = want < most ? want : most;
  P.per_block = (warps + grid0 - 1) / grid0 * 32;
  const long long grid = (n + P.per_block - 1) / P.per_block;
  kernel<<<(unsigned)grid, WIN_BLOCK, smem, s>>>(P);
  *form = shared ? 0 : 1;
  return (int)cudaGetLastError();
}

extern "C" const char* crt_sweeps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
