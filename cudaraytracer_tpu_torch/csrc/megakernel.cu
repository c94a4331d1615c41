// Fused path tracer for NVIDIA Hopper (sm_90a): the whole bounce loop of one
// ray in one thread.
//
// Replaces: cudaraytracer_tpu/ops/megakernel.py::_mega_kernel, main-path form
// (spheres + triangles, tables resident, integrator path / lambert / normal,
// in-kernel draws or an injected (ball, prob) stream), launched there by
// _mega_call through its single pl.pallas_call.  Also exposes that kernel's
// draw transform as a kernel of its own, scatter_draws
// (ops/pallas_intersect.py::_draws_kernel).
//
// What bounds it on this card: FP32 ALU issue on the per-ray sweeps (the
// sphere quadratic and the Moller-Trumbore test over every chunk whose box
// the ray reaches), and divergence, since neighbouring rays reach different
// chunks and end their paths at different bounces.  Memory traffic is small:
// a ray is read once and its radiance written once, and the tables (tens of
// KB to a few hundred KB) stay in L1/L2.
//
// What the simple design does about that:
//   * one thread per ray, the bounce loop in registers, as the reference
//     renderer does (render.h:105-129).  The caller orders rays in 32x16
//     screen blocks, so the 32 rays of a warp start coherent;
//   * the TPU kernel's per-tile any() votes become per-thread branches on
//     the chunk and super boxes (two-level culling), and one best_t is
//     shared by the sphere and triangle sweeps, so triangles behind the
//     nearest sphere are culled too;
//   * the sweep carries only (best_t, best_idx, is_tri); the winner's row is
//     loaded after the sweep with plain loads (the TPU kernel carried the
//     attributes through every chunk merge);
//   * tables are read from global memory through L1/L2.  Staging them in
//     shared memory, cp.async or TMA is left for later work;
//   * built with --fmad=false: every product and sum rounds on its own, as
//     in the plain PyTorch version, so the two agree ray for ray.  With
//     contraction, grazing hits flip against the plain version and the
//     normal integrator on random_spheres differs in ~2% of rays at 1e-3
//     (a sphere's normal scales the quadratic's rounding by |d| / r).
//
// Semantics kept from the TPU kernel: BIG sentinel = FLT_MAX, hit means
// t < 1e37, the negated slab test (NaN keeps a chunk reachable), first prim
// wins ties within and across chunks, spheres win exact ties against
// triangles, the half-b quadratic times 1/a with a strict disc > 0, the
// quirk gates, and the material rules of the reference.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
//        -shared -Xcompiler -fPIC  (plain C interface, loaded with ctypes;
//        ops/_cuda.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float BIG = 3.4028235e38f;   // ops/intersect.py BIG
constexpr float BIG_CUT = 1e37f;       // t >= BIG_CUT is a miss
constexpr float TRI_EPSILON = 1e-6f;
constexpr float TWO_PI = 6.283185307179586f;
constexpr int PRIM_CHUNK = 16;         // prims per chunk box
constexpr int CHUNKS_PER_SUPER = 16;   // SUPER_T = 256 prims per super box
constexpr int SPH_COLS = 16;  // cx cy cz r2 1/r | 9 material | 2 pad
constexpr int TRI_COLS = 24;  // v0 e1 e2 n | 9 material | 3 pad
constexpr int BOX_COLS = 8;   // lo.xyz hi.xyz | 2 pad
constexpr int S_INVR = 4, S_MAT = 5, T_N = 9, T_MAT = 12;
constexpr int BLOCK = 128;

enum Integrator { PATH = 0, LAMBERT = 1, NORMAL = 2 };
enum Flags {
  BACKFACE_ONLY = 1, NO_T_CLIP = 2, BACK_CULLING = 4, DIE_REF_COSINE = 8,
  LAMBERT_UNNORM = 16, INJECTED = 32
};
// material kinds and texture kinds (models/materials.py, models/textures.py)
constexpr float K_METAL = 1.f, K_DIELECTRIC = 2.f, K_LIGHT = 3.f;
constexpr float TEX_CHECKER = 1.f;

struct Params {
  const float* sph; const float* sph_box; const float* sph_super;
  const float* tri; const float* tri_box; const float* tri_super;
  const float* o; const float* d;
  const float* stream;        // [max_depth + 1, n, 4] when INJECTED
  float* out;                 // [n, 3]
  unsigned long long* counts; // optional [3]: box, sphere, triangle tests;
                              // given, the counting variant runs
  unsigned long long seed;
  int n, n_sph_chunks, n_sph_supers, n_tri_supers, max_depth, flags;
  float t_min, t_max, ambient;
};

// jnp.minimum / jnp.maximum semantics: NaN in, NaN out (fminf would drop it)
__device__ __forceinline__ float nmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// Negated slab test (megakernel.py:561-578): a ray with d_axis = 0 whose
// origin lies on a box plane gives 0 * inf = NaN, and NaN keeps the box
// reachable.
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

struct Ray { float ox, oy, oz, dx, dy, dz; };

struct Hit {
  float t;
  int idx;
  bool tri;
};

struct Counts { unsigned long long box, sph, tri; };

// Sphere quadratic over one chunk (megakernel.py:620-652): half-b form,
// strict disc > 0, each root times 1/a; nearest root inside (t_min, t_max).
__device__ __forceinline__ void sphere_chunk(const Params& P, const Ray& r,
                                             float a, float inv_a, int base,
                                             Hit& h) {
  for (int k = 0; k < PRIM_CHUNK; ++k) {
    const float4 g = __ldg(reinterpret_cast<const float4*>(
        P.sph + (size_t)(base + k) * SPH_COLS));
    const float ocx = r.ox - g.x, ocy = r.oy - g.y, ocz = r.oz - g.z;
    const float b = ocx * r.dx + ocy * r.dy + ocz * r.dz;
    const float c = ocx * ocx + ocy * ocy + ocz * ocz - g.w;
    const float disc = b * b - a * c;
    if (disc > 0.f) {
      const float sq = sqrtf(disc);
      const float t0 = (-b - sq) * inv_a;
      const float t1 = (-b + sq) * inv_a;
      const float t = (t0 < P.t_max && t0 > P.t_min) ? t0
                    : ((t1 < P.t_max && t1 > P.t_min) ? t1 : BIG);
      if (t < h.t) { h.t = t; h.idx = base + k; h.tri = false; }
    }
  }
}

// Moller-Trumbore over one chunk with the quirk gates (megakernel.py:
// 828-877, triangle.h:61-94).
__device__ __forceinline__ void tri_chunk(const Params& P, const Ray& r,
                                          int base, Hit& h) {
  for (int k = 0; k < PRIM_CHUNK; ++k) {
    const float* row = P.tri + (size_t)(base + k) * TRI_COLS;
    const float4 r0 = __ldg(reinterpret_cast<const float4*>(row));
    const float4 r1 = __ldg(reinterpret_cast<const float4*>(row + 4));
    const float4 r2 = __ldg(reinterpret_cast<const float4*>(row + 8));
    const float e1x = r0.w, e1y = r1.x, e1z = r1.y;
    const float e2x = r1.z, e2y = r1.w, e2z = r2.x;
    const float hx = r.dy * e2z - r.dz * e2y;
    const float hy = r.dz * e2x - r.dx * e2z;
    const float hz = r.dx * e2y - r.dy * e2x;
    const float a = e1x * hx + e1y * hy + e1z * hz;
    if (!(fabsf(a) >= TRI_EPSILON)) continue;
    if ((P.flags & BACK_CULLING) && !(a >= TRI_EPSILON)) continue;
    const float f = 1.f / a;
    const float sx = r.ox - r0.x, sy = r.oy - r0.y, sz = r.oz - r0.z;
    const float u = f * (sx * hx + sy * hy + sz * hz);
    const float qx = sy * e1z - sz * e1y;
    const float qy = sz * e1x - sx * e1z;
    const float qz = sx * e1y - sy * e1x;
    const float v = f * (r.dx * qx + r.dy * qy + r.dz * qz);
    const float t = f * (e2x * qx + e2y * qy + e2z * qz);
    bool valid = (u >= 0.f) && (u <= 1.f) && (v >= 0.f) && (u + v <= 1.f);
    if (P.flags & BACKFACE_ONLY)
      valid = valid && (r.dx * r2.y + r.dy * r2.z + r.dz * r2.w) >= 0.f;
    if (P.flags & NO_T_CLIP) valid = valid && (t < P.t_max);
    else valid = valid && (t > P.t_min) && (t < P.t_max);
    if (valid && t < h.t) { h.t = t; h.idx = base + k; h.tri = true; }
  }
}

// Closest hit over the sphere chunks (one or two box levels) and the
// triangle supers and chunks.  COUNT adds the tests made to cnt (a
// measurement-only variant; the production launches carry none of it).
template <bool COUNT>
__device__ Hit closest_hit(const Params& P, const Ray& r, Counts& cnt) {
  Hit h{BIG, -1, false};
  const float ix = 1.f / r.dx, iy = 1.f / r.dy, iz = 1.f / r.dz;
  if (P.n_sph_chunks > 0) {
    const float a = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
    const float inv_a = 1.f / a;
    if (P.n_sph_supers == 0) {
      for (int c = 0; c < P.n_sph_chunks; ++c) {
        if (COUNT) ++cnt.box;
        if (slab(P.sph_box + c * BOX_COLS, r.ox, r.oy, r.oz, ix, iy, iz,
                 h.t, P.t_min)) {
          if (COUNT) cnt.sph += PRIM_CHUNK;
          sphere_chunk(P, r, a, inv_a, c * PRIM_CHUNK, h);
        }
      }
    } else {
      for (int s = 0; s < P.n_sph_supers; ++s) {
        if (COUNT) ++cnt.box;
        if (!slab(P.sph_super + s * BOX_COLS, r.ox, r.oy, r.oz, ix, iy, iz,
                  h.t, P.t_min))
          continue;
        for (int j = 0; j < CHUNKS_PER_SUPER; ++j) {
          const int c = s * CHUNKS_PER_SUPER + j;
          if (COUNT) ++cnt.box;
          if (slab(P.sph_box + c * BOX_COLS, r.ox, r.oy, r.oz, ix, iy, iz,
                   h.t, P.t_min)) {
            if (COUNT) cnt.sph += PRIM_CHUNK;
            sphere_chunk(P, r, a, inv_a, c * PRIM_CHUNK, h);
          }
        }
      }
    }
  }
  if (P.n_tri_supers > 0) {
    const float lo_cut = (P.flags & NO_T_CLIP) ? -BIG : P.t_min;
    for (int s = 0; s < P.n_tri_supers; ++s) {
      if (COUNT) ++cnt.box;
      if (!slab(P.tri_super + s * BOX_COLS, r.ox, r.oy, r.oz, ix, iy, iz,
                h.t, lo_cut))
        continue;
      for (int j = 0; j < CHUNKS_PER_SUPER; ++j) {
        const int c = s * CHUNKS_PER_SUPER + j;
        if (COUNT) ++cnt.box;
        if (slab(P.tri_box + c * BOX_COLS, r.ox, r.oy, r.oz, ix, iy, iz,
                 h.t, lo_cut)) {
          if (COUNT) cnt.tri += PRIM_CHUNK;
          tri_chunk(P, r, c * PRIM_CHUNK, h);
        }
      }
    }
  }
  return h;
}

// The winner's normal and material block, loaded after the sweep.  Sphere
// normal (p - c) * (1 / r) with the stored 1/r keeps hollow (negative
// radius) spheres right; triangles use the stored face normal.
__device__ __forceinline__ void load_winner(const Params& P, const Hit& h,
                                            float px, float py, float pz,
                                            float n[3], float m[9]) {
  if (h.tri) {
    const float* row = P.tri + (size_t)h.idx * TRI_COLS;
    n[0] = __ldg(row + T_N); n[1] = __ldg(row + T_N + 1);
    n[2] = __ldg(row + T_N + 2);
    for (int k = 0; k < 9; ++k) m[k] = __ldg(row + T_MAT + k);
  } else {
    const float* row = P.sph + (size_t)h.idx * SPH_COLS;
    const float inv_r = __ldg(row + S_INVR);
    n[0] = (px - __ldg(row)) * inv_r;
    n[1] = (py - __ldg(row + 1)) * inv_r;
    n[2] = (pz - __ldg(row + 2)) * inv_r;
    for (int k = 0; k < 9; ++k) m[k] = __ldg(row + S_MAT + k);
  }
}

// Texture select + attenuation / emission rules (megakernel.py:533-556).
// Material block: kind, tex kind, aux (fuzz | ref_idx), color0, color1;
// metal's albedo is folded into color0.
__device__ __forceinline__ void mat_decode(const float m[9], float px,
                                           float py, float pz, float att[3],
                                           float em[3]) {
  const float sines = sinf(10.f * px) * sinf(10.f * py) * sinf(10.f * pz);
  const bool odd = (m[1] == TEX_CHECKER) && (sines < 0.f);
  const bool is_met = m[0] == K_METAL, is_die = m[0] == K_DIELECTRIC;
  const bool is_light = m[0] == K_LIGHT;
  for (int k = 0; k < 3; ++k) {
    const float tex = odd ? m[6 + k] : m[3 + k];
    att[k] = is_die ? 1.f : (is_met ? m[3 + k] : tex);
    em[k] = is_light ? tex : 0.f;
  }
}

// Philox4x32-10 (Salmon et al., SC'11).
__device__ __forceinline__ uint4 philox(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) { k0 += 0x9E3779B9u; k1 += 0xBB67AE85u; }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

__device__ __forceinline__ float u24(uint32_t bits) {
  return (float)(bits >> 8) * (1.f / 16777216.f);
}

// Draws for (seed, ray index, bounce): six uniforms -> unit-ball sample
// (Box-Muller direction x cube-root radius, megakernel.py:1371-1385) and
// one uniform.  Counter-based, so independent of the launch shape.
__device__ __forceinline__ float4 draw(unsigned long long seed,
                                       uint32_t index, uint32_t step) {
  const uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
  const uint4 a = philox(make_uint4(index, step, 0u, 0u), k0, k1);
  const uint4 b = philox(make_uint4(index, step, 1u, 0u), k0, k1);
  const float r1 = sqrtf(-2.f * logf(fmaxf(u24(a.x), 1e-12f)));
  const float ang1 = TWO_PI * u24(a.y);
  const float g0 = r1 * cosf(ang1);
  const float g1 = r1 * sinf(ang1);
  const float r2 = sqrtf(-2.f * logf(fmaxf(u24(a.z), 1e-12f)));
  const float g2 = r2 * cosf(TWO_PI * u24(a.w));
  const float inv_norm =
      1.f / fmaxf(sqrtf(g0 * g0 + g1 * g1 + g2 * g2), 1e-12f);
  const float rad = expf(logf(fmaxf(u24(b.x), 1e-30f)) * (1.f / 3.f));
  const float s = inv_norm * rad;
  return make_float4(g0 * s, g1 * s, g2 * s, u24(b.y));
}

// render.h:41-46 on the current direction.
__device__ __forceinline__ void sky(float dy, float inv_dlen, float out[3]) {
  const float t = 0.5f * (dy * inv_dlen + 1.f);
  out[0] = (1.f - t) + t * 0.5f;
  out[1] = (1.f - t) + t * 0.7f;
  out[2] = (1.f - t) + t * 1.0f;
}

__device__ __forceinline__ void add_counts(const Params& P, Counts c) {
  for (int off = 16; off > 0; off >>= 1) {
    c.box += __shfl_down_sync(0xffffffffu, c.box, off);
    c.sph += __shfl_down_sync(0xffffffffu, c.sph, off);
    c.tri += __shfl_down_sync(0xffffffffu, c.tri, off);
  }
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(P.counts, c.box);
    atomicAdd(P.counts + 1, c.sph);
    atomicAdd(P.counts + 2, c.tri);
  }
}

// One bounce's scatter (megakernel.py:1464-1531).  Returns whether the
// material scatters; writes the new direction.
__device__ __forceinline__ bool scatter(const Params& P, const Ray& r,
                                        const float n[3], const float m[9],
                                        float inv_dlen, float4 s,
                                        float out[3]) {
  const float kind = m[0], aux = m[2];
  if (kind == K_LIGHT) return false;
  if (kind == K_METAL) {       // material.h:81-92
    const float ux = r.dx * inv_dlen, uy = r.dy * inv_dlen,
                uz = r.dz * inv_dlen;
    const float ud_n = ux * n[0] + uy * n[1] + uz * n[2];
    out[0] = (ux - 2.f * ud_n * n[0]) + aux * s.x;
    out[1] = (uy - 2.f * ud_n * n[1]) + aux * s.y;
    out[2] = (uz - 2.f * ud_n * n[2]) + aux * s.z;
    return (out[0] * n[0] + out[1] * n[1] + out[2] * n[2]) > 0.f;
  }
  if (kind == K_DIELECTRIC) {  // material.h:104-141
    const float d_n = r.dx * n[0] + r.dy * n[1] + r.dz * n[2];
    const bool exiting = d_n > 0.f;
    const float sgn = exiting ? -1.f : 1.f;
    const float onx = sgn * n[0], ony = sgn * n[1], onz = sgn * n[2];
    const float ni = exiting ? aux : 1.f / aux;
    const float cos_plain = (exiting ? d_n : -d_n) * inv_dlen;
    float cosine = cos_plain;
    if ((P.flags & DIE_REF_COSINE) && exiting) {
      const float qv = 1.f - aux * aux * (1.f - cos_plain * cos_plain);
      cosine = qv > 0.f ? sqrtf(fmaxf(qv, 0.f)) : 0.f;
    }
    const float ux = r.dx * inv_dlen, uy = r.dy * inv_dlen,
                uz = r.dz * inv_dlen;
    const float dtv = ux * onx + uy * ony + uz * onz;
    const float disc = 1.f - ni * ni * (1.f - dtv * dtv);
    const float sq = sqrtf(fmaxf(disc, 0.f));
    const float one_c = fmaxf(1.f - cosine, 0.f);
    float r0 = (1.f - aux) / (1.f + aux);
    r0 = r0 * r0;
    float c5 = one_c * one_c;
    c5 = c5 * c5 * one_c;
    const float refl_p = disc > 0.f ? r0 + (1.f - r0) * c5 : 1.f;
    if (s.w < refl_p) {        // reflect on the UNNORMALIZED direction
      out[0] = r.dx - 2.f * d_n * n[0];
      out[1] = r.dy - 2.f * d_n * n[1];
      out[2] = r.dz - 2.f * d_n * n[2];
    } else {                   // refract the unit direction
      out[0] = ni * (ux - onx * dtv) - onx * sq;
      out[1] = ni * (uy - ony * dtv) - ony * sq;
      out[2] = ni * (uz - onz * dtv) - onz * sq;
    }
    return true;
  }
  out[0] = n[0] + s.x;         // lambertian, material.h:60-68
  out[1] = n[1] + s.y;
  out[2] = n[2] + s.z;
  return true;
}

template <int INTEG, bool COUNT>
__global__ void __launch_bounds__(BLOCK) mega_kernel(Params P) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  Counts cnt{0, 0, 0};
  if (i < P.n) {
    Ray r{P.o[3 * (size_t)i], P.o[3 * (size_t)i + 1], P.o[3 * (size_t)i + 2],
          P.d[3 * (size_t)i], P.d[3 * (size_t)i + 1], P.d[3 * (size_t)i + 2]};
    float res[3];
    if (INTEG == PATH) {
      // render.h:48-67: emitted + attenuation * recursion; ambient on
      // absorb; sky on miss.  Step i is recursion depth max_depth - i.
      float thr[3] = {1.f, 1.f, 1.f};
      res[0] = res[1] = res[2] = 0.f;
      for (int step = 0; step <= P.max_depth; ++step) {
        const Hit h = closest_hit<COUNT>(P, r, cnt);
        const float inv_dlen =
            1.f / sqrtf(r.dx * r.dx + r.dy * r.dy + r.dz * r.dz);
        if (!(h.t < BIG_CUT)) {
          float s[3];
          sky(r.dy, inv_dlen, s);
          for (int k = 0; k < 3; ++k) res[k] += thr[k] * s[k];
          break;
        }
        const float px = r.ox + h.t * r.dx, py = r.oy + h.t * r.dy,
                    pz = r.oz + h.t * r.dz;
        float n[3], m[9], att[3], em[3], dir[3];
        load_winner(P, h, px, py, pz, n, m);
        mat_decode(m, px, py, pz, att, em);
        bool cont = false;
        if (step < P.max_depth && m[0] != K_LIGHT) {   // render.h:57
          const float4 s = (P.flags & INJECTED)
              ? __ldg(reinterpret_cast<const float4*>(
                    P.stream + ((size_t)step * P.n + i) * 4))
              : draw(P.seed, (uint32_t)i, (uint32_t)step);
          cont = scatter(P, r, n, m, inv_dlen, s, dir);
        }
        const float amb = cont ? 0.f : P.ambient;
        for (int k = 0; k < 3; ++k) res[k] += thr[k] * (em[k] + amb);
        if (!cont) break;
        for (int k = 0; k < 3; ++k) thr[k] *= att[k];
        r = Ray{px, py, pz, dir[0], dir[1], dir[2]};
      }
    } else {
      // LambertShade (render.h:70-87) and shade_normal (render.h:90-103):
      // one intersection.
      const Hit h = closest_hit<COUNT>(P, r, cnt);
      const bool hit = h.t < BIG_CUT;
      const float inv_dlen =
          1.f / sqrtf(r.dx * r.dx + r.dy * r.dy + r.dz * r.dz);
      float s[3];
      sky(r.dy, inv_dlen, s);
      if (!hit) {
        res[0] = s[0]; res[1] = s[1]; res[2] = s[2];
      } else {
        const float px = r.ox + h.t * r.dx, py = r.oy + h.t * r.dy,
                    pz = r.oz + h.t * r.dz;
        float n[3], m[9];
        load_winner(P, h, px, py, pz, n, m);
        if (INTEG == NORMAL) {
          res[0] = n[0]; res[1] = n[1]; res[2] = n[2];
        } else {
          float att[3], em[3];
          mat_decode(m, px, py, pz, att, em);
          const float scale = (P.flags & LAMBERT_UNNORM) ? 1.f : inv_dlen;
          const float tq =
              fmaxf((r.dx * n[0] + r.dy * n[1] + r.dz * n[2]) * scale, 0.f);
          for (int k = 0; k < 3; ++k)
            res[k] = att[k] * tq * s[k] * 0.2f + em[k];
        }
      }
    }
    P.out[3 * (size_t)i] = res[0];
    P.out[3 * (size_t)i + 1] = res[1];
    P.out[3 * (size_t)i + 2] = res[2];
  }
  if (COUNT) add_counts(P, cnt);
}

__global__ void __launch_bounds__(BLOCK) draws_kernel(
    float* out, int n, unsigned long long seed, uint32_t step) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i < n)
    reinterpret_cast<float4*>(out)[i] = draw(seed, (uint32_t)i, step);
}

template <int INTEG>
void launch_mega(const Params& P, cudaStream_t s) {
  const dim3 grid((P.n + BLOCK - 1) / BLOCK);
  if (P.counts) mega_kernel<INTEG, true><<<grid, BLOCK, 0, s>>>(P);
  else mega_kernel<INTEG, false><<<grid, BLOCK, 0, s>>>(P);
}

}  // namespace

extern "C" int crt_mega_trace(
    const void* sph, const void* sph_box, const void* sph_super,
    const void* tri, const void* tri_box, const void* tri_super,
    const void* o, const void* d, const void* stream, void* out,
    void* counts, int n, int n_sph_chunks, int n_sph_supers,
    int n_tri_supers, int integrator, int max_depth, float t_min,
    float t_max, float ambient, int flags, unsigned long long seed,
    void* cuda_stream) {
  Params P;
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
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(cuda_stream);
  switch (integrator) {
    case PATH: launch_mega<PATH>(P, s); break;
    case LAMBERT: launch_mega<LAMBERT>(P, s); break;
    case NORMAL: launch_mega<NORMAL>(P, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int crt_scatter_draws(void* out, int n, unsigned long long seed,
                                 int step, void* cuda_stream) {
  if (n <= 0) return 0;
  const dim3 grid((n + BLOCK - 1) / BLOCK);
  draws_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(cuda_stream)>>>(
      static_cast<float*>(out), n, seed, (uint32_t)step);
  return (int)cudaGetLastError();
}

extern "C" const char* crt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
