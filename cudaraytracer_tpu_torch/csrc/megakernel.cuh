// Fused path tracer for NVIDIA Hopper (sm_90a): the whole bounce loop of one
// ray in one thread, on persistent warps that refill finished lanes for the
// path integrator (mega_path), the triangle sweeps of streamed scenes and
// K12 shared by the lanes of a warp.  The device code and the launch
// templates; the C interface and the lambert and normal instances are in
// megakernel.cu, the path integrator's per-thread instances in
// megakernel_path.cu and megakernel_path_f2b.cu, the cooperative and K12
// instances in megakernel_coop.cu and megakernel_mxu.cu.
//
// Replaces: cudaraytracer_tpu/ops/megakernel.py::_mega_kernel, launched
// there by _mega_call through its single pl.pallas_call, in all eight of
// its modes.  Six are compile-time parameters of mega_kernel<INTEG, COUNT,
// XFORM, WINNERS, TEX, SHELLS, MXU, COOP> (the lambert and normal
// integrators and the cooperative path) and of mega_path<COUNT, XFORM,
// WINNERS, TEX, SHELLS, MXU, WINDOW> (the path integrator one thread per
// ray, below):
//   * K1, the main-path form (spheres + triangles, tables resident,
//     integrator path / lambert / normal, in-kernel draws or an injected
//     (ball, prob) stream): XFORM = WINNERS = false;
//   * K8, XFORM: rects and runtime-TRS spheres and triangles (rect_sweep,
//     tsph_sweep, ttri_sweep over trs_ray_chunk, _trs_table_sweep and
//     trs_merge, megakernel.py:1119-1362), after the sphere and triangle
//     sweeps;
//   * K7, WINNERS (path only): each bounce's winner in the scene's prim ids
//     (want_winners, megakernel.py:1445-1615, mapped as _winners_to_scene
//     :2778 does);
//   * K9, TEX (path and lambert): image textures, the texel fetched in the
//     bounce loop (what want_tex, megakernel.py:1574-1596 and :1720-1743,
//     and _deferred_texture_radiance :2254 compute together).
//   * K11, SHELLS (f2b, shelled :795): the triangle sweep's top-level
//     boxes visited in B passes by distance from the ray origin;
//   * K12, MXU (tri_sweep_mxu :974-1114, tri_coef :394-418): the streamed
//     triangle sweep as bilinear forms of the ray's features (below).
// Two are runtime parameters:
//   * K6, the segment level (stream_tri / stream_sph, megakernel.py:669-726
//     and :919-972): above 8,192 prims of a type the table gets one box per
//     SEG_T = 2048 prims, tested before the super and chunk boxes; the
//     path integrator's launches above 8,192 triangles take the
//     cooperative instances (COOP, below);
//   * K10, the bounce window (resume / dump_state / step_lo / n_steps,
//     megakernel.py:1607-1646): global steps [step_lo, step_lo + n_steps)
//     over the path state's planes in ray-id order, updated in place, an
//     optional order of the rays and their keys for the next window; a
//     runtime branch of the cooperative path instances, and in mega_path
//     only the WINDOW instances carry its code.
// Also exposes that kernel's draw transform as a kernel of its own,
// scatter_draws (ops/pallas_intersect.py::_draws_kernel).
//
// What bounds it on this card: FP32 ALU issue on the per-ray sweeps (the
// sphere quadratic and the Moller-Trumbore test over every chunk whose box
// the ray reaches), and divergence, since neighbouring rays reach different
// chunks and end their paths at different bounces.  Memory traffic is small:
// a ray is read once and its radiance written once, and the tables (tens of
// KB to a few hundred KB) stay in L1/L2; above 8,192 prims (K6) they grow
// to 12 MB at 128k triangles (inside the 50 MB L2) and 100 MB at 1M.
//
// What the simple design does about that:
//   * one thread per ray, the bounce loop in registers, as the reference
//     renderer does (render.h:105-129).  The caller orders rays in 32x16
//     screen blocks, so the 32 rays of a warp start coherent.  The path
//     integrator runs on persistent warps that refill finished lanes (K1
//     and K9 below);
//   * the TPU kernel's per-tile any() votes become per-thread branches on
//     the chunk and super boxes (two-level culling), and one best_t is
//     shared by the sphere and triangle sweeps, so triangles behind the
//     nearest sphere are culled too;
//   * every box is widened: a triangle box by TRI_MARGIN, a sphere box by
//     SPH_MARGIN x (its largest |coordinate| + the ray origin's; both
//     derived in ops/sweeps.py), so that no level culls a hit the test
//     accepts (the TPU tables' exact boxes lose triangle hits an ulp
//     outside their vertices' box and sphere hits on lines that miss the
//     sphere by a rounding; a ray grazing a sliver below TRI_WELL may still
//     lose its hit).  The ray's share is its SlabRay's two origins;
//   * the sweep carries only (best_t, best_idx, is_tri); the winner's row is
//     loaded after the sweep with plain loads (the TPU kernel carried the
//     attributes through every chunk merge);
//   * tables are read from global memory through L1/L2.  Staging the
//     resident box tables and sphere centres in shared memory was measured
//     and left out (K1 and K9 below);
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
// K8.  After the sphere and triangle sweeps (which share best_t) each
// thread walks the rect, TRS-sphere and TRS-triangle rows class by class.
// Per row: TransformRay (ScaleRay divides the direction by the scale and
// renormalizes it and leaves the origin unscaled, RotateRay multiplies
// origin and direction by the row-major matrix, TranslateRay subtracts the
// position), the test in the native t of the unit object-space ray, then
// t_native / |raw d| taken by the rule (t, class, row): nearer, or as near
// with a lower row of the same class, so classes earlier in [spheres |
// triangles | rects | t_spheres | t_triangles] win exact ties, and the
// lowest row within a class, in any visit order.  ScaleRay's direction is
// memoized across consecutive rows of equal scale (bit for bit).
//   A class of at least XFORM_CULL_MIN rows (ops/megakernel.py) is walked
// in chunks of XFORM_CHUNK rows, in the Morton order of their world boxes
// (the rows stay in scene order; a chunk's rows come from an order array).
// The geometry the cull rests on is the reference's quirk: a row's hit at
// native t is the world point o + t normalize(d / s) on its world object
// M^T (S + p) (a rect's corners, a TRS sphere of radius r about M^T p, a
// TRS triangle's vertices: the scale bends the ray, not the object), and on
// axis k the parameter of o + l (d / s) at a plane is the raw slab
// parameter times s_k.  So a chunk carries its world box, widened by
// XFORM_MARGIN, and its rows' scale ranges [a, b]; one raw slab and a few
// products bound l over the chunk's rows (xchunk), and t_native / |raw d|
// >= l / max b.  A chunk whose scales are not all positive is never culled.
// A later chunk may hold a lower row of the same class at exactly the best
// t, so such a chunk is culled only when it starts strictly beyond it.
// Chunks of 8 rows took 0.84x the time of 16 on (i), and super boxes over
// 16 chunks 1.23x their absence (PERF.md), so there is one level.
//   The path integrator (mega_path) walks the chunks with the warp
// together (xform_hit_coop): each lane tests its own ray's boxes, and for a
// chunk some lane's ray reached the lanes split its (ray, row) tests, the
// rays' nearest (t, row) coming back through a shared-memory atomicMin, as
// K6 splits a chunk's triangles.  One thread per ray serialized the union
// of the warp's reached chunks (rows scattered over the scene reach a ray
// about 15 chunks of 16 rows a class on (i)): 2.0x the cooperative walk's
// time there on an H100.  The lambert and normal integrators walk one ray
// per thread.  Below XFORM_CULL_MIN rows (light_box's one rect, the
// showcase's four) the rows are walked in table order, every row tested.
// The winner's record is recomputed once after the sweep: the OBJECT-space
// hit point (the reference's rec.p quirk: also the scattered ray's origin
// and the checker point), the pre-rotated normal and the material block.
// No per-class cap; the rows and boxes are read through L1/L2.

// K7.  The path integrator writes int32 winners[step * n + i] (step-major,
// so a warp's stores coalesce): the winner's scene id at each bounce that
// hits (a light included), read from the row's id column on the cache line
// the winner's normal and material come from (the row -> scene map was a
// dependent load: -1% on random_spheres' recording launch on an H100), -1
// at the bounce that misses and at every bounce after the path ended.  One
// fill of winners before the launch in place of those per-lane -1 stores
// was measured and left out: no time either way (PERF.md).

// K1 and K9 on Hopper (mega_path).  The path integrator one thread per ray
// (K1; K7, K8 and K9 add to the same loop) lost its time to tails and to
// idle lanes: a grid of a block per 128 rays ran ~1.7 waves of resident
// blocks at 2^18 rays, each ending on its longest paths, and a warp ran
// until its longest path (up to 9 bounces) ended while the lanes whose
// rays had missed sat idle (56% of the lanes' steps used on random_spheres'
// first 2^18 rays).  mega_path launches only the blocks the card keeps
// resident (the occupancy query, once an instance, times the SMs).  Each
// warp loops: when at least REFILL_IDLE of its lanes are idle, a leader
// takes that many ray indices from an int32 counter (one atomicAdd; the
// launch zeroes the counter on its stream first) and the idle lanes
// rank themselves by __popc; then every lane with a path makes one
// bounce, and a lane whose path ends writes it and goes idle.  A lane at
// bounce 0 and one at bounce 5 run the same code (one sweep, one shading),
// so a refilled warp diverges no more than a warp whose rays reach
// different boxes.  The schedule changes no bit: a ray's draws are keyed
// by (seed, ray id, step), its injected stream row is its ray id, and its
// radiance, winners (the trailing -1s included) and plane column go to
// the rows of its index, whichever lane serves it.  The counting instance
// runs the same loop and counts bounces, warp steps and draws (Counts), so
// bounce / (32 warp_step) is the lanes' use it ran.
//   The path instances carry K10's window code (order, resume, the plane
// write-back, the keys) only with WINDOW: the window instances (the path
// integrator without winners, which the compaction drivers launch), and the
// counting instance, which any window may reach.  K1's and K9's production
// instances have none of it.
//   What bounds them now (PERF.md, an H100): FP32 issue on the sweeps
// over a frame's rays (frame-sized (a) 22.7 -> 15.5 ms against a 3.1 ms
// bound, the lanes' use 0.56 -> 0.69), and at the main path's 2^18 rays a
// launch the drain: the last paths of a launch run on a card that has run
// out of rays, so a 2^18-ray launch costs about 1.7x its share of a
// frame-sized one.  Two further designs were measured on the card and
// left out: staging the resident box tables and sphere centres in shared
// memory (slower on every fused frame than this layout at 8 blocks an
// SM), and images packed four bytes a texel for one aligned load (K9's
// launch moved less than its spread): the texel stays three byte loads.
//
// K9.  The TPU kernel cannot gather texels, so the JAX package runs it with
// a placeholder albedo, dumps ten planes per bounce and multiplies the
// texels back in outside the kernel.  Here the thread loads them: an image
// material's block carries its image id, w and h in the color0 slots (an
// image uses neither colour), and after the sweep the winner's (u, v) is
// computed as ops/intersect.py::finalize_hits defines it: get_sphere_uv's
// z-theta of the unit normal for spheres and TRS spheres (the normal the
// kernel already has), the Moller-Trumbore (u, v) recomputed for a triangle
// winner from its row (the JAX deferred pass solves a Gram system instead;
// the port's kernel, its plain version, the wavefront and the replay all
// use Moller-Trumbore), and the object-space (x, y) + 0.5 for rects.  The
// nearest texel: i = int(u * w), j = int((1 - v) * h - 0.001), each
// clamped to the image's own size (a NaN lands on texel 0), three bytes
// each divided by 255 and rounded once (the reference's int(data) / 255.0).
// Lambertian attenuation reads texel (0, 0) under the lambertian_zero_uv
// quirk (material.h:67), the real (u, v) otherwise, as does the lambert
// integrator's att term of an image light (scatter's lam_att); emission
// reads the real (u, v).  Dielectrics (attenuation 1)
// and metals (their albedo; a metal ignores its texture) fetch nothing, and
// the normal integrator has no TEX instance.  The extra cost is one uv and
// at most two 3-byte loads per image hit, through L1/L2; textures never
// change a path, so the counting instance runs without TEX.
//
// K6.  A GPU has no VMEM to stream into: the TPU kernel's per-segment DMA
// becomes a third box level over the same global-memory tables.  When
// n_tri_segs > 0 each ray tests each segment box, then that segment's 8
// super boxes, then each super's 16 chunk boxes, every level gated by the
// slab test against the running best_t; the same for spheres when
// n_sph_segs > 0 (their super level is then always on).  Segments, supers
// and chunks are walked in table order, so the first prim still wins ties.
// One thread per ray (still reached for measurement, per_thread) is
// bounded by divergence: a warp serializes the union of its lanes' reached
// chunks, and on incoherent bounces a reached chunk often has one or two
// active lanes, each testing 16 triangles alone.  The COOP instances walk
// the boxes with the warp in lockstep: each lane makes its own ray's slab
// tests, a ballot gives the rays that reached a chunk, and the lanes split
// its 16 triangles x those rays, two rays a pass; each ray's least (t,
// row) comes back through a shared-memory atomicMin on an order-preserving
// key, and its lane combines it by the rule "nearer, or as near with a
// lower row" before its next slab test.  So the tests and every decision
// are the per-thread sweep's.  A chunk that more than COOP_LANE_RAYS rays
// reached (coherent camera rays) is tested one ray per lane, as before.
// What bounds it now: the slab tests of the box walk, issued warp-uniform,
// and the ballots and warp syncs per reached box.  Camera rays gain nothing
// from the cooperation and pay those (+4% on the 128,000-triangle field's
// bounce 0, +7% on the 1M-triangle field's lambert frame on an H100), so
// the lambert and normal integrators, which trace camera rays only, keep
// one thread per ray, as does every sphere sweep (no main-path scene
// streams spheres); the COOP instances serve the path integrator on
// streamed triangles (launch in megakernel.cu).
//
// K10.  The path integrator runs global steps [step_lo, step_lo + n_steps):
// the depth budget (render.h:57) tests the global step.  A windowed render
// keeps its path state in planes float32[13, n] in ray-id order [rad | o |
// d | thr | alive] (the plane layout of the TPU kernel's out_ref[0..12],
// megakernel.py:1632-1645), updated in place: thread i serves ray order[i]
// (i without an order), keys its draws by (seed, ray, step) and reads the
// injected stream at that ray's row, so a render whose windows see the rays
// in any order (the compaction drivers) is bit-identical to the monolithic
// one.  A window at step 0 starts each ray from its camera ray and writes
// its column; a later one resumes the rays alive in their columns (a dead
// ray's thread leaves after loading its alive flag, and a warp of dead rays
// at its first vote), adds its radiance to the column's rad (the only
// non-zero term of a path is its last, so the sum is the monolithic one)
// and writes o, d, thr and alive back.  order is a permutation, so no two
// threads share a column.  With key the thread also writes its ray's
// regrouping key for the next window at the column: DEAD_KEY for a dead
// ray, else 0 (alive first), the direction-octant key or the 30-bit Morton
// code of the origin, quantized over the scene's box (key_mode, the
// tables' key_bounds, regroup_key).  The driver sorts the keys once per boundary for the next
// order; a dead ray keeps the DEAD_KEY its last window wrote.  (The TPU
// kernel keys its draws by tile and lane, megakernel.py:1895-1900, and its
// drivers gather the dumped rows between windows.)
//
// K11.  With f2b = B > 0 (the SHELLS instances: as a runtime branch the
// shell loop raised the K1 path instance's spill from 40 to 134 bytes and
// its frame-sized launch by 3% on an H100) the triangle sweep's top-level
// boxes (segments when there are any, supers otherwise) are visited in B
// passes: a scan finds the least and greatest squared distance from the
// ray origin to a box, and pass s visits the boxes whose shell index
// min(floor((d2 - dmin) * B / max(dmax - dmin, 1e-30)), B - 1) is s, each
// box exactly once.  The TPU kernel measures from its tile's alive-origin
// centroid; here a thread is the unit of culling, so it measures from its
// own origin.  A triangle that ties the best t exactly wins when its row is
// lower, so the result does not depend on the visit order (a box whose near
// face lies exactly at best_t is still culled: JAX's caveat,
// megakernel.py:768-772).  Under COOP each lane ranks its ray's segments
// once per bounce (two distances per segment: the scan, then the shell,
// kept as one byte per (segment, lane) in the warp's dynamic shared
// memory); the warp ORs the lanes' one-hot shell bits per segment and keeps
// one bit per (shell, segment), then walks only the set bits, in (shell,
// table) order, and a lane enters segment j in its own ray's shell pass of
// it.  So each ray visits the boxes in the per-thread sweep's order, and no
// vote is spent on a pair that no lane's ray holds.  A byte holds a shell
// below MAX_SHELLS; a launch with more shells sweeps one thread per ray.
//
// K12.  Every Moller-Trumbore quantity is bilinear in 10 per-ray features
// Phi = [d, o, c = d x o, 1]: a = -d.n2 (n2 = e1 x e2), t_num = o.n2 -
// v0.n2, u_num = d.(v0 x e2) - c.e2, v_num = -d.(v0 x e1) + c.e1 and the
// backface quirk's d.n.  The TPU evaluates a whole super as one (5 * 256 x
// 10) @ (10 x 128 rays) matmul on its MXU.  Hopper has no float32
// tensor-core path (TF32 keeps 10 mantissa bits, too few for t), so the
// product runs on the FP32 cores with exact per-pair arithmetic: each
// quantity the sum of its non-zero terms in feature order, then f = 1 / a;
// u, v, t = u_num * f, v_num * f, t_num * f and the validity gates of
// megakernel.py:1032-1041; every triangle of a super the ray's slab tests
// reach is tested (no chunk culling inside a super, as on the TPU).
// tri_coef keeps only the 22 non-zero coefficients (C_A ... C_DN), padded
// to N_COEF = 24, as 24 planes of 256 floats per super: 96 B a triangle.
// One thread per ray read 19-22 scalars per triangle test and
// serialized the union of a warp's reached supers; it stays as the
// counting instance the cooperative one is held against.  The COOP sweep
// is the (triangles x rays) product by lanes: the warp walks segments and
// supers in lockstep, each lane slab-testing its own ray; for a super any
// lane's ray reached, lane l loads triangle 32 b + l's coefficients into
// registers (one coalesced 128-byte load per plane and batch b) and tests
// it against each reached ray in turn, the ray's features broadcast from
// the warp's shared slot; each ray's least (t, row) returns through the
// atomicMin key and is taken when strictly nearer, so the lowest row keeps
// a tie.  Loads per (ray, triangle) pair fall from 19-22 to 22 / R for R
// reached rays, and every lane tests a real pair however few rays reached
// the super.  What bounds it now: FP32 issue (~47 FLOPs and 9 shared
// loads per pair) and the 10x more tests than the closest hit needs that
// the mode's contract makes.  The MXU instances have WINNERS = TEX =
// SHELLS = false (JAX forces f2b to 0 and never records winners under it).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false -c
//        -Xcompiler -fPIC for each of the five megakernel*.cu, in
//        parallel, then nvcc -shared (plain C interface, loaded with
//        ctypes; ops/_cuda.py).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace crt {

constexpr float BIG = 3.4028235e38f;   // ops/intersect.py BIG
constexpr float BIG_CUT = 1e37f;       // t >= BIG_CUT is a miss
constexpr float TRI_EPSILON = 1e-6f;
constexpr float TWO_PI = 6.283185307179586f;
// get_sphere_uv's constants: float32 pi and the float32 reciprocals that the
// plain version multiplies by
constexpr float PI_F = 3.141592653589793f;
constexpr float HALF_PI = 1.5707963267948966f;
constexpr float INV_PI = 0.3183098861837907f;
constexpr float INV_TWO_PI = 0.15915494309189535f;
// The boxes' margins (ops/sweeps.py TRI_MARGIN and SPH_MARGIN,
// ops/megakernel.py XFORM_MARGIN): each table box is widened by the margin
// x its own largest |coordinate|, and each ray widens every box it tests by
// the margin x its origin's largest |coordinate| (slab_ray)
constexpr float TRI_MARGIN = 9.765625e-4f;   // 2^-10
constexpr float SPH_MARGIN = 3.90625e-3f;    // 2^-8
constexpr float XFORM_MARGIN = 3.90625e-3f;  // 2^-8
constexpr int PRIM_CHUNK = 16;         // prims per chunk box
constexpr int CHUNKS_PER_SUPER = 16;   // SUPER_T = 256 prims per super box
constexpr int SUPERS_PER_SEG = 8;      // SEG_T = 2048 prims per segment box
constexpr int SUPER_T = PRIM_CHUNK * CHUNKS_PER_SUPER;
// K12: a triangle's non-zero coefficients (ops/megakernel.py Q_TERMS), each
// a plane of SUPER_T floats in its super's block: a on d (3), t_num on o
// and 1 (4), u_num and v_num on d and c (6 each), d.n on d (3), 2 pad
constexpr int N_COEF = 24;
constexpr int C_A = 0, C_T = 3, C_U = 7, C_V = 13, C_DN = 19;
// K10's planes: rad rgb, origin, direction, thr rgb, alive
constexpr int N_PLANES = 13;
constexpr int PL_O = 3, PL_D = 6, PL_THR = 9, PL_ALIVE = 12;
// K10's regrouping keys (regroup_key): a dead ray's sorts last; the octant
// key's Morton bits above OCT_SHIFT are the coarse origin cell, then 3
// direction-octant bits, then fine Morton
constexpr int DEAD_KEY = 2147483646;
constexpr int OCT_SHIFT = 18;
enum KeyMode { KEY_ALIVE = 0, KEY_OCTANT = 1, KEY_MORTON = 2 };
// K11 under COOP keeps a ray's shell of a box in one byte; a launch with
// more shells takes the per-thread sweep (launch in megakernel.cu)
constexpr int MAX_SHELLS = 256;
constexpr int SPH_COLS = 16;  // cx cy cz r2 1/r | 9 material | pad | id
constexpr int TRI_COLS = 24;  // v0 e1 e2 n | 9 material | id | 2 pad
constexpr int BOX_COLS = 8;   // lo.xyz hi.xyz | 2 pad
constexpr int S_INVR = 4, S_MAT = 5, S_ID = 15, T_N = 9, T_MAT = 12,
              T_ID = 21;
// rect / TRS rows (ops/megakernel.py): position, scale, row-major rotation,
// material, then per class
constexpr int X_POS = 0, X_SCL = 3, X_ROT = 6, X_MAT = 15;
constexpr int RECT_SGN = 24, RECT_NRM = 25, TSPH_R2 = 24, TSPH_INVR = 25;
constexpr int TTRI_V0 = 24, TTRI_E1 = 27, TTRI_E2 = 30, TTRI_NOBJ = 33,
              TTRI_NW = 36;
constexpr int RECT_COLS = 28, TSPH_COLS = 28, TTRI_COLS = 40;
// K8's chunk boxes (ops/megakernel.py _xform_chunks): the world box lo.xyz
// hi.xyz widened by XFORM_MARGIN, the rows' scale range a.xyz b.xyz, max b,
// 3 pad
constexpr int XBOX_COLS = 16, XB_BMAX = 12;
constexpr int XFORM_CHUNK = 8;    // rows a chunk (ops/megakernel.py)
constexpr int BLOCK = 128;
// The cooperative sweeps (K6, K12): a warp's lanes, its slot of shared
// memory, the empty key, and the most rays of a reached chunk that the
// lanes still split (above it each lane tests its own ray's 16 triangles)
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = BLOCK / 32;
constexpr unsigned long long NO_KEY = ~0ull;
constexpr int COOP_LANE_RAYS = 16;

enum Integrator { PATH = 0, LAMBERT = 1, NORMAL = 2 };
enum Flags {
  BACKFACE_ONLY = 1, NO_T_CLIP = 2, BACK_CULLING = 4, DIE_REF_COSINE = 8,
  LAMBERT_UNNORM = 16, INJECTED = 32, LAMBERT_ZERO_UV = 64
};
// material kinds and texture kinds (models/materials.py, models/textures.py)
constexpr float K_METAL = 1.f, K_DIELECTRIC = 2.f, K_LIGHT = 3.f;
constexpr float TEX_CHECKER = 1.f, TEX_IMAGE = 2.f;
constexpr float K_LAMBERTIAN = 0.f;
// an image material's block: image id, w, h in the color0 slots
constexpr int M_IMG = 3, M_W = 4, M_H = 5;

struct Params {
  const float* sph; const float* sph_box; const float* sph_super;
  const float* tri; const float* tri_box; const float* tri_super;
  const float* o; const float* d;
  const float* stream;        // [max_depth + 1, n, 4] when INJECTED
  float* out;                 // [n, 3] (none with planes, K10)
  unsigned long long* counts; // optional [8]: the tests of Counts; given,
                              // the counting variant runs
  unsigned char* touched;     // counting variant: 1 per chunk whose prims
                              // were tested, [sphere chunks | tri chunks]
  unsigned long long seed;
  int n, n_sph_chunks, n_sph_supers, n_tri_supers, max_depth, flags;
  float t_min, t_max, ambient;
  // kernel modes K8 and K7
  const float* rect; const float* tsph; const float* ttri;
  const int* sph_map; const int* tri_map;  // table row -> scene id
  int* winners;                            // [max_depth + 1, n] (K7)
  int n_rects, n_tsph, n_ttri, n_spheres, n_triangles;
  // K8's chunks of each class [rect, tsph, ttri]: boxes float32[nc, 16] and
  // the rows in the class's Morton order int32[n] (nc = 0: table order)
  const float* xbox[3];
  const int* xord[3];
  int n_xchunks[3];
  // kernel mode K9: the packed images uint8[I, img_h, img_w, 3]
  const uint8_t* images;
  int img_h, img_w;
  // kernel mode K6: segment boxes, float32[n_segs, 8] (0: no segment level)
  const float* sph_seg; const float* tri_seg;
  int n_sph_segs, n_tri_segs;
  int f2b;                    // K11: shells (0: table order)
  // kernel mode K10: global steps [step_lo, step_lo + n_steps), the path
  // state in planes [N_PLANES, n] by ray id, thread i serving ray order[i],
  // and key[ray] for the next window (key_mode over bounds, the tables'
  // key_bounds: lo xyz, span xyz); each optional but bounds
  int step_lo, n_steps;
  float* planes;
  const int* order;
  int* key;
  int key_mode;
  const float* bounds;
  // kernel mode K12: float32[T_pad / SUPER_T, N_COEF, SUPER_T] coefficients
  const float* tri_coef;
  // mega_path: the counter its warps take ray indices from (int32, zeroed
  // on the stream by run_path)
  int* next;
  // the counting variant's schedule counters [bounce, warp_step, draw]
  unsigned long long* work;
};

// jnp.minimum / jnp.maximum semantics: NaN in, NaN out (fminf would drop it)
__device__ __forceinline__ float nmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

struct Ray { float ox, oy, oz, dx, dy, dz; };

// What a ray's slab tests read: its inverse direction, and its origin as
// seen from a box's lo planes (ox + m) and hi planes (ox - m), so that every
// box it tests is widened by m on each side (csrc/sweeps.cu's SlabRay).
struct SlabRay { float ix, iy, iz, lx, ly, lz, hx, hy, hz; };

// m = margin x the origin's largest |coordinate|: TRI_MARGIN for triangle
// boxes, SPH_MARGIN for sphere boxes, XFORM_MARGIN for K8's chunk boxes
// (the tables widen each box by the same share of its own largest
// |coordinate|; the margins are derived in ops/sweeps.py and
// ops/megakernel.py).
__device__ __forceinline__ SlabRay slab_ray(const Ray& r, float margin) {
  const float m =
      margin * fmaxf(fmaxf(fabsf(r.ox), fabsf(r.oy)), fabsf(r.oz));
  return {1.f / r.dx, 1.f / r.dy, 1.f / r.dz, r.ox + m, r.oy + m, r.oz + m,
          r.ox - m, r.oy - m, r.oz - m};
}

// Negated slab test (megakernel.py:561-578): a ray with d_axis = 0 whose
// origin lies on a box plane gives 0 * inf = NaN, and NaN keeps the box
// reachable.
__device__ __forceinline__ bool slab(const float* box, const SlabRay& s,
                                     float best_t, float lo_cut) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(box));
  const float4 b = __ldg(reinterpret_cast<const float4*>(box + 4));
  const float tx0 = (a.x - s.lx) * s.ix, tx1 = (a.w - s.hx) * s.ix;
  const float ty0 = (a.y - s.ly) * s.iy, ty1 = (b.x - s.hy) * s.iy;
  const float tz0 = (a.z - s.lz) * s.iz, tz1 = (b.y - s.hz) * s.iz;
  const float near = nmax(nmax(nmin(tx0, tx1), nmin(ty0, ty1)),
                          nmin(tz0, tz1));
  const float far = nmin(nmin(nmax(tx0, tx1), nmax(ty0, ty1)),
                         nmax(tz0, tz1));
  return !((far < near) || (far < lo_cut) || (near >= best_t));
}

struct Hit {
  float t;
  int idx;
  bool tri;
};

// the rect / TRS winner: cls 0 none, 1 rect, 2 TRS sphere, 3 TRS triangle
struct XHit {
  int cls;
  int idx;
};

// box: chunk and super slab tests; rect, tsph, ttri: the rect / TRS rows
// tested (K8); seg: segment slab tests (K6); dist: the top-level boxes the
// shells rank (K11), one distance and one shell index each: the work the
// order needs (tri_shells recomputes the distance in every pass, which is
// not counted); xbox: K8's chunk tests
struct Counts {
  unsigned long long box, sph, tri, rect, tsph, ttri, seg, dist, xbox;
  // the schedule: bounces taken, warp steps run (the iterations of a warp's
  // loop in which some lane bounced) and draws made in the kernel
  unsigned long long bounce, warp_step, draw;
};
constexpr int N_COUNTS = 9;
constexpr int N_WORK = 3;


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

// Moller-Trumbore of one triangle row (its first 12 floats r0-r2) with the
// quirk gates (megakernel.py:828-877, triangle.h:61-94): whether it hits
// inside the window, and its t.
__device__ __forceinline__ bool tri_test(const Params& P, const Ray& r,
                                         const float4 r0, const float4 r1,
                                         const float4 r2, float& t) {
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
  if (P.flags & NO_T_CLIP) return valid && (t < P.t_max);
  return valid && (t > P.t_min) && (t < P.t_max);
}

// Row `row`'s hit at t takes h: nearer, or as near with a lower row.  A
// lower row wins an exact tie: the table-order result for any visit order
// of the boxes (K11).
__device__ __forceinline__ void take_tri(float t, int row, Hit& h) {
  if (t < h.t || (t == h.t && h.tri && row < h.idx)) {
    h.t = t; h.idx = row; h.tri = true;
  }
}

// Moller-Trumbore over one chunk, one ray.
__device__ __forceinline__ void tri_chunk(const Params& P, const Ray& r,
                                          int base, Hit& h) {
  for (int k = 0; k < PRIM_CHUNK; ++k) {
    const float* row = P.tri + (size_t)(base + k) * TRI_COLS;
    const float4 r0 = __ldg(reinterpret_cast<const float4*>(row));
    const float4 r1 = __ldg(reinterpret_cast<const float4*>(row + 4));
    const float4 r2 = __ldg(reinterpret_cast<const float4*>(row + 8));
    float t;
    if (tri_test(P, r, r0, r1, r2, t)) take_tri(t, base + k, h);
  }
}

// One sphere chunk: its box, then its 16 spheres.
template <bool COUNT>
__device__ __forceinline__ void sphere_box_chunk(const Params& P,
                                                 const Ray& r,
                                                 const SlabRay& sr, float a,
                                                 float inv_a, int c, Hit& h,
                                                 Counts& cnt) {
  if (COUNT) ++cnt.box;
  if (slab(P.sph_box + (size_t)c * BOX_COLS, sr, h.t, P.t_min)) {
    if (COUNT) {
      cnt.sph += PRIM_CHUNK;
      P.touched[c] = 1;
    }
    sphere_chunk(P, r, a, inv_a, c * PRIM_CHUNK, h);
  }
}

// One sphere super box, then its 16 chunks.
template <bool COUNT>
__device__ __forceinline__ void sphere_super(const Params& P, const Ray& r,
                                             const SlabRay& sr,
                                             float a, float inv_a, int s,
                                             Hit& h, Counts& cnt) {
  if (COUNT) ++cnt.box;
  if (!slab(P.sph_super + (size_t)s * BOX_COLS, sr, h.t, P.t_min))
    return;
  for (int j = 0; j < CHUNKS_PER_SUPER; ++j)
    sphere_box_chunk<COUNT>(P, r, sr, a, inv_a, s * CHUNKS_PER_SUPER + j,
                            h, cnt);
}

// One triangle super box, then its 16 chunk boxes and their triangles.
template <bool COUNT>
__device__ __forceinline__ void tri_super(const Params& P, const Ray& r,
                                          const SlabRay& sr,
                                          float lo_cut, int s, Hit& h,
                                          Counts& cnt) {
  if (COUNT) ++cnt.box;
  if (!slab(P.tri_super + (size_t)s * BOX_COLS, sr, h.t, lo_cut))
    return;
  for (int j = 0; j < CHUNKS_PER_SUPER; ++j) {
    const int c = s * CHUNKS_PER_SUPER + j;
    if (COUNT) ++cnt.box;
    if (slab(P.tri_box + (size_t)c * BOX_COLS, sr, h.t, lo_cut)) {
      if (COUNT) {
        cnt.tri += PRIM_CHUNK;
        P.touched[P.n_sph_chunks + c] = 1;
      }
      tri_chunk(P, r, c * PRIM_CHUNK, h);
    }
  }
}

// Top-level triangle box j: a segment and its 8 supers (K6), or a super.
template <bool COUNT>
__device__ __forceinline__ void tri_top(const Params& P, const Ray& r,
                                        const SlabRay& sr,
                                        float lo_cut, int j, Hit& h,
                                        Counts& cnt) {
  if (P.n_tri_segs == 0) {
    tri_super<COUNT>(P, r, sr, lo_cut, j, h, cnt);
    return;
  }
  if (COUNT) ++cnt.seg;
  if (!slab(P.tri_seg + (size_t)j * BOX_COLS, sr, h.t, lo_cut))
    return;
  for (int u = 0; u < SUPERS_PER_SEG; ++u)
    tri_super<COUNT>(P, r, sr, lo_cut, j * SUPERS_PER_SEG + u, h, cnt);
}

// Squared distance from the point (mx, my, mz) to a box (megakernel.py
// box_dist2: the point clipped into the box).
__device__ __forceinline__ float box_dist2(const float* box, float mx,
                                           float my, float mz) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(box));
  const float4 b = __ldg(reinterpret_cast<const float4*>(box + 4));
  const float qx = fminf(fmaxf(mx, a.x), a.w) - mx;
  const float qy = fminf(fmaxf(my, a.y), b.x) - my;
  const float qz = fminf(fmaxf(mz, a.z), b.y) - mz;
  return qx * qx + qy * qy + qz * qz;
}

// K11: the shell of a box, min(floor((d2 - dmin) * scale), B - 1); a NaN
// distance lands in shell 0, so every box is visited once.
__device__ __forceinline__ int shell_of(float d2, float dmin, float scale,
                                        int shells) {
  const float q = floorf((d2 - dmin) * scale);
  return q >= 0.f ? (q < (float)(shells - 1) ? (int)q : shells - 1) : 0;
}

// K11: the triangles' top-level boxes in f2b distance shells, each box
// visited once.
template <bool COUNT>
__device__ __forceinline__ void tri_shells(const Params& P, const Ray& r,
                                           const SlabRay& sr,
                                           float lo_cut, Hit& h,
                                           Counts& cnt) {
  const bool segs = P.n_tri_segs > 0;
  const int n_top = segs ? P.n_tri_segs : P.n_tri_supers;
  const float* top = segs ? P.tri_seg : P.tri_super;
  float dmin = 3.4e38f, dmax = 0.f;
  for (int j = 0; j < n_top; ++j) {
    const float d2 = box_dist2(top + (size_t)j * BOX_COLS, r.ox, r.oy, r.oz);
    dmin = fminf(dmin, d2);
    dmax = fmaxf(dmax, d2);
  }
  const float scale = (float)P.f2b / fmaxf(dmax - dmin, 1e-30f);
  if (COUNT) cnt.dist += (unsigned long long)n_top;
  for (int s = 0; s < P.f2b; ++s) {
    for (int j = 0; j < n_top; ++j) {
      const float d2 = box_dist2(top + (size_t)j * BOX_COLS, r.ox, r.oy,
                                 r.oz);
      if (shell_of(d2, dmin, scale, P.f2b) == s)
        tri_top<COUNT>(P, r, sr, lo_cut, j, h, cnt);
    }
  }
}

// K12: one triangle's bilinear forms on a ray's features ph = Phi[0:9]
// (the constant feature 1 multiplies only t_num's last coefficient), its
// coefficients c(k) summed term by term in feature order as the plain
// version sums them (the products JAX's matmul adds beside these are 0 *
// x); then f = 1 / a and the validity gates of megakernel.py:1032-1041.
// Whether the triangle hits inside the window, and its t.
template <class Coef>
__device__ __forceinline__ bool mxu_test(const Params& P, Coef c,
                                         const float ph[9], float& t) {
  const float a = (c(C_A) * ph[0] + c(C_A + 1) * ph[1]) + c(C_A + 2) * ph[2];
  if (!(fabsf(a) >= TRI_EPSILON)) return false;
  if ((P.flags & BACK_CULLING) && !(a >= TRI_EPSILON)) return false;
  const float tn = ((c(C_T) * ph[3] + c(C_T + 1) * ph[4])
                    + c(C_T + 2) * ph[5]) + c(C_T + 3);
  const float un = ((((c(C_U) * ph[0] + c(C_U + 1) * ph[1])
                      + c(C_U + 2) * ph[2]) + c(C_U + 3) * ph[6])
                    + c(C_U + 4) * ph[7]) + c(C_U + 5) * ph[8];
  const float vn = ((((c(C_V) * ph[0] + c(C_V + 1) * ph[1])
                      + c(C_V + 2) * ph[2]) + c(C_V + 3) * ph[6])
                    + c(C_V + 4) * ph[7]) + c(C_V + 5) * ph[8];
  const float f = 1.f / a;
  const float uu = un * f, vv = vn * f;
  t = tn * f;
  bool valid = (uu >= 0.f) && (uu <= 1.f) && (vv >= 0.f) &&
               (uu + vv <= 1.f);
  if (P.flags & BACKFACE_ONLY)
    valid = valid && ((c(C_DN) * ph[0] + c(C_DN + 1) * ph[1])
                      + c(C_DN + 2) * ph[2]) >= 0.f;
  if (P.flags & NO_T_CLIP) return valid && (t < P.t_max);
  return valid && (t > P.t_min) && (t < P.t_max);
}

// A ray's features Phi[0:9] = [d | o | c = d x o].
__device__ __forceinline__ void features(const Ray& r, float ph[9]) {
  ph[0] = r.dx; ph[1] = r.dy; ph[2] = r.dz;
  ph[3] = r.ox; ph[4] = r.oy; ph[5] = r.oz;
  ph[6] = r.dy * r.oz - r.dz * r.oy;
  ph[7] = r.dz * r.ox - r.dx * r.oz;
  ph[8] = r.dx * r.oy - r.dy * r.ox;
}

// K12, one thread per ray (the counting instance that the cooperative
// sweep is held against): the triangle segments and supers in table order,
// each gated by its slab test against the running best_t, every triangle
// of a reached super tested (megakernel.py:974-1114).  COUNT adds each
// triangle of a reached super as one tri test and marks its chunks.
template <bool COUNT>
__device__ __forceinline__ void tri_sweep_mxu(const Params& P, const Ray& r,
                                              const SlabRay& sr,
                                              float lo_cut, Hit& h,
                                              Counts& cnt) {
  float ph[9];
  features(r, ph);
  for (int g = 0; g < P.n_tri_segs; ++g) {
    if (COUNT) ++cnt.seg;
    if (!slab(P.tri_seg + (size_t)g * BOX_COLS, sr, h.t, lo_cut))
      continue;
    for (int u = 0; u < SUPERS_PER_SEG; ++u) {
      const int s = g * SUPERS_PER_SEG + u;
      if (COUNT) ++cnt.box;
      if (!slab(P.tri_super + (size_t)s * BOX_COLS, sr, h.t, lo_cut))
        continue;
      if (COUNT) {
        cnt.tri += SUPER_T;
        for (int j = 0; j < CHUNKS_PER_SUPER; ++j)
          P.touched[P.n_sph_chunks + s * CHUNKS_PER_SUPER + j] = 1;
      }
      const float* blk = P.tri_coef + (size_t)s * N_COEF * SUPER_T;
      for (int k = 0; k < SUPER_T; ++k) {
        float t;
        if (mxu_test(P, [&](int c) { return __ldg(blk + c * SUPER_T + k); },
                     ph, t) && t < h.t) {
          h.t = t; h.idx = s * SUPER_T + k; h.tri = true;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The cooperative sweeps (K6's triangle levels, K11's shells over them, K12)
//
// The warp walks the boxes in lockstep.  Each lane makes its own ray's
// slab tests against its own running best_t, in table order; a ballot
// gives the rays that reached a chunk (K6) or a super (K12), and the lanes
// split that box's (ray, triangle) tests.  Each ray's least (t, row) over
// the box comes back through a 64-bit shared-memory atomicMin on an
// order-preserving key, and its own lane combines it with its running hit
// by the per-thread rule, before the next box's slab test.  So the tests
// made, their arithmetic and every decision are those of the per-thread
// sweeps.  A lane whose ray is done (or past n) takes part with in = false.
// ---------------------------------------------------------------------------

// A warp's shared memory: each lane's ray features Phi[0:9] (K6 reads d
// and o) and its ray's least hit key over the box in hand.
struct CoopSlot {
  float ph[9][32];
  unsigned long long key[32];
};

__device__ __forceinline__ CoopSlot& coop_slot() {
  __shared__ CoopSlot slots[WARPS];
  return slots[threadIdx.x >> 5];
}

// The lane's ray into its slot, its key empty; every lane of the warp.
__device__ __forceinline__ void coop_store(const Ray& r) {
  CoopSlot& sl = coop_slot();
  const int lane = threadIdx.x & 31;
  float ph[9];
  features(r, ph);
  for (int k = 0; k < 9; ++k) sl.ph[k][lane] = ph[k];
  sl.key[lane] = NO_KEY;
  __syncwarp();
}

// An order-preserving key of a hit (t, row): the least t first, then the
// lowest row (a strict < scan in row order); a zero t keeps its sign in bit
// 0, so that key_t gives back t's bits.
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

__device__ __forceinline__ int key_row(unsigned long long k) {
  return (int)((uint32_t)k >> 1);
}

// After the lanes' atomics: the lane's ray (if it reached the box) takes
// its key's hit by K6's rule (take_tri) or K12's strict <, and empties the
// key for the next box.
template <bool STRICT>
__device__ __forceinline__ void coop_take(bool in, Hit& h) {
  CoopSlot& sl = coop_slot();
  const int lane = threadIdx.x & 31;
  __syncwarp();
  const unsigned long long k = sl.key[lane];
  if (in && k != NO_KEY) {
    const float t = key_t(k);
    if (!STRICT) take_tri(t, key_row(k), h);
    else if (t < h.t) { h.t = t; h.idx = key_row(k); h.tri = true; }
    sl.key[lane] = NO_KEY;
  }
  __syncwarp();
}

// K6: one chunk's 16 triangles for the rays of `mask` (in: this lane's ray
// is one).  Above COOP_LANE_RAYS rays each lane tests its own ray's 16 (a
// coherent warp); else the lanes split the pairs, 16 triangles x 2 rays a
// pass, lane l testing triangle l % 16.
__device__ __forceinline__ void tri_chunk_coop(const Params& P, const Ray& r,
                                               int base, unsigned mask,
                                               bool in, Hit& h) {
  if (__popc(mask) > COOP_LANE_RAYS) {
    if (in) tri_chunk(P, r, base, h);
    return;
  }
  CoopSlot& sl = coop_slot();
  const int lane = threadIdx.x & 31;
  const int row = base + (lane & (PRIM_CHUNK - 1));
  const float* p = P.tri + (size_t)row * TRI_COLS;
  const float4 r0 = __ldg(reinterpret_cast<const float4*>(p));
  const float4 r1 = __ldg(reinterpret_cast<const float4*>(p + 4));
  const float4 r2 = __ldg(reinterpret_cast<const float4*>(p + 8));
  for (unsigned m = mask; m;) {
    const int lo = __ffs(m) - 1;
    m &= m - 1;
    const int hi = m ? __ffs(m) - 1 : -1;
    if (m) m &= m - 1;
    const int src = lane < PRIM_CHUNK ? lo : hi;
    if (src < 0) continue;
    const Ray q{sl.ph[3][src], sl.ph[4][src], sl.ph[5][src],
                sl.ph[0][src], sl.ph[1][src], sl.ph[2][src]};
    float t;
    if (tri_test(P, q, r0, r1, r2, t))
      atomicMin(&sl.key[src], hit_key(t, row));
  }
  coop_take<false>(in, h);
}

// K6: one triangle super box, then its 16 chunk boxes and their triangles,
// for the warp (in: this lane's ray takes part).
template <bool COUNT>
__device__ __forceinline__ void tri_super_coop(const Params& P, const Ray& r,
                                               const SlabRay& sr,
                                               float lo_cut, int s, bool in,
                                               Hit& h, Counts& cnt) {
  if (COUNT && in) ++cnt.box;
  in = in && slab(P.tri_super + (size_t)s * BOX_COLS, sr, h.t, lo_cut);
  if (!__any_sync(FULL, in)) return;
  for (int j = 0; j < CHUNKS_PER_SUPER; ++j) {
    const int c = s * CHUNKS_PER_SUPER + j;
    if (COUNT && in) ++cnt.box;
    const bool at =
        in && slab(P.tri_box + (size_t)c * BOX_COLS, sr, h.t, lo_cut);
    const unsigned mask = __ballot_sync(FULL, at);
    if (!mask) continue;
    if (COUNT && at) {
      cnt.tri += PRIM_CHUNK;
      P.touched[P.n_sph_chunks + c] = 1;
    }
    tri_chunk_coop(P, r, c * PRIM_CHUNK, mask, at, h);
  }
}

// K6: triangle segment j and its 8 supers.
template <bool COUNT>
__device__ __forceinline__ void tri_seg_coop(const Params& P, const Ray& r,
                                             const SlabRay& sr,
                                             float lo_cut, int j, bool in,
                                             Hit& h, Counts& cnt) {
  if (COUNT && in) ++cnt.seg;
  in = in && slab(P.tri_seg + (size_t)j * BOX_COLS, sr, h.t, lo_cut);
  if (!__any_sync(FULL, in)) return;
  for (int u = 0; u < SUPERS_PER_SEG; ++u)
    tri_super_coop<COUNT>(P, r, sr, lo_cut, j * SUPERS_PER_SEG + u,
                          in, h, cnt);
}

// K11 under COOP: a warp's dynamic shared memory, n_top x 32 bytes (each
// lane's ray's shell of each segment, own[j * 32 + lane]) and then one bit
// per (shell, segment) for up to 32 shells at a time (bits[s * nw + w]
// holds segments 32 w .. 32 w + 31 of shell s).
__host__ __device__ inline int shell_warp_bytes(int n_top, int shells) {
  const int nw = (n_top + 31) / 32;
  return n_top * 32 + (shells < 32 ? shells : 32) * nw * 4;
}

__device__ __forceinline__ unsigned char* shell_smem(const Params& P) {
  extern __shared__ __align__(16) unsigned char crt_shells[];
  return crt_shells + (threadIdx.x >> 5) * shell_warp_bytes(P.n_tri_segs,
                                                            P.f2b);
}

// K11 over the cooperative sweep.  Each lane ranks its ray's segments once
// (the scan, then each segment's shell into its byte); then, for each group
// of 32 shells, the warp ORs its lanes' one-hot shell bits per segment
// (lane t keeps segment 32 w + t's), turns them into one bit per (shell,
// segment) by ballots, and walks the set bits in (shell, table) order: a
// lane enters segment j in the pass of its own ray's shell of it, so each
// ray visits the segments in tri_shells' order, and every pair walked has a
// lane that enters it.
template <bool COUNT>
__device__ __forceinline__ void tri_shells_coop(const Params& P, const Ray& r,
                                                const SlabRay& sr,
                                                float lo_cut, bool in, Hit& h,
                                                Counts& cnt) {
  const int n_top = P.n_tri_segs, lane = threadIdx.x & 31;
  const int nw = (n_top + 31) >> 5;
  unsigned char* own = shell_smem(P);
  uint32_t* bits = reinterpret_cast<uint32_t*>(own + n_top * 32);
  if (in) {
    float dmin = 3.4e38f, dmax = 0.f;
    for (int j = 0; j < n_top; ++j) {
      const float d2 = box_dist2(P.tri_seg + (size_t)j * BOX_COLS, r.ox, r.oy,
                                 r.oz);
      dmin = fminf(dmin, d2);
      dmax = fmaxf(dmax, d2);
    }
    const float scale = (float)P.f2b / fmaxf(dmax - dmin, 1e-30f);
    for (int j = 0; j < n_top; ++j)
      own[j * 32 + lane] = (unsigned char)shell_of(
          box_dist2(P.tri_seg + (size_t)j * BOX_COLS, r.ox, r.oy, r.oz), dmin,
          scale, P.f2b);
  }
  if (COUNT && in) cnt.dist += (unsigned long long)n_top;
  __syncwarp();
  for (int g = 0; g < P.f2b; g += 32) {
    const int gb = min(P.f2b - g, 32);
    for (int w = 0; w < nw; ++w) {
      uint32_t mine = 0u;
      const int jn = min(n_top - 32 * w, 32);
      for (int t = 0; t < jn; ++t) {
        const int s = in ? (int)own[(32 * w + t) * 32 + lane] - g : -1;
        const uint32_t m =
            __reduce_or_sync(FULL, (unsigned)s < 32u ? 1u << s : 0u);
        if (lane == t) mine = m;
      }
      for (int s = 0; s < gb; ++s) {
        const uint32_t b = __ballot_sync(FULL, (mine >> s) & 1u);
        if (lane == 0) bits[s * nw + w] = b;
      }
    }
    __syncwarp();
    for (int s = 0; s < gb; ++s)
      for (int w = 0; w < nw; ++w)
        for (uint32_t m = bits[s * nw + w]; m; m &= m - 1) {
          const int j = 32 * w + __ffs(m) - 1;
          tri_seg_coop<COUNT>(P, r, sr, lo_cut, j,
                              in && own[j * 32 + lane] == g + s, h, cnt);
        }
    __syncwarp();
  }
}

// K12 cooperative: the warp walks the segments and supers; for each super
// some lane's ray reached, lane l loads the coefficients of triangle 32 b +
// l (one coalesced load per plane and batch b of 32) and tests it against
// every reached ray in turn, that ray's features read from its slot.
template <bool COUNT>
__device__ __forceinline__ void tri_sweep_mxu_coop(const Params& P,
                                                   const Ray& r,
                                                   const SlabRay& sr,
                                                   float lo_cut, bool in,
                                                   Hit& h, Counts& cnt) {
  CoopSlot& sl = coop_slot();
  const int lane = threadIdx.x & 31;
  const bool dn = P.flags & BACKFACE_ONLY;
  for (int g = 0; g < P.n_tri_segs; ++g) {
    if (COUNT && in) ++cnt.seg;
    const bool at_g =
        in && slab(P.tri_seg + (size_t)g * BOX_COLS, sr, h.t, lo_cut);
    if (!__any_sync(FULL, at_g)) continue;
    for (int u = 0; u < SUPERS_PER_SEG; ++u) {
      const int s = g * SUPERS_PER_SEG + u;
      if (COUNT && at_g) ++cnt.box;
      const bool at =
          at_g && slab(P.tri_super + (size_t)s * BOX_COLS, sr, h.t, lo_cut);
      const unsigned mask = __ballot_sync(FULL, at);
      if (!mask) continue;
      if (COUNT && at) {
        cnt.tri += SUPER_T;
        for (int j = 0; j < CHUNKS_PER_SUPER; ++j)
          P.touched[P.n_sph_chunks + s * CHUNKS_PER_SUPER + j] = 1;
      }
      const float* blk = P.tri_coef + (size_t)s * N_COEF * SUPER_T + lane;
      for (int b = 0; b < SUPER_T; b += 32) {
        float c[C_DN + 3];
#pragma unroll
        for (int k = 0; k < C_DN + 3; ++k)
          c[k] = (k < C_DN || dn) ? __ldg(blk + k * SUPER_T + b) : 0.f;
        for (unsigned m = mask; m; m &= m - 1) {
          const int src = __ffs(m) - 1;
          float ph[9];
          for (int k = 0; k < 9; ++k) ph[k] = sl.ph[k][src];
          float t;
          if (mxu_test(P, [&](int k) { return c[k]; }, ph, t))
            atomicMin(&sl.key[src], hit_key(t, s * SUPER_T + b + lane));
        }
      }
      coop_take<true>(at, h);
    }
  }
}

// Closest hit over the sphere chunks (one, two or three box levels) and the
// triangle segments (K6), supers and chunks, the triangles' top level in
// shells with SHELLS (K11, P.f2b > 0), or their bilinear sweep with MXU
// (K12).  COOP: the triangles by the cooperative sweeps, which every lane
// of the warp enters (in: this lane's ray takes part); the spheres stay one
// thread per ray.  COUNT adds the tests made to cnt (a measurement-only
// variant; the production launches carry none of it).
template <bool COUNT, bool SHELLS, bool MXU, bool COOP>
__device__ Hit closest_hit(const Params& P, const Ray& r, Counts& cnt,
                           bool in) {
  Hit h{BIG, -1, false};
  if (P.n_sph_chunks > 0 && (!COOP || in)) {
    const SlabRay sr = slab_ray(r, SPH_MARGIN);
    const float a = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
    const float inv_a = 1.f / a;
    if (P.n_sph_segs > 0) {
      for (int g = 0; g < P.n_sph_segs; ++g) {
        if (COUNT) ++cnt.seg;
        if (!slab(P.sph_seg + (size_t)g * BOX_COLS, sr, h.t, P.t_min))
          continue;
        for (int u = 0; u < SUPERS_PER_SEG; ++u)
          sphere_super<COUNT>(P, r, sr, a, inv_a,
                              g * SUPERS_PER_SEG + u, h, cnt);
      }
    } else if (P.n_sph_supers == 0) {
      for (int c = 0; c < P.n_sph_chunks; ++c)
        sphere_box_chunk<COUNT>(P, r, sr, a, inv_a, c, h, cnt);
    } else {
      for (int s = 0; s < P.n_sph_supers; ++s)
        sphere_super<COUNT>(P, r, sr, a, inv_a, s, h, cnt);
    }
  }
  if (P.n_tri_supers > 0) {
    const float lo_cut = (P.flags & NO_T_CLIP) ? -BIG : P.t_min;
    const SlabRay sr = slab_ray(r, TRI_MARGIN);
    if constexpr (COOP) {
      coop_store(r);
      if constexpr (MXU) {
        tri_sweep_mxu_coop<COUNT>(P, r, sr, lo_cut, in, h, cnt);
      } else if constexpr (SHELLS) {
        tri_shells_coop<COUNT>(P, r, sr, lo_cut, in, h, cnt);
      } else {
        for (int j = 0; j < P.n_tri_segs; ++j)
          tri_seg_coop<COUNT>(P, r, sr, lo_cut, j, in, h, cnt);
      }
    } else if constexpr (MXU) {
      tri_sweep_mxu<COUNT>(P, r, sr, lo_cut, h, cnt);
    } else if constexpr (SHELLS) {
      tri_shells<COUNT>(P, r, sr, lo_cut, h, cnt);
    } else {
      const int n_top = P.n_tri_segs > 0 ? P.n_tri_segs : P.n_tri_supers;
      for (int j = 0; j < n_top; ++j)
        tri_top<COUNT>(P, r, sr, lo_cut, j, h, cnt);
    }
  }
  return h;
}

// ScaleRay's direction (transform.h:11-14: d / s renormalized) for the
// scale of the row, and the last scale it was computed for, bit for bit: a
// walk whose consecutive rows share their scale (a field of equal rects)
// divides, takes the square root and the reciprocal once.  A memo lives for
// one sweep of one ray; its first scale, all bits set, is never taken as a
// match.
struct ScaleMemo {
  uint32_t sx, sy, sz;
  float dx, dy, dz;
};

__device__ __forceinline__ ScaleMemo scale_memo() {
  return {0xffffffffu, 0xffffffffu, 0xffffffffu, 0.f, 0.f, 0.f};
}

__device__ __forceinline__ void scale_dir(const float* row, const Ray& r,
                                          ScaleMemo& mm) {
  const float s0 = __ldg(row + X_SCL), s1 = __ldg(row + X_SCL + 1),
              s2 = __ldg(row + X_SCL + 2);
  const uint32_t b0 = __float_as_uint(s0), b1 = __float_as_uint(s1),
                 b2 = __float_as_uint(s2);
  if (b0 == mm.sx && b1 == mm.sy && b2 == mm.sz && b0 != 0xffffffffu)
    return;
  const float dsx = r.dx / s0, dsy = r.dy / s1, dsz = r.dz / s2;
  const float inv_dl = 1.f / sqrtf(dsx * dsx + dsy * dsy + dsz * dsz);
  mm = {b0, b1, b2, dsx * inv_dl, dsy * inv_dl, dsz * inv_dl};
}

// TransformRay (transform.h:11-14) through one rect / TRS row, the scaled
// direction from scale_dir: RotateRay multiplies origin and direction by
// the row-major matrix, TranslateRay subtracts the position.
__device__ __forceinline__ Ray trs_ray(const float* row, const Ray& r,
                                       const ScaleMemo& mm) {
  const float* m = row + X_ROT;
  Ray x;
  x.dx = __ldg(m) * mm.dx + __ldg(m + 1) * mm.dy + __ldg(m + 2) * mm.dz;
  x.dy = __ldg(m + 3) * mm.dx + __ldg(m + 4) * mm.dy + __ldg(m + 5) * mm.dz;
  x.dz = __ldg(m + 6) * mm.dx + __ldg(m + 7) * mm.dy + __ldg(m + 8) * mm.dz;
  x.ox = __ldg(m) * r.ox + __ldg(m + 1) * r.oy + __ldg(m + 2) * r.oz
         - __ldg(row + X_POS);
  x.oy = __ldg(m + 3) * r.ox + __ldg(m + 4) * r.oy + __ldg(m + 5) * r.oz
         - __ldg(row + X_POS + 1);
  x.oz = __ldg(m + 6) * r.ox + __ldg(m + 7) * r.oy + __ldg(m + 8) * r.oz
         - __ldg(row + X_POS + 2);
  return x;
}

// rectangle.h:22-44 on the object-space ray: the unit rect on z = 0, the
// window inclusive (megakernel.py:1196-1209).  Writes the native t.
__device__ __forceinline__ bool rect_test(const Params& P, const float* row,
                                          const Ray& x, float& tn) {
  tn = -x.oz / x.dz;
  const float px = x.ox + tn * x.dx, py = x.oy + tn * x.dy;
  const float facing = x.dz * __ldg(row + RECT_SGN);
  return (facing <= 0.f) && (tn >= P.t_min) && (tn <= P.t_max) &&
         (px >= -0.5f) && (px <= 0.5f) && (py >= -0.5f) && (py <= 0.5f);
}

// sphere.h:27-55 on the object-space ray (megakernel.py:1236-1258): the
// near root in the native window, else the far one.
__device__ __forceinline__ bool tsph_test(const Params& P, const float* row,
                                          const Ray& x, float& tn) {
  const float b = x.ox * x.dx + x.oy * x.dy + x.oz * x.dz;
  const float a = x.dx * x.dx + x.dy * x.dy + x.dz * x.dz;
  const float c = x.ox * x.ox + x.oy * x.oy + x.oz * x.oz
                  - __ldg(row + TSPH_R2);
  const float disc = b * b - a * c;
  const bool has = disc > 0.f;
  const float sq = sqrtf(has ? disc : 0.f);
  const float inv_a = 1.f / a;
  const float t0 = (-b - sq) * inv_a;
  const float t1 = (-b + sq) * inv_a;
  const bool ok0 = has && (t0 < P.t_max) && (t0 > P.t_min);
  const bool ok1 = has && (t1 < P.t_max) && (t1 > P.t_min);
  tn = ok0 ? t0 : t1;
  return ok0 || ok1;
}

// Moller-Trumbore on the object-space ray against object-space vertices,
// the quirk gates on the transformed direction (megakernel.py:1284-1321).
__device__ __forceinline__ bool ttri_test(const Params& P, const float* row,
                                          const Ray& x, float& tn,
                                          float* uv = nullptr) {
  const float e1x = __ldg(row + TTRI_E1), e1y = __ldg(row + TTRI_E1 + 1),
              e1z = __ldg(row + TTRI_E1 + 2);
  const float e2x = __ldg(row + TTRI_E2), e2y = __ldg(row + TTRI_E2 + 1),
              e2z = __ldg(row + TTRI_E2 + 2);
  const float hx = x.dy * e2z - x.dz * e2y;
  const float hy = x.dz * e2x - x.dx * e2z;
  const float hz = x.dx * e2y - x.dy * e2x;
  const float a = e1x * hx + e1y * hy + e1z * hz;
  const float f = 1.f / a;
  const float sx = x.ox - __ldg(row + TTRI_V0);
  const float sy = x.oy - __ldg(row + TTRI_V0 + 1);
  const float sz = x.oz - __ldg(row + TTRI_V0 + 2);
  const float u = f * (sx * hx + sy * hy + sz * hz);
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  const float v = f * (x.dx * qx + x.dy * qy + x.dz * qz);
  tn = f * (e2x * qx + e2y * qy + e2z * qz);
  if (uv) { uv[0] = u; uv[1] = v; }
  bool valid = (fabsf(a) >= TRI_EPSILON) && (u >= 0.f) && (u <= 1.f) &&
               (v >= 0.f) && (u + v <= 1.f);
  if (P.flags & BACK_CULLING) valid = valid && (a >= TRI_EPSILON);
  if (P.flags & BACKFACE_ONLY)
    valid = valid && (x.dx * __ldg(row + TTRI_NOBJ)
                      + x.dy * __ldg(row + TTRI_NOBJ + 1)
                      + x.dz * __ldg(row + TTRI_NOBJ + 2)) >= 0.f;
  if (P.flags & NO_T_CLIP) valid = valid && (tn < P.t_max);
  else valid = valid && (tn > P.t_min) && (tn < P.t_max);
  return valid;
}

// Row k of K8's class CLS (1 rect, 2 TRS sphere, 3 TRS triangle).
template <int CLS>
__device__ __forceinline__ const float* xrow(const Params& P, int k) {
  if constexpr (CLS == 1) return P.rect + (size_t)k * RECT_COLS;
  if constexpr (CLS == 2) return P.tsph + (size_t)k * TSPH_COLS;
  return P.ttri + (size_t)k * TTRI_COLS;
}

// Row k's test on its object-space ray, and t_native / |raw d| taken by the
// rule (t, class, row): nearer, or as near with a lower row of the same
// class; an earlier class keeps an exact tie ([spheres | triangles | rects
// | t_spheres | t_triangles], the plain version's strict <).
template <int CLS>
__device__ __forceinline__ void xform_row(const Params& P, const Ray& r,
                                          float inv_raw, int k,
                                          ScaleMemo& mm, Hit& h, XHit& xh) {
  const float* row = xrow<CLS>(P, k);
  scale_dir(row, r, mm);
  const Ray x = trs_ray(row, r, mm);
  float tn;
  bool ok;
  if constexpr (CLS == 1) ok = rect_test(P, row, x, tn);
  else if constexpr (CLS == 2) ok = tsph_test(P, row, x, tn);
  else ok = ttri_test(P, row, x, tn);
  if (ok) {
    const float t = tn * inv_raw;
    if (t < h.t || (t == h.t && xh.cls == CLS && k < xh.idx)) {
      h.t = t;
      xh = XHit{CLS, k};
    }
  }
}

// K8's chunk test.  A row's object-space hit at native t is the world point
// o + t normalize(d / s) on the row's world object (megakernel.py's
// build: ``_xform_chunks``), and on axis k the parameter of o + l (d / s)
// at a plane is the raw slab parameter (plane - o_k) / d_k times s_k.  So
// over the chunk's rows, whose scales lie in [a, b] (all positive), l lies
// in [max_k min(en_k a_k, en_k b_k), min_k max(ex_k a_k, ex_k b_k)] (en, ex
// the raw entry and exit of the chunk's widened world box), and t_native /
// |raw d| >= l / max_k b_k for l >= 0.  The chunk is culled when that range
// is empty, lies behind the origin (lo_ok: the class's window starts at or
// above 0), or starts beyond the best t.  A chunk may hold a lower row of
// the same class at exactly the best t, so then it is culled only when it
// starts strictly beyond it.  A chunk whose rows' scales are not all
// positive holds an infinite box (never culled); NaN keeps a chunk.
__device__ __forceinline__ bool xchunk(const float* box, const SlabRay& s,
                                       float best_t, bool same, bool lo_ok) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(box));
  const float4 b = __ldg(reinterpret_cast<const float4*>(box + 4));
  const float4 c = __ldg(reinterpret_cast<const float4*>(box + 8));
  const float bmax = __ldg(box + XB_BMAX);
  const float tx0 = (a.x - s.lx) * s.ix, tx1 = (a.w - s.hx) * s.ix;
  const float ty0 = (a.y - s.ly) * s.iy, ty1 = (b.x - s.hy) * s.iy;
  const float tz0 = (a.z - s.lz) * s.iz, tz1 = (b.y - s.hz) * s.iz;
  const float nx = nmin(tx0, tx1), fx = nmax(tx0, tx1);
  const float ny = nmin(ty0, ty1), fy = nmax(ty0, ty1);
  const float nz = nmin(tz0, tz1), fz = nmax(tz0, tz1);
  // scale ranges: a.xyz in b.z b.w c.x, b.xyz in c.y c.z c.w
  const float en = nmax(nmax(nmin(nx * b.z, nx * c.y),
                             nmin(ny * b.w, ny * c.z)),
                        nmin(nz * c.x, nz * c.w));
  const float ex = nmin(nmin(nmax(fx * b.z, fx * c.y),
                             nmax(fy * b.w, fy * c.z)),
                        nmax(fz * c.x, fz * c.w));
  const float bt = best_t * bmax;
  return !((ex < en) || (lo_ok && ex < 0.f) ||
           (en >= 0.f && (en > bt || (en == bt && !same))));
}

// Class CLS's rows one ray per thread: below XFORM_CULL_MIN rows (no
// chunks) in table order; else the chunks in the class's Morton order, a
// chunk's rows tested when its box test holds.
template <int CLS, bool COUNT>
__device__ __forceinline__ void xform_class(const Params& P, const Ray& r,
                                            const SlabRay& sr, float inv_raw,
                                            ScaleMemo& mm, Hit& h, XHit& xh,
                                            unsigned long long& rows,
                                            Counts& cnt) {
  const int n = CLS == 1 ? P.n_rects : CLS == 2 ? P.n_tsph : P.n_ttri;
  const int nc = P.n_xchunks[CLS - 1];
  if (nc == 0) {
    for (int k = 0; k < n; ++k) xform_row<CLS>(P, r, inv_raw, k, mm, h, xh);
    if (COUNT) rows += n;
    return;
  }
  const bool lo_ok =
      P.t_min >= 0.f && (CLS != 3 || !(P.flags & NO_T_CLIP));
  const float* box = P.xbox[CLS - 1];
  const int* ord = P.xord[CLS - 1];
  for (int j = 0; j < nc; ++j) {
    if (COUNT) ++cnt.xbox;
    if (!xchunk(box + (size_t)j * XBOX_COLS, sr, h.t, xh.cls == CLS, lo_ok))
      continue;
    const int base = j * XFORM_CHUNK;
    const int m = min(XFORM_CHUNK, n - base);
    for (int k = 0; k < m; ++k)
      xform_row<CLS>(P, r, inv_raw, __ldg(ord + base + k), mm, h, xh);
    if (COUNT) rows += m;
  }
}

// The rect, TRS-sphere and TRS-triangle rows after the sphere and triangle
// sweeps, class by class.
template <bool COUNT>
__device__ void xform_hit(const Params& P, const Ray& r, float inv_raw,
                          Hit& h, XHit& xh, Counts& cnt) {
  const SlabRay sr = slab_ray(r, XFORM_MARGIN);
  ScaleMemo mm = scale_memo();
  xform_class<1, COUNT>(P, r, sr, inv_raw, mm, h, xh, cnt.rect, cnt);
  xform_class<2, COUNT>(P, r, sr, inv_raw, mm, h, xh, cnt.tsph, cnt);
  xform_class<3, COUNT>(P, r, sr, inv_raw, mm, h, xh, cnt.ttri, cnt);
}

// K8 with the warp's lanes together (mega_path): each lane makes its own
// ray's chunk tests; for a chunk that some lane's ray reached, the lanes
// split its (ray, row) tests, XFORM_CHUNK rows x 32 / XFORM_CHUNK rays a
// pass (lane l tests row l % XFORM_CHUNK), each ray's least (t, row) coming
// back through the warp's atomicMin key (K6's tri_chunk_coop), and each
// lane takes its ray's by the rule (t, class, row) before its next chunk
// test.  A chunk that more than COOP_LANE_RAYS rays reached is tested one
// ray per lane.  A lane tests rows for other lanes' rays, so ScaleRay is
// not memoized in the split.  The tests, their arithmetic and every
// decision are the per-thread walk's.  Every lane of the warp enters (in:
// the lane has a path).
__device__ __forceinline__ void xform_store(const Ray& r, float inv_raw) {
  CoopSlot& sl = coop_slot();
  const int lane = threadIdx.x & 31;
  const float v[7] = {r.dx, r.dy, r.dz, r.ox, r.oy, r.oz, inv_raw};
  for (int k = 0; k < 7; ++k) sl.ph[k][lane] = v[k];
  sl.key[lane] = NO_KEY;
  __syncwarp();
}

template <int CLS, bool COUNT>
__device__ __forceinline__ void xform_chunk_coop(
    const Params& P, const Ray& r, const SlabRay& sr, float inv_raw,
    bool in, bool lo_ok, int j, ScaleMemo& mm, Hit& h, XHit& xh,
    unsigned long long& rows, Counts& cnt) {
  constexpr int RAYS = 32 / XFORM_CHUNK;   // rays a pass
  const int n = CLS == 1 ? P.n_rects : CLS == 2 ? P.n_tsph : P.n_ttri;
  const int* ord = P.xord[CLS - 1];
  CoopSlot& sl = coop_slot();
  const int lane = threadIdx.x & 31;
  if (COUNT && in) ++cnt.xbox;
  const bool at = in && xchunk(P.xbox[CLS - 1] + (size_t)j * XBOX_COLS, sr,
                               h.t, xh.cls == CLS, lo_ok);
  const unsigned mask = __ballot_sync(FULL, at);
  if (!mask) return;
  const int base = j * XFORM_CHUNK;
  const int m = min(XFORM_CHUNK, n - base);
  if (COUNT && at) rows += m;
  if (__popc(mask) > COOP_LANE_RAYS) {
    if (at)
      for (int k = 0; k < m; ++k)
        xform_row<CLS>(P, r, inv_raw, __ldg(ord + base + k), mm, h, xh);
    return;
  }
  const int kk = lane % XFORM_CHUNK;
  const int row = kk < m ? __ldg(ord + base + kk) : -1;
  const float* rp = xrow<CLS>(P, row < 0 ? 0 : row);
  for (unsigned rest = mask; rest;) {
    int src = -1;
    for (int s = 0; s < RAYS; ++s) {
      const int b = rest ? __ffs(rest) - 1 : -1;
      if (rest) rest &= rest - 1;
      if (s == lane / XFORM_CHUNK) src = b;
    }
    if (src < 0 || row < 0) continue;
    const Ray q{sl.ph[3][src], sl.ph[4][src], sl.ph[5][src],
                sl.ph[0][src], sl.ph[1][src], sl.ph[2][src]};
    ScaleMemo fresh = scale_memo();
    scale_dir(rp, q, fresh);
    const Ray x = trs_ray(rp, q, fresh);
    float tn;
    bool ok;
    if constexpr (CLS == 1) ok = rect_test(P, rp, x, tn);
    else if constexpr (CLS == 2) ok = tsph_test(P, rp, x, tn);
    else ok = ttri_test(P, rp, x, tn);
    const float t = tn * sl.ph[6][src];
    if (ok && t == t) atomicMin(&sl.key[src], hit_key(t, row));
  }
  __syncwarp();
  const unsigned long long k = sl.key[lane];
  if (at && k != NO_KEY) {
    const float t = key_t(k);
    const int rw = key_row(k);
    if (t < h.t || (t == h.t && xh.cls == CLS && rw < xh.idx)) {
      h.t = t;
      xh = XHit{CLS, rw};
    }
    sl.key[lane] = NO_KEY;
  }
  __syncwarp();
}

// Class CLS's rows with the warp together (xform_chunk_coop), or below
// XFORM_CULL_MIN rows one ray per thread in table order.
template <int CLS, bool COUNT>
__device__ __forceinline__ void xform_class_coop(
    const Params& P, const Ray& r, const SlabRay& sr, float inv_raw,
    bool in, ScaleMemo& mm, Hit& h, XHit& xh, unsigned long long& rows,
    Counts& cnt) {
  const int nc = P.n_xchunks[CLS - 1];
  if (nc == 0) {
    if (in) xform_class<CLS, COUNT>(P, r, sr, inv_raw, mm, h, xh, rows, cnt);
    return;
  }
  const bool lo_ok =
      P.t_min >= 0.f && (CLS != 3 || !(P.flags & NO_T_CLIP));
  for (int j = 0; j < nc; ++j)
    xform_chunk_coop<CLS, COUNT>(P, r, sr, inv_raw, in, lo_ok, j, mm, h, xh,
                                 rows, cnt);
}

template <bool COUNT>
__device__ void xform_hit_coop(const Params& P, const Ray& r, float inv_raw,
                               bool in, Hit& h, XHit& xh, Counts& cnt) {
  const SlabRay sr = slab_ray(r, XFORM_MARGIN);
  ScaleMemo mm = scale_memo();
  xform_store(r, inv_raw);
  xform_class_coop<1, COUNT>(P, r, sr, inv_raw, in, mm, h, xh, cnt.rect,
                             cnt);
  xform_class_coop<2, COUNT>(P, r, sr, inv_raw, in, mm, h, xh, cnt.tsph,
                             cnt);
  xform_class_coop<3, COUNT>(P, r, sr, inv_raw, in, mm, h, xh, cnt.ttri,
                             cnt);
}

// get_sphere_uv (texture.h:45-50) of a unit normal, as the plain version
// computes it: theta = asin(z) clamped (the poles +-pi/2; a NaN z gives 0).
__device__ __forceinline__ void sphere_uv(const float n[3], float uv[2]) {
  const float z = n[2] > 1.f ? 1.f : (n[2] < -1.f ? -1.f : n[2]);
  const float theta = fabsf(z) < 1.f ? asinf(z)
                    : (z > 0.f ? HALF_PI : (z < 0.f ? -HALF_PI : 0.f));
  const float phi = atan2f(n[2], n[0]);
  uv[0] = 1.f - (phi + PI_F) * INV_TWO_PI;
  uv[1] = (theta + HALF_PI) * INV_PI;
}

// The rect / TRS winner's record: object-space point, rotated normal,
// material block (recomputed with the sweep's arithmetic); with TEX and an
// image material its (u, v).
template <bool TEX>
__device__ void load_xwinner(const Params& P, const Ray& r, const XHit& xh,
                             float p[3], float n[3], float m[9],
                             float uv[2]) {
  const float* row = xh.cls == 1 ? P.rect + (size_t)xh.idx * RECT_COLS
                   : xh.cls == 2 ? P.tsph + (size_t)xh.idx * TSPH_COLS
                                 : P.ttri + (size_t)xh.idx * TTRI_COLS;
  ScaleMemo mm = scale_memo();
  scale_dir(row, r, mm);
  const Ray x = trs_ray(row, r, mm);
  float tn;
  if (xh.cls == 1) rect_test(P, row, x, tn);
  else if (xh.cls == 2) tsph_test(P, row, x, tn);
  else ttri_test(P, row, x, tn, TEX ? uv : nullptr);
  p[0] = x.ox + tn * x.dx;
  p[1] = x.oy + tn * x.dy;
  p[2] = x.oz + tn * x.dz;
  if (xh.cls == 2) {
    const float inv_r = __ldg(row + TSPH_INVR);
    const float nx = p[0] * inv_r, ny = p[1] * inv_r, nz = p[2] * inv_r;
    const float* mr = row + X_ROT;
    n[0] = __ldg(mr) * nx + __ldg(mr + 1) * ny + __ldg(mr + 2) * nz;
    n[1] = __ldg(mr + 3) * nx + __ldg(mr + 4) * ny + __ldg(mr + 5) * nz;
    n[2] = __ldg(mr + 6) * nx + __ldg(mr + 7) * ny + __ldg(mr + 8) * nz;
  } else {
    const int k0 = xh.cls == 1 ? RECT_NRM : TTRI_NW;
    for (int k = 0; k < 3; ++k) n[k] = __ldg(row + k0 + k);
  }
  for (int k = 0; k < 9; ++k) m[k] = __ldg(row + X_MAT + k);
  if constexpr (TEX) {
    if (m[1] == TEX_IMAGE) {
      if (xh.cls == 1) {
        uv[0] = p[0] + 0.5f;
        uv[1] = p[1] + 0.5f;
      } else if (xh.cls == 2) {
        sphere_uv(n, uv);
      }
    }
  }
}

// Moller-Trumbore (u, v) of a triangle winner, recomputed from its row with
// tri_chunk's arithmetic.
__device__ __forceinline__ void tri_uv(const Params& P, int idx, const Ray& r,
                                       float uv[2]) {
  const float* row = P.tri + (size_t)idx * TRI_COLS;
  const float4 r0 = __ldg(reinterpret_cast<const float4*>(row));
  const float4 r1 = __ldg(reinterpret_cast<const float4*>(row + 4));
  const float4 r2 = __ldg(reinterpret_cast<const float4*>(row + 8));
  const float e1x = r0.w, e1y = r1.x, e1z = r1.y;
  const float e2x = r1.z, e2y = r1.w, e2z = r2.x;
  const float hx = r.dy * e2z - r.dz * e2y;
  const float hy = r.dz * e2x - r.dx * e2z;
  const float hz = r.dx * e2y - r.dy * e2x;
  const float a = e1x * hx + e1y * hy + e1z * hz;
  const float f = 1.f / a;
  const float sx = r.ox - r0.x, sy = r.oy - r0.y, sz = r.oz - r0.z;
  uv[0] = f * (sx * hx + sy * hy + sz * hz);
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  uv[1] = f * (r.dx * qx + r.dy * qy + r.dz * qz);
}

// The winner's id in the scene's prim id space [spheres | triangles |
// rects | t_spheres | t_triangles] (megakernel.py:2778).  A sphere or
// triangle row carries its scene id in a pad column (S_ID, T_ID), on the
// cache line the winner's normal and material come from; rect / TRS rows
// are in scene order.
__device__ __forceinline__ int scene_id(const Params& P, const Hit& h,
                                        const XHit& xh) {
  const int base = P.n_spheres + P.n_triangles;
  if (xh.cls == 1) return base + xh.idx;
  if (xh.cls == 2) return base + P.n_rects + xh.idx;
  if (xh.cls == 3) return base + P.n_rects + P.n_tsph + xh.idx;
  return h.tri
      ? P.n_spheres + (int)__ldg(P.tri + (size_t)h.idx * TRI_COLS + T_ID)
      : (int)__ldg(P.sph + (size_t)h.idx * SPH_COLS + S_ID);
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

// The nearest texel of an image material's block at (u, v)
// (texture.h:65-76).  fmaxf drops a NaN, so a NaN coordinate lands on 0.
__device__ __forceinline__ void texel(const Params& P, const float m[9],
                                      float u, float v, float out[3]) {
  const float w = m[M_W], h = m[M_H];
  const int i = (int)fminf(fmaxf(u * w, 0.f), w - 1.f);
  const int j = (int)fminf(fmaxf((1.f - v) * h - 0.001f, 0.f), h - 1.f);
  const uint8_t* px =
      P.images + (((size_t)(int)m[M_IMG] * P.img_h + j) * P.img_w + i) * 3;
  for (int k = 0; k < 3; ++k)
    out[k] = __fdiv_rn((float)__ldg(px + k), 255.f);
}

// mat_decode with image textures (K9).  The path integrator never uses a
// light's attenuation, so it fetches only the texel each term needs.
template <int INTEG>
__device__ __forceinline__ void mat_decode_tex(const Params& P,
                                               const float m[9],
                                               const float p[3],
                                               const float uv[2],
                                               float att[3], float em[3]) {
  const bool lam = m[0] == K_LAMBERTIAN, light = m[0] == K_LIGHT;
  if (m[1] != TEX_IMAGE || !(lam || light)) {
    mat_decode(m, p[0], p[1], p[2], att, em);
    return;
  }
  const bool zero_uv = P.flags & LAMBERT_ZERO_UV;
  float real[3] = {0.f, 0.f, 0.f};
  if (light || !zero_uv) texel(P, m, uv[0], uv[1], real);
  if (lam || INTEG == LAMBERT) {
    if (zero_uv) texel(P, m, 0.f, 0.f, att);
    else for (int k = 0; k < 3; ++k) att[k] = real[k];
  } else {
    for (int k = 0; k < 3; ++k) att[k] = 0.f;   // a light ends the path
  }
  for (int k = 0; k < 3; ++k) em[k] = light ? real[k] : 0.f;
}

// Philox4x32-10 (Salmon et al., SC'11).  The round keys are bumped here,
// in the thread (K2 11% faster so on an H100 than with the ten round keys
// computed once on the host and read from the constant bank, PERF.md).
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
// sincosf gives sinf's and cosf's bits with one range reduction (the plain
// version's torch.sin and torch.cos on the card, bit for bit over
// chip_smoke.py's 2^22 draws; K2 9% faster on an H100).
__device__ __forceinline__ float4 draw(unsigned long long seed,
                                       uint32_t index, uint32_t step) {
  const uint32_t k0 = (uint32_t)seed, k1 = (uint32_t)(seed >> 32);
  const uint4 a = philox(make_uint4(index, step, 0u, 0u), k0, k1);
  const uint4 b = philox(make_uint4(index, step, 1u, 0u), k0, k1);
  const float r1 = sqrtf(-2.f * logf(fmaxf(u24(a.x), 1e-12f)));
  float s1, c1;
  sincosf(TWO_PI * u24(a.y), &s1, &c1);
  const float g0 = r1 * c1;
  const float g1 = r1 * s1;
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

// The warp's counts into P.counts and P.work; every lane of the warp.
__device__ __forceinline__ void add_counts(const Params& P, Counts c) {
  unsigned long long v[N_COUNTS + N_WORK] = {
      c.box, c.sph, c.tri, c.rect, c.tsph, c.ttri, c.seg, c.dist, c.xbox,
      c.bounce, c.warp_step, c.draw};
  for (int k = 0; k < N_COUNTS + N_WORK; ++k) {
    for (int off = 16; off > 0; off >>= 1)
      v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
    if ((threadIdx.x & 31) == 0)
      atomicAdd(k < N_COUNTS ? P.counts + k : P.work + (k - N_COUNTS), v[k]);
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

// The closest hit and the winner's point, normal and material.  K1's form
// (XFORM false) is the code of the main path; XFORM adds K8.
template <bool COUNT, bool XFORM, bool SHELLS, bool MXU, bool COOP>
__device__ __forceinline__ Hit trace_hit(const Params& P, const Ray& r,
                                         float inv_dlen, XHit& xh,
                                         Counts& cnt, bool in) {
  Hit h = closest_hit<COUNT, SHELLS, MXU, COOP>(P, r, cnt, in);
  if constexpr (XFORM) {
    xh = XHit{0, 0};
    if (!COOP || in) xform_hit<COUNT>(P, r, inv_dlen, h, xh, cnt);
  }
  return h;
}

// The winner's point, normal and material block; with TEX and an image
// material also its (u, v).
template <bool XFORM, bool TEX>
__device__ __forceinline__ void surface(const Params& P, const Ray& r,
                                        const Hit& h, const XHit& xh,
                                        float p[3], float n[3], float m[9],
                                        float uv[2]) {
  if constexpr (XFORM) {
    if (xh.cls) {
      load_xwinner<TEX>(P, r, xh, p, n, m, uv);
      return;
    }
  }
  p[0] = r.ox + h.t * r.dx;
  p[1] = r.oy + h.t * r.dy;
  p[2] = r.oz + h.t * r.dz;
  load_winner(P, h, p[0], p[1], p[2], n, m);
  if constexpr (TEX) {
    if (m[1] == TEX_IMAGE) {
      if (h.tri) tri_uv(P, h.idx, r, uv);
      else sphere_uv(n, uv);
    }
  }
}

// The winner's attenuation and emission.
template <int INTEG, bool TEX>
__device__ __forceinline__ void decode(const Params& P, const float m[9],
                                       const float p[3], const float uv[2],
                                       float att[3], float em[3]) {
  if constexpr (TEX) mat_decode_tex<INTEG>(P, m, p, uv, att, em);
  else mat_decode(m, p[0], p[1], p[2], att, em);
}


// One bounce of the path integrator after its closest hit h (render.h:
// 48-67: emitted + attenuation * recursion, ambient on absorb, sky on
// miss): the sky or the winner's emission into res, the winner's id (K7),
// and the scattered ray into r, its attenuation into thr.
// COUNT adds the bounce, and the draw if the kernel makes one.
enum BounceEnd { MISSED = 0, ENDED = 1, GOES_ON = 2 };
template <bool COUNT, int INTEG, bool XFORM, bool WINNERS, bool TEX>
__device__ __forceinline__ int bounce(const Params& P, Ray& r, const Hit& h,
                                      const XHit& xh, float inv_dlen,
                                      float thr[3], float res[3], int step,
                                      uint32_t rid, int i, Counts& cnt) {
  if (COUNT) ++cnt.bounce;
  if (!(h.t < BIG_CUT)) {
    float s[3];
    sky(r.dy, inv_dlen, s);
    for (int k = 0; k < 3; ++k) res[k] += thr[k] * s[k];
    return MISSED;
  }
  float p[3], n[3], m[9], att[3], em[3], dir[3], uv[2];
  surface<XFORM, TEX>(P, r, h, xh, p, n, m, uv);
  if constexpr (WINNERS)
    P.winners[(size_t)step * P.n + i] = scene_id(P, h, xh);
  decode<INTEG, TEX>(P, m, p, uv, att, em);
  bool cont = false;
  if (step < P.max_depth && m[0] != K_LIGHT) {   // render.h:57
    if (COUNT && !(P.flags & INJECTED)) ++cnt.draw;
    const float4 s = (P.flags & INJECTED)
        ? __ldg(reinterpret_cast<const float4*>(
              P.stream + ((size_t)step * P.n + rid) * 4))
        : draw(P.seed, rid, (uint32_t)step);
    cont = scatter(P, r, n, m, inv_dlen, s, dir);
  }
  const float amb = cont ? 0.f : P.ambient;
  for (int k = 0; k < 3; ++k) res[k] += thr[k] * (em[k] + amb);
  if (!cont) return ENDED;
  for (int k = 0; k < 3; ++k) thr[k] *= att[k];
  r = Ray{p[0], p[1], p[2], dir[0], dir[1], dir[2]};
  return GOES_ON;
}

// K10: a coordinate's cell of 1024 over the scene's bounds, as the plain
// version quantizes it (fmaxf / fminf drop a NaN to the lower edge), and its
// 10 bits spread three apart.
__device__ __forceinline__ uint32_t key_cell(float a, float lo, float span) {
  const float q = __fdiv_rn(a - lo, span) * 1023.f;
  return (uint32_t)fminf(fmaxf(q, 0.f), 1023.f);
}

__device__ __forceinline__ uint32_t spread10(uint32_t v) {
  v = (v | (v << 16)) & 0x030000FFu;
  v = (v | (v << 8)) & 0x0300F00Fu;
  v = (v | (v << 4)) & 0x030C30C3u;
  return (v | (v << 2)) & 0x09249249u;
}

// K10: the ray's key for the next window's order (ops/megakernel.py
// regroup_keys): a dead ray last; alive rays first, or by the Morton code of
// their origin, or by (coarse origin cell, direction octant, fine origin
// Morton).
__device__ __forceinline__ int regroup_key(const Params& P, const Ray& r,
                                           bool alive) {
  if (!alive) return DEAD_KEY;
  if (P.key_mode == KEY_ALIVE) return 0;
  const float* b = P.bounds;
  const uint32_t code =
      (spread10(key_cell(r.ox, __ldg(b), __ldg(b + 3))) << 2)
      | (spread10(key_cell(r.oy, __ldg(b + 1), __ldg(b + 4))) << 1)
      | spread10(key_cell(r.oz, __ldg(b + 2), __ldg(b + 5)));
  if (P.key_mode == KEY_MORTON) return (int)code;
  const uint32_t oct = ((r.dx < 0.f ? 1u : 0u) << 2)
                     | ((r.dy < 0.f ? 1u : 0u) << 1) | (r.dz < 0.f ? 1u : 0u);
  return (int)(((code >> OCT_SHIFT) << OCT_SHIFT) | (oct << (OCT_SHIFT - 3))
               | ((code >> 3) & ((1u << (OCT_SHIFT - 3)) - 1u)));
}

// The grid kernel, one thread per ray: the lambert and normal integrators
// (one intersection each) and, under COOP, the path integrator of the
// cooperative sweeps (K6, K11, K12), for which all 32 lanes of a warp run
// the bounce loop together until the warp's last path ends, the lanes whose
// path ended (or that lie past n) taking part with no ray.  The path
// integrator one thread per ray runs in mega_path.
template <int INTEG, bool COUNT, bool XFORM, bool WINNERS, bool TEX,
          bool SHELLS, bool MXU, bool COOP>
__global__ void __launch_bounds__(BLOCK) mega_kernel(Params P) {
  static_assert(INTEG != PATH || COOP, "the per-thread path is mega_path");
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  Counts cnt{};
  const bool in = i < P.n;
  // the ray this thread serves: its camera ray, the key of its draws, its
  // row of the injected stream and its column of the planes (K10)
  const int rid = !in ? 0 : P.order ? __ldg(P.order + i) : i;
  // a window after step 0 resumes the rays from the planes (K10)
  const bool resume = P.planes && P.step_lo > 0;
  if (COOP || in) {
    Ray r{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (in && !resume)
      r = Ray{P.o[3 * (size_t)rid], P.o[3 * (size_t)rid + 1],
              P.o[3 * (size_t)rid + 2], P.d[3 * (size_t)rid],
              P.d[3 * (size_t)rid + 1], P.d[3 * (size_t)rid + 2]};
    float res[3];
    XHit xh{0, 0};
    if constexpr (INTEG == PATH) {
      // Step i is recursion depth max_depth - i.  The window (K10) runs
      // global steps [step_lo, step_lo + n_steps).
      float thr[3] = {1.f, 1.f, 1.f};
      bool alive = in;
      const size_t pn = P.n;              // the planes' stride
      if (resume && in) {
        const float* col = P.planes + rid;
        alive = col[PL_ALIVE * pn] > 0.f;     // a dead ray's only load
        if (alive) {
          r = Ray{col[PL_O * pn], col[(PL_O + 1) * pn],
                  col[(PL_O + 2) * pn], col[PL_D * pn],
                  col[(PL_D + 1) * pn], col[(PL_D + 2) * pn]};
          for (int k = 0; k < 3; ++k) thr[k] = col[(PL_THR + k) * pn];
        }
      }
      const bool started = alive;
      res[0] = res[1] = res[2] = 0.f;
      const int step_hi = P.step_lo + P.n_steps;
      int step = P.step_lo;
      for (;;) {
        const bool act = alive && step < step_hi;
        if (!__any_sync(FULL, act)) break;
        if (COUNT && (threadIdx.x & 31) == 0) ++cnt.warp_step;
        const float inv_dlen =
            1.f / sqrtf(r.dx * r.dx + r.dy * r.dy + r.dz * r.dz);
        const Hit h = trace_hit<COUNT, XFORM, SHELLS, MXU, COOP>(
            P, r, inv_dlen, xh, cnt, act);
        if (!act) continue;
        const int e = bounce<COUNT, INTEG, XFORM, WINNERS, TEX>(
            P, r, h, xh, inv_dlen, thr, res, step, (uint32_t)rid, i, cnt);
        if (e == GOES_ON) {
          ++step;
        } else {
          step += e;          // a miss leaves step at the miss
          alive = false;
        }
      }
      if constexpr (WINNERS) {
        // the miss (step left where it broke) and every bounce after the end
        if (in)
          for (; step <= P.max_depth; ++step)
            P.winners[(size_t)step * P.n + i] = -1;
      }
      if (P.planes && started) {        // [rad | o | d | thr | alive]
        float* col = P.planes + rid;
        for (int k = 0; k < 3; ++k)
          col[k * pn] = resume ? col[k * pn] + res[k] : res[k];
        const float v[N_PLANES - 3] = {r.ox, r.oy, r.oz, r.dx, r.dy, r.dz,
                                       thr[0], thr[1], thr[2],
                                       alive ? 1.f : 0.f};
        for (int k = 0; k < N_PLANES - 3; ++k) col[(PL_O + k) * pn] = v[k];
        if (P.key) P.key[rid] = regroup_key(P, r, alive);
      }
    } else {
      // LambertShade (render.h:70-87) and shade_normal (render.h:90-103):
      // one intersection.
      const float inv_dlen =
          1.f / sqrtf(r.dx * r.dx + r.dy * r.dy + r.dz * r.dz);
      const Hit h = trace_hit<COUNT, XFORM, SHELLS, MXU, COOP>(
          P, r, inv_dlen, xh, cnt, in);
      const bool hit = h.t < BIG_CUT;
      float s[3];
      sky(r.dy, inv_dlen, s);
      if (!hit) {
        res[0] = s[0]; res[1] = s[1]; res[2] = s[2];
      } else {
        float p[3], n[3], m[9], uv[2];
        surface<XFORM, TEX>(P, r, h, xh, p, n, m, uv);
        if (INTEG == NORMAL) {
          res[0] = n[0]; res[1] = n[1]; res[2] = n[2];
        } else {
          float att[3], em[3];
          decode<INTEG, TEX>(P, m, p, uv, att, em);
          const float scale = (P.flags & LAMBERT_UNNORM) ? 1.f : inv_dlen;
          const float tq =
              fmaxf((r.dx * n[0] + r.dy * n[1] + r.dz * n[2]) * scale, 0.f);
          for (int k = 0; k < 3; ++k)
            res[k] = att[k] * tq * s[k] * 0.2f + em[k];
        }
      }
    }
    if (!P.planes && in) {
      P.out[3 * (size_t)i] = res[0];
      P.out[3 * (size_t)i + 1] = res[1];
      P.out[3 * (size_t)i + 2] = res[2];
    }
  }
  if (COUNT) add_counts(P, cnt);
}

// ---------------------------------------------------------------------------
// mega_path: the path integrator one thread per ray (K1, and K7, K8, K9 and
// the per-thread sweeps of K6, K11 and K12 on the same loop) on persistent
// warps that refill finished lanes.
// ---------------------------------------------------------------------------

// A warp takes new ray indices when at least this many of its lanes are idle
// (chosen by measurement on an H100, PERF.md; not a knob).
constexpr int REFILL_IDLE = 16;
// mega_path's resident blocks of BLOCK threads an SM, its launch bound: up
// to 64 registers a thread, where ptxas's own choice was 48 registers and
// 106 B of spill for K1's instance, slower on the triangle frames (PERF.md).
// The K8 instances spill at this bound; 6 blocks an SM (75 registers, no
// spill) was measured slower on (i) and left out (PERF.md).
constexpr int PATH_BLOCKS_PER_SM = 8;

// A lane's path: its ray, throughput, radiance so far and global step, the
// index i it took from the counter and the ray id rid it serves.
struct Path {
  Ray r;
  float thr[3], res[3];
  int step, i, rid;
};

// Lane takes index i: the ray it serves (WINDOW: order[i]), from its camera
// ray, or (a window after step 0) from the planes.  False for a dead ray,
// whose column is left as it is.
template <bool WINDOW>
__device__ __forceinline__ bool start_path(const Params& P, int i, Path& q) {
  q.i = q.rid = i;
  q.step = 0;
  for (int k = 0; k < 3; ++k) { q.thr[k] = 1.f; q.res[k] = 0.f; }
  if constexpr (WINDOW) {
    if (P.order) q.rid = __ldg(P.order + i);
    q.step = P.step_lo;
    if (P.planes && P.step_lo > 0) {
      const size_t pn = P.n;
      const float* col = P.planes + q.rid;
      if (!(col[PL_ALIVE * pn] > 0.f)) return false;
      q.r = Ray{col[PL_O * pn], col[(PL_O + 1) * pn], col[(PL_O + 2) * pn],
                col[PL_D * pn], col[(PL_D + 1) * pn], col[(PL_D + 2) * pn]};
      for (int k = 0; k < 3; ++k) q.thr[k] = col[(PL_THR + k) * pn];
      return true;
    }
  }
  const size_t o = 3 * (size_t)q.rid;
  q.r = Ray{P.o[o], P.o[o + 1], P.o[o + 2], P.d[o], P.d[o + 1], P.d[o + 2]};
  return true;
}

// The path ended (alive: it is still alive at the window's end): the -1
// winners of the miss and of every bounce after the end (K7), then its
// radiance at row i, or (K10) its column of the planes and its key.
template <bool WINNERS, bool WINDOW>
__device__ __forceinline__ void end_path(const Params& P, const Path& q,
                                         bool alive) {
  if constexpr (WINNERS)
    for (int step = q.step; step <= P.max_depth; ++step)
      P.winners[(size_t)step * P.n + q.i] = -1;
  if constexpr (WINDOW) {
    if (P.planes) {                         // [rad | o | d | thr | alive]
      const size_t pn = P.n;
      float* col = P.planes + q.rid;
      for (int k = 0; k < 3; ++k)
        col[k * pn] = P.step_lo > 0 ? col[k * pn] + q.res[k] : q.res[k];
      const float v[N_PLANES - 3] = {q.r.ox, q.r.oy, q.r.oz, q.r.dx, q.r.dy,
                                     q.r.dz, q.thr[0], q.thr[1], q.thr[2],
                                     alive ? 1.f : 0.f};
      for (int k = 0; k < N_PLANES - 3; ++k) col[(PL_O + k) * pn] = v[k];
      if (P.key) P.key[q.rid] = regroup_key(P, q.r, alive);
      return;
    }
  }
  for (int k = 0; k < 3; ++k) P.out[3 * (size_t)q.i + k] = q.res[k];
}

// The grid holds only the blocks that fit on the card at once.  Each warp
// loops: when at least REFILL_IDLE of its lanes are idle, one leader takes
// as many indices from P.next by one atomicAdd and the idle lanes rank
// themselves in it by __popc; then every lane with a path makes one bounce,
// and a lane whose path ends writes it and goes idle.  The warp leaves when
// the counter has passed n and its last path has ended.  WINDOW: the
// instances a bounce window (K10) can reach.
template <bool COUNT, bool XFORM, bool WINNERS, bool TEX, bool SHELLS,
          bool MXU, bool WINDOW>
__global__ void __launch_bounds__(BLOCK, PATH_BLOCKS_PER_SM)
    mega_path(Params P) {
  static_assert(!(WINDOW && WINNERS), "a window records no winners");
  const unsigned lane = threadIdx.x & 31;
  const int step_hi = WINDOW ? P.step_lo + P.n_steps : P.max_depth + 1;
  Counts cnt{};
  Path q{};
  bool has = false, more = true;
  for (;;) {
    if (more) {
      const unsigned idle = __ballot_sync(FULL, !has);
      const int k = __popc(idle);
      if (k >= REFILL_IDLE) {
        const int leader = __ffs(idle) - 1;
        int base = 0;
        if (lane == (unsigned)leader) base = atomicAdd(P.next, k);
        base = __shfl_sync(FULL, base, leader);
        more = base + k < P.n;
        if (!has) {
          const int i = base + __popc(idle & ((1u << lane) - 1u));
          has = i < P.n && start_path<WINDOW>(P, i, q);
        }
      }
    }
    if (!__any_sync(FULL, has)) {
      if (more) continue;
      break;
    }
    if (COUNT && lane == 0) ++cnt.warp_step;
    XHit xh{0, 0};
    Hit h{BIG, -1, false};
    const float inv_dlen =
        1.f / sqrtf(q.r.dx * q.r.dx + q.r.dy * q.r.dy + q.r.dz * q.r.dz);
    if (has)
      h = trace_hit<COUNT, false, SHELLS, MXU, false>(P, q.r, inv_dlen, xh,
                                                      cnt, true);
    if constexpr (XFORM) xform_hit_coop<COUNT>(P, q.r, inv_dlen, has, h, xh,
                                               cnt);
    if (has) {
      const int e = bounce<COUNT, PATH, XFORM, WINNERS, TEX>(
          P, q.r, h, xh, inv_dlen, q.thr, q.res, q.step, (uint32_t)q.rid,
          q.i, cnt);
      q.step += e == GOES_ON ? 1 : e;     // a miss leaves step at the miss
      if (e != GOES_ON || q.step == step_hi) {
        end_path<WINNERS, WINDOW>(P, q, e == GOES_ON);
        has = false;
      }
    }
  }
  if (COUNT) add_counts(P, cnt);
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

// One launch of an instance over P.n rays, a thread a ray.  The
// cooperative shells (K11) take their warps' shell bytes and bits as
// dynamic shared memory: 8.1 KB a block over 63 segments and 8 shells, 66
// KB over 512 (above 48 KB only after raising the instance's limit).
template <int INTEG, bool COUNT, bool XFORM, bool WINNERS, bool TEX,
          bool SHELLS, bool MXU, bool COOP>
void run(const Params& P, cudaStream_t s) {
  const dim3 grid((P.n + BLOCK - 1) / BLOCK);
  auto kernel = mega_kernel<INTEG, COUNT, XFORM, WINNERS, TEX, SHELLS, MXU,
                            COOP>;
  int smem = 0;
  if constexpr (SHELLS && COOP) {
    smem = WARPS * shell_warp_bytes(P.n_tri_segs, P.f2b);
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  kernel<<<grid, BLOCK, smem, s>>>(P);
}

// A mega_path instance and its resident blocks an SM, queried once an
// instance (the build targets sm_90a alone, whose SMs all hold the same
// registers and shared memory; 0 if the query failed).
struct PathInstance {
  void (*kernel)(Params);
  int per_sm;
};

template <bool COUNT, bool XFORM, bool WINNERS, bool TEX, bool SHELLS,
          bool MXU, bool WINDOW>
PathInstance path_instance() {
  auto kernel = mega_path<COUNT, XFORM, WINNERS, TEX, SHELLS, MXU, WINDOW>;
  static const int per_sm = [&] {
    int blocks = 0;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &blocks, kernel, BLOCK, 0) == cudaSuccess ? blocks : 0;
  }();
  return {kernel, per_sm};
}

// The blocks a launch of k over n rays takes on the current device: as many
// as its SMs hold at once, fewer for fewer rays.
inline int path_grid(const PathInstance& k, int n) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)std::min<long long>((long long)k.per_sm * sms,
                                  ((long long)n + BLOCK - 1) / BLOCK);
}

// One launch of a mega_path instance, after zeroing the counter on the
// launch's stream.  Its errors reach the caller by cudaGetLastError: a grid
// of 0 (the occupancy query failed) is an invalid configuration.  The
// counter passes n by at most 32 a warp, which _launch_mega keeps in int32.
inline void run_path(const PathInstance& k, const Params& P,
                     cudaStream_t s) {
  if (cudaMemsetAsync(P.next, 0, sizeof(int), s) != cudaSuccess) return;
  k.kernel<<<path_grid(k, P.n), BLOCK, 0, s>>>(P);
}

// Whether the launch runs a bounce window (K10).
inline bool is_window(const Params& P) {
  return P.planes || P.step_lo != 0 || P.n_steps != P.max_depth + 1;
}

// The path integrator one thread per ray: the counting instance (which any
// window reaches), the window instances (K10; never recording winners), and
// K1's production instances with K7's winners and K9's texels as the
// caller asks, which carry no window code.
template <bool XFORM, bool SHELLS>
PathInstance path_of(bool count, bool window, bool winners, bool tex) {
  constexpr bool F = false, T = true;
  if (count) return path_instance<T, XFORM, F, F, SHELLS, F, T>();
  if (window) {
    if (tex) return path_instance<F, XFORM, F, T, SHELLS, F, T>();
    return path_instance<F, XFORM, F, F, SHELLS, F, T>();
  }
  if (winners) {
    if (tex) return path_instance<F, XFORM, T, T, SHELLS, F, F>();
    return path_instance<F, XFORM, T, F, SHELLS, F, F>();
  }
  if (tex) return path_instance<F, XFORM, F, T, SHELLS, F, F>();
  return path_instance<F, XFORM, F, F, SHELLS, F, F>();
}

template <bool XFORM, bool SHELLS>
void launch_path(const Params& P, cudaStream_t s) {
  run_path(path_of<XFORM, SHELLS>(P.counts != nullptr, is_window(P),
                                  P.winners != nullptr, P.images != nullptr),
           P, s);
}

// The grid family's production instances: TEX when the caller passes the
// images (K9; the normal integrator reads no texture and has no TEX
// instance), WINNERS when it asks for winners (K7, path only).
template <int INTEG, bool XFORM, bool TEX, bool SHELLS, bool COOP>
void launch_production(const Params& P, cudaStream_t s) {
  if constexpr (INTEG == PATH) {
    if (P.winners)
      run<PATH, false, XFORM, true, TEX, SHELLS, false, COOP>(P, s);
    else
      run<PATH, false, XFORM, false, TEX, SHELLS, false, COOP>(P, s);
  } else {
    run<INTEG, false, XFORM, false, TEX, SHELLS, false, COOP>(P, s);
  }
}

template <int INTEG, bool XFORM, bool SHELLS, bool COOP>
void launch_mega(const Params& P, cudaStream_t s) {
  if constexpr (INTEG == PATH && !COOP) {
    launch_path<XFORM, SHELLS>(P, s);
  } else if (P.counts) {
    run<INTEG, true, XFORM, false, false, SHELLS, false, COOP>(P, s);
  } else if constexpr (INTEG != NORMAL) {
    if (P.images)
      launch_production<INTEG, XFORM, true, SHELLS, COOP>(P, s);
    else
      launch_production<INTEG, XFORM, false, SHELLS, COOP>(P, s);
  } else {
    launch_production<INTEG, XFORM, false, SHELLS, COOP>(P, s);
  }
}

// A family of instances: K8 and K11 pick the instance, so that the rect /
// TRS rows and the shell passes stay out of the main path's (K1) code.
// COOP: the cooperative family (the path integrator above 8,192 triangles);
// without it the triangle levels run one thread per ray (K1, K6 for the
// camera rays of the lambert and normal integrators, and the per-thread
// sweep that the cooperative one is held against).
template <int INTEG, bool COOP>
void launch_family(const Params& P, cudaStream_t s) {
  const bool xform = P.n_rects + P.n_tsph + P.n_ttri > 0;
  if (P.f2b > 0) {
    if (xform) launch_mega<INTEG, true, true, COOP>(P, s);
    else launch_mega<INTEG, false, true, COOP>(P, s);
  } else {
    if (xform) launch_mega<INTEG, true, false, COOP>(P, s);
    else launch_mega<INTEG, false, false, COOP>(P, s);
  }
}

// K12's instances: no winners, texels or shells; the cooperative sweep,
// and for counting also the one-thread-per-ray sweep (per_thread) that it
// is held against (the path integrator's on mega_path).
template <int INTEG, bool XFORM>
void launch_mxu_x(const Params& P, cudaStream_t s, bool per_thread) {
  if (P.counts && per_thread) {
    if constexpr (INTEG == PATH)
      run_path(path_instance<true, XFORM, false, false, false, true, true>(),
               P, s);
    else
      run<INTEG, true, XFORM, false, false, false, true, false>(P, s);
  } else if (P.counts) {
    run<INTEG, true, XFORM, false, false, false, true, true>(P, s);
  } else {
    run<INTEG, false, XFORM, false, false, false, true, true>(P, s);
  }
}

template <int INTEG>
void launch_mxu(const Params& P, cudaStream_t s, bool per_thread) {
  if (P.n_rects + P.n_tsph + P.n_ttri > 0)
    launch_mxu_x<INTEG, true>(P, s, per_thread);
  else
    launch_mxu_x<INTEG, false>(P, s, per_thread);
}

// The cooperative, K12 and per-thread path instances are compiled in
// translation units of their own (megakernel_coop.cu, megakernel_mxu.cu,
// megakernel_path.cu, megakernel_path_f2b.cu), in parallel with
// megakernel.cu's (ops/_cuda.py).
extern template void launch_family<PATH, true>(const Params&, cudaStream_t);
extern template void launch_mxu<PATH>(const Params&, cudaStream_t, bool);
extern template void launch_mxu<LAMBERT>(const Params&, cudaStream_t, bool);
extern template void launch_mxu<NORMAL>(const Params&, cudaStream_t, bool);
extern template void launch_path<false, false>(const Params&, cudaStream_t);
extern template void launch_path<true, false>(const Params&, cudaStream_t);
extern template void launch_path<false, true>(const Params&, cudaStream_t);
extern template void launch_path<true, true>(const Params&, cudaStream_t);
extern template PathInstance path_of<false, false>(bool, bool, bool, bool);
extern template PathInstance path_of<true, false>(bool, bool, bool, bool);
extern template PathInstance path_of<false, true>(bool, bool, bool, bool);
extern template PathInstance path_of<true, true>(bool, bool, bool, bool);

}  // namespace crt
