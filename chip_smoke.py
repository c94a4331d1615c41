#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card, and hold every
kernel of those paths against its plain PyTorch version.

    python3 chip_smoke.py

The paths: the fused render (engine='mega', kernel K1, its rect / TRS
mode K8 mega_trace_xform and its image texture mode K9 mega_trace_tex),
the wavefront render (engine='wavefront': the sweep kernels K3
sphere_sweep and K4 triangle_sweep, the draws kernel K2 scatter_draws), the
single-device fit through the wavefront (K5 sphere_sweep_attrs, K2) and
through engine='mega_diff' (K1 recording its winners, K7 mega_winners, and
the replay backward on K2 draws), the render of scenes above 8,192
prims of a type (the segment level K6 mega_stream, the bounce windows of
the compaction drivers K10 mega_window, the front-to-back shells K11
mega_f2b, the bilinear triangle sweep K12 mega_mxu under cfg.mega_mxu), and
the skinned-animation driver apps/animate.py (its mega pipeline on K1 and
K6, its pallas pipeline on K4, its bvh, bonebvh and fused pipelines on the
BVH traversal crt_bvh_traverse, csrc/bvh.cu, which replaces no pallas_call
but JAX's traverse_bvh loop) and the render CLI's --accel bvh, and the
parallel layer (cudaraytracer_tpu_torch/parallel/: ranks spawned on the
one card, the wavefront's K2-K5 per rank, K1 under mega, K7 and the replay
under mega_diff) with the wavefront's alive-first compaction.  A launch
counts once for each mode it runs (K6-K12), or as mega_trace when it runs
none.

Phases (each prints lines; any failure raises and exits nonzero):
  1. environment: the card's name and power limit;
  2. build: the CUDA sources under cudaraytracer_tpu_torch/csrc, one nvcc
     each, all started together, with the ptxas register and spill report;
  3. kernel against plain, every kernel built without FMA contraction, so
     every ray must match to PARITY_ATOL:
       * K1 mega_trace against trace_path_mega_plain: one full main-path
         launch of each fused frame (its first 2^18-ray chunk in swizzled
         order; three integrators on an injected stream, plus the path on
         in-kernel draws), four scenes at 128x64x4, a scene of duplicated
         prims and a scene of exact t ties.  The path launches of K1, K7,
         K8 and K9 (mega_path's persistent warps) are timed by device_ms
         (the card's time; ``call_ms`` times the call, the wrapper's host
         time included) and report their instance's registers (the
         runtime's, equal to ptxas's), spill (ptxas), the grid blocks the
         launch takes and, for K1 and K9, the lanes' use the counting
         instance measured (its bounces over 32 x its warp steps); a line
         of its own gives the model of the one-thread-per-ray schedule
         that mega_path replaced (its lanes' use from K7's winners on the
         same rays, and one block per 128 rays), which the kernels line
         leaves out; their bounds charge each in-kernel draw K2's
         instructions a draw by pipe, counted from this run's SASS
         (``draw_pipes``; ``bound_no_draws_ms`` without);
       * the sweeps K3, K5 (culled and plain) and K4 against their plain
         versions, through the public entries and every culled instance
         (one and two box levels, one thread per ray and cooperative; the
         cooperative counting instance must count the per-thread one's
         tests), on full main-path launches: the first 2^18 camera rays
         of random_spheres 16:9, the same rays after one bounce with the
         alive mask that bounce leaves and with that mask thinned (dead
         lanes must miss), the first and the middle 2^18 rays of the
         icosphere frame under both quirk profiles and the middle
         launch's bounced rays (K4 culled), 2^18 axis-parallel rays whose
         origins lie on the icosphere's chunk and super planes (the
         slab's NaN) and on its vertices' planes (the boxes' margin),
         2^18 rays at a triangle whose duplicate sits in
         another super, the 9,216-sphere field (the spheres' two levels),
         a scene of fewer than 128 triangles (K4 plain), and the
         duplicate-prim and exact-tie scenes; idx equal on every ray, t
         and attrs to PARITY_ATOL.  On a cylinder of 4,096 slivers under
         2^18 grazing rays (moderate and extreme, both quirk profiles)
         K4's culled instances agree bit for bit and leave the plain
         version only where its winner is outside the margin's proof
         (ops/sweeps.py TRI_MARGIN), counted in the kernels line's
         ``slivers``.  Each kernel's camera and bounce
         launches of (c), (d) and (e) are timed on the card over prebuilt
         tables and through the public entry (its table build included),
         beside the other cooperation choice, one box level (K4), the
         lanes' use and the instance's registers and spill; the bound is
         the one-level per-thread counting instance's (the same work
         whatever implements it), the launch's own count beside it;
       * K8 against the plain version on one full 2^18-ray launch of
         light_box 1280x720x16 and of the TRS showcase, and 2^16 rays of
         the TRS field (three integrators injected, the path on in-kernel
         draws), with equal winner ids (K7 on K8's scenes); the TRS
         field's first 2^18-ray launch timed, with the chunk tests and rows
         its counting instance made and the brute-force walk's bound
         beside its own; K8's culled walk on its edge rays (rect edges,
         TRS sphere tangents, TRS triangle vertices, axis-parallel rays)
         and camera rays, 2^14 each, on the TRS field and on a field whose
         rows each have a copy walked first (ties across chunks in reverse
         row order), both quirk profiles, three integrators and K7's
         winners (``phase_xform_edges``);
       * the boxes' margins (``phase_margins``): the fused kernels' first
         hit (K1's persistent warps, the cooperative K6, K11 with 8 shells,
         the lambert instances) against the plain version on 2^16 rays a
         set along the icosphere's and (m)'s box planes, grazing 4,096
         slivers, and tangent to the spheres of random_spheres and of the
         9,216-sphere field, and K3 on the tangent rays: no winner that
         the margins' proof covers lost, the rest counted;
       * K7 on (g)'s first 2^18-ray launch: winners equal to the plain
         version's, radiance equal to the launch that records nothing;
       * K9 on full 2^18-ray launches of (j) (its middle launch, both quirk
         profiles), (k) (its middle launch) and (l) (its first): every ray
         to PARITY_ATOL except rays whose texel flipped at an edge (at
         most max(2, n / 10^4), printed), winners equal (K7 on K9), the
         launch timed beside the same launch with the images swapped for
         constant textures, its bound with 3 bytes per texel fetched;
       * K6 on (m)'s first 2^18-ray launch (three integrators injected,
         the path on in-kernel draws with the winners of K7 on K6), on the
         9,216-sphere field's 2^18 rays and on 2^16 rays of (n) (lambert);
         K11: shells 8 against 0 on (m)'s launch, radiance and winners
         equal; K10: the window [0, 2) over the path state's planes,
         its planes and octant keys against the plain version's and its
         keys in each mode (alive first, Morton, octant) against the
         plain key function's on its planes, the window [2, 4) resumed in
         place against the plain version (timed in ray-id order, the
         PR-to-PR figure, and in the octant keys' order), the rest of the
         path completing the monolithic launch, and the compaction
         drivers (phased every 1, 2 and 3, a first window of 1, compact)
         bit-equal to the monolithic launch with no host sync (sync debug
         mode "error"); K6, K10 and K11 under the path integrator run the
         warp-cooperative sweep (lambert and normal keep one thread per
         ray), each also timed with the one-thread-per-ray sweep
         (per_thread), equal radiance required, on (m) the whole path,
         bounce 0 and bounces 1-8; on (m)'s launch the cooperative
         counting instance must count the per-thread one's tests and
         touched chunks;
       * K12 on (m)'s first 2^18-ray launch under mega_mxu (three
         integrators injected, the path on in-kernel draws, timed beside
         monolithic K6 on the same rays), on 2^16 rays of (n) (lambert) and
         on the terrain's 2^18 rays under the reference quirks (the d.n
         block, the no-t-clip window); the phased driver bit-equal to the
         monolithic launch under K12; K12's bounds charge the triangle
         tests the closest hit needs (K6's counting instance on the same
         rays, 96 bytes of coefficients each), and its own count of tests
         (tri_done) is printed beside them, both held against the
         per-thread counting instances on (m)'s launch;
       * the BVH (``phase_bvh``): the native builder's layout equal to
         the Python builder's on (b), its seconds on (m) and (n); the
         refit on the card equal to the CPU's on (b) and (m);
         crt_bvh_traverse against traverse_bvh_plain (ids equal, t max abs
         error 0) on 2^16 camera and 2^16 bounce rays of (b) and (m) and
         of skinned_field's bone forest, both quirk profiles, both shrink
         values; the forest's winners against brute force, counted; the
         absolute pad's (AABB_PAD) first-hit losses against brute force
         on node and triangle planes of the icosphere and the capsule and
         on grazing slivers, counted per profile (a departure of both
         packages, not a failure); the walk on the first 2^18 rays of (b)
         and (m) (and their middle launches) and (n) on the card, its plain
         version, its bound from its counted tests, beside K4 and, on (m)
         and (n), K6 (lambert) on the same rays;
  4. draws: the scatter_draws kernel K2 as a wavefront trace launches it,
     every bounce of a depth-8 trace of 2^18 rays in one launch, against
     its plain version and its one-bounce launches stacked, timed on the
     card and as the call, its bound from this run's SASS (the
     instructions a draw on the integer, FP32 and MUFU pipes,
     ``draw_pipes``); one bounce of 2^22 samples against the plain version
     and the unit-ball and uniform distributions; then the winner sum
     crt_winner_add (``phase_winner_add``) on each bounce's winners of a
     trace at the fit cell's 1280x720x4 (484 spheres, K5's K = 25 columns)
     against its plain version and the three index_add_ calls it
     replaced, timed beside both and its bound from bytes;
  5. cross-engine: the wavefront and the fused engine on the same 2^18 rays
     of each frame (random_spheres' first launch, the icosphere's middle
     one, light_box's and the TRS showcase's first) and the same injected
     stream (and (j)'s, (k)'s middle and (l)'s first launch); at most
     max(2, n/200) rays may differ by more than 1e-3; the fit's first-step
     gradients (64x32x2) card against CPU for the wavefront and for
     mega_diff (three_spheres, and textured_globe for mega_diff), and
     mega_diff against the wavefront on the card, each to 1e-3 of the
     largest entry;
  6. main paths at full size, the launch counts set to 0 just before each
     and read just after (the sweeps' also by kind: camera launches, and
     bounce launches, which carry an alive mask; a wavefront render must
     launch K2 once a trace, as often as its camera sweeps):
       (a) random_spheres 1920x1080x16, path depth 8, reference quirks,
           fused, Morton tables, in-kernel draws;
       (b) a 5,120-triangle icosphere 1280x720x8, depth 8, fixed quirks,
           fused;
       (c) (a) on the wavefront through sweep_intersector with K2 draws;
       (d) (b) on the wavefront;
       (e) the fit: three_spheres 512x256x4, depth 4, no gamma, the sweep
           pair with the attribute-carrying sphere sweep, SGD on albedo and
           centres at lr 0.5 on fixed rays and draws: a warm-up step, then
           5 timed steps; then one step on random_spheres (K5 over 484
           Morton-ordered spheres);
       (f) (e) through engine='mega_diff': the tables rebuilt from the
           params every step, the loss must fall over the 5 steps;
       (g) (a)'s frame through engine='mega_diff', without a gradient
           (K1) and with the centres requiring one (K7, recording);
       (h) light_box 1280x720x16, depth 8, reference quirks, fused (K8),
           then on the wavefront (K3, the rect folded in by tensor ops);
       (i) 1,100 each of rects, TRS spheres and TRS triangles (above the
           JAX engine's 1024-per-class cap), 640x360x4, depth 4, fixed
           quirks, fused (K8);
       (j) random_spheres with images, 1920x1080x16, depth 8, fixed
           quirks, fused (K9), plus one 2^18-ray launch under the
           reference quirks;
       (k) the 5,120-triangle icosphere on bench.py's 128x128 image,
           1280x720x8, depth 8, fixed quirks, fused (K9) and on the
           wavefront;
       (l) textured_globe 1280x720x16, depth 8, reference quirks, fused
           (K8 and K9); through engine='mega_diff' without and with a
           gradient (K7, K8, K9); one mega_diff fit step at (e)'s shape;
       (m) big_field: 5 x 5 icospheres, 128,000 triangles, 1280x720x8,
           path 8, fixed quirks, fused, Morton tables, through three
           routes: the default (phased every 2 bounces, octants, 8 shells:
           K6, K10, K11), compact_auto off (monolithic K6) and monolithic
           with 8 shells; the three frames must be equal; each route also
           over the frame's rays in one call against its bound, and K10's
           boundary cost (the default route less monolithic with 8
           shells, frame-sized and per frame);
       (n) big1m: 12 x 17 icospheres, 1,044,480 triangles, 1280x720x8,
           lambert, fixed quirks, fused (monolithic K6), and one launch
           over the frame's rays against its bound; the frame-sized
           launches of (m) and (m) with 8 shells, cooperative against one
           thread per ray;
       (q) (m) under mega_mxu (K12) through select_mega's route and
           monolithic, each over the frame's rays against its bound;
       (r) (n) under mega_mxu, lambert, and one frame-sized launch;
       (o) apps/animate.py's loop on skinned_capsule (the 5,120-triangle
           icosphere as a two-bone capsule): 31 frames at its defaults,
           1024x512x4, depth 8, lambert, --pipeline mega (K1), the tables
           rebuilt every frame; median update, table build and rendering
           s/frame, peak memory, the last frame's mean and mesh share;
       (p) the same on skinned_field (big_field's 128,000 triangles on two
           bones, K6);
       (s) (o) through --pipeline bvh (the reference's active pipeline: a
           BVH built from frame 0's pose, skin and refit timed as update,
           the wavefront through the traversal kernel), and --pipeline
           fused for 3 frames; the last frame against (o)'s: at most
           max(2, n/200) pixels over 1e-3;
       (t) (p) through --pipeline bonebvh (a tree per bone) and bvh, each
           against (p)'s last frame the same way;
     then animate.main on an ASCII FBX of the capsule's bind pose, 3 frames
     each of the mega, pallas, list, bvh and fused pipelines at 256x128x2
     (CSV and PNGs), and bonebvh's empty-forest error on that unskinned
     file; then apps/render.py --accel bvh on the icosphere at (b)'s
     1280x720x8;
     then the replay divergence on (g)'s and (l)'s first launch: the rays
     whose replay meets a recorded winner that the replayed ray misses
     (must be 0: the replay takes its decisions and rays from the plain
     version);
  7. parallel (``phase_parallel``, after the main paths; its kernel
     launches, counted from 0 in each case on every rank, join the
     kernels line's): (c)'s scene at 1920x1080x2, depth 8, on the
     wavefront with cfg.wavefront_compact off and on under one injected
     stream, the frames bit-equal, s/frame of each, the alive share and
     K3's card time at bounces 1, 4 and 8 of the first 2^18 rays in each
     order; then two ranks through gloo on the card (the backend rule:
     gloo when ranks share a card): dp = 2 on (c)'s frame on the
     wavefront and under mega, each bit-equal to one process on the same
     injected stream; tp = 2 on (m) at 1280x720x1, depth 8, fixed quirks,
     sphere cull 'primary' (builder order): first-hit winners equal to
     one process's sweeps on all but max(2, n / 10^4) rays, the rest
     counted as exact-t ties or slivers below the margins' proof (no
     other), and the tp frame timed, at most max(2, n / 200) pixels over
     1e-3 against one process; sample-parallel (dp = 2) within 1e-6 of
     the members' mean; the fit step at (e)'s shape (lr 0.1, JAX's test's
     rate) at dp = 2, then at dp x tp = 2 x 2 on four ranks: overlapped
     against post-hoc and each against the single-process step, loss
     rtol 1e-6, params rtol 1e-5 and atol 1e-7 (the single step run twice
     gives the card's own noise floor, reported); one rank through NCCL
     (the fit step and a render, so the NCCL path runs); and
     ``dryrun_multichip(4)``; one ``[parallel]`` line with every reading
     and the card's name and power limit;
  8. the last line: {"ok": true, "device": {...}}.

Writes its PNGs and the build log under chip_smoke_out/.

    python3 chip_smoke.py --ab [--root DIR]

    python3 chip_smoke.py --ab --only
        sweeps|kernels|fused|xform|margins|xcull [--root DIR]

times only what compares two commits on one card (``ab_main``: K3, K4, K5,
K2 (a trace's draws) and the wavefront cells (c), (d), (k), (e), then K1,
K7, K8, K9 and (a)'s frame, then K6, K10, K11, K12 (on the card and as
the call) and the (l) and (p) cells, then the margins' stress rays,
counted; with ``--only`` one of them: ``ab_sweeps`` (``kernels``: without
its cells), ``ab_fused``, ``ab_xform`` (K1, K7, K8 and (g), (h), (i)),
``ab_margins``, or ``ab_xcull``, K8's chunks against its flat walk by rows
a class), with the package of the checkout at DIR (default: this one).
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import json
import math
import os
import re
import subprocess
import sys
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chip_smoke_out")

# Published H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor
# cores, and HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# FLOPs of one test as the kernel writes it (adds, multiplies, compares,
# one division or square root each counted as one):
FLOP_BOX = 24      # slab: 6 sub, 6 mul, 10 min/max, 2 compares
FLOP_SPHERE = 26   # 3 sub, b 5, c 6, disc 3, sqrt, 2 roots x 2, 4 compares
FLOP_TRI = 46      # h 9, a 5, 1/a, s 3, u 6, q 9, v 6, t 6, 1 add
# K8, per rect / TRS row: TransformRay (3 div, |d/s|^2 5, sqrt, 1/x, 3 mul,
# two 3x3 rotations 30, 3 sub) = 46, plus the test and the compare of
# t * (1 / |raw d|) with best_t: rect 16 (div, x and y 4, facing, 8
# compares, mul, compare), TRS sphere 34 (b, a 5 each, c 6, disc 3, sqrt,
# 1/a, two roots 4, 8 compares and selects, mul, compare), TRS triangle 64
# (Moller-Trumbore 46, the backface dot 6, 10 compares, mul, compare)
FLOP_XFORM = (46 + 16, 46 + 34, 46 + 64)
# K8's chunk test (xchunk): the raw slab 12 (6 sub, 6 mul), per axis entry
# and exit 2 min/max, then 4 products and 2 min/max by the scale range, the
# entry's and exit's 4 min/max, best t x max b, 6 compares
FLOP_XBOX = 12 + 6 + 18 + 4 + 1 + 6
# K11, per top-level box a ray's shells rank (counted once per sweep, as
# the order needs it; the kernel's recomputation in each pass is not
# charged): its distance (clip 6, sub 3, mul 3, add 2), the scan's min and
# max (2) and its shell index (sub, mul, floor, 2 compares)
FLOP_DIST = 21
# K12, per triangle test the closest hit needs (K6's count on the same
# rays: K12 itself tests every triangle of a reached super, which the chunk
# boxes would cull, and the bound charges only the needed tests): its
# bilinear forms, each product and each sum of a non-zero term (a 5, t_num
# 6, u_num 11, v_num 11), then 1 / a, three products, |a| and 9 compares
# and the best-t compare (14); under backface_only also d.n (5) and its
# compare.  (The TPU's dense (5 * 256 x 10) @ (10 x 128) matmul charges
# 19 per form, its zero terms included.)
FLOP_MXU = 47
FLOP_MXU_DN = 6
# Hopper's lanes a clock per SM on each pipe that K2's SASS runs on (the
# integer pipe: IMAD, LOP3, IADD3, shifts, compares, moves; FP32; the MUFU:
# transcendentals and conversions) and its issue (four schedulers, one warp
# instruction a clock each, whatever the pipe): a draw's cost on the card
# is its instructions on each (``draw_pipes``, counted from this run's
# build) over that rate, the slowest taken
PIPE_LANES = {"int": 64, "fp32": 128, "mufu": 16, "issue": 128}
N_ATTRS = 21       # K5's attribute row: centre, radius, mat, 16 decode

DEPTH = 8
PHASE3 = (128, 64, 4)
# Kernel and plain version round alike (no contraction), so every ray must
# agree to this.
PARITY_ATOL = 1e-5
# The fit's first-step gradients, card against CPU: max |g_card - g_cpu| over
# max |g_cpu|, per parameter.  Same kernels' arithmetic on both sides; the
# card sums the scatter-adds with atomics and the means in another order.
GRAD_RTOL = 1e-3
INTEGRATORS = ("path", "lambert", "normal")


class Frame(NamedTuple):
    name: str
    scene: object
    camera: object
    cfg: object
    tables: object


# ---------------------------------------------------------------------------
# Measurement helpers
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps=3, warmup=1):
    """(min milliseconds over reps, last result), CUDA events."""
    for _ in range(warmup):
        out = fn()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best, out


# device_ms: the card spins this many cycles (about 2 ms at an H100's
# clocks) before each start event, longer than the host takes to enqueue
# one fused launch (the wrapper's checks and its ctypes call)
SPIN_CYCLES = 4_000_000


def device_ms(fn, reps=5, warmup=1):
    """(min milliseconds over reps, last result) of the card's work in fn,
    CUDA events: before each start event the card spins (SPIN_CYCLES), so
    fn's launches are queued behind it and a launch whose host side takes
    longer than its kernel is timed by its kernel.  ``cuda_ms`` times the
    call, the host's enqueue included where it is the longer."""
    for _ in range(warmup):
        out = fn()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best, out


def host_ms(fn, reps=10):
    """Min milliseconds over reps of the host's time in fn (the wrapper's
    checks, allocations and its enqueue), the card idle before each."""
    fn()
    best = math.inf
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        best = min(best, (time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return best


def inplace_ms(fn, planes, start_from, reps=3, card=False):
    """(min milliseconds over reps, after a warm-up) of fn, a K10 window
    that updates ``planes`` in place, each run from the planes
    ``start_from`` (copied in outside the timed span), CUDA events; card:
    queued behind a spin, as device_ms times the card's work alone."""
    best = math.inf
    for rep in range(reps + 1):
        planes.copy_(start_from)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if card:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        if rep:
            best = min(best, start.elapsed_time(end))
    return best


def ks_uniform(x: torch.Tensor) -> float:
    """Kolmogorov-Smirnov statistic of x against U[0, 1)."""
    x = torch.sort(x.double().flatten()).values
    n = x.numel()
    i = torch.arange(1, n + 1, device=x.device, dtype=torch.float64)
    return float(torch.maximum(i / n - x, x - (i - 1) / n).max())


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def compare(label: str, got: torch.Tensor, ref: torch.Tensor) -> float:
    """Print and check one kernel-against-plain comparison -> max abs
    error."""
    diff = (got - ref).abs().amax(dim=1)
    err = float(diff.max())
    share = float((diff > 1e-3).float().mean())
    print(f"[parity] {label:40s} rays {got.shape[0]:7d} differing>1e-3 "
          f"{share * 100:.4f}% max_abs_err {err:.3g}")
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite radiance")
    check(err <= PARITY_ATOL, f"{label}: kernel and plain differ by {err}")
    return err


def bound(flops: float, bytes_: float, draws: int = 0) -> tuple:
    """(bound ms, bound_by): the larger of the operations' time and the
    bytes over the memory rate.  The operations: the FLOPs over the FP32
    peak and ``draws`` Philox draws at K2's instructions a draw on each
    pipe and in issue slots (``draw_pipes``), each at its own rate (the
    draws' FP32 instructions added to the FLOPs' time), the slowest
    taken."""
    t_ops = flops / PEAK_FP32
    if draws:
        per = draw_pipe_seconds()
        t_ops = max(t_ops + draws * per["fp32"],
                    *(draws * per[p] for p in ("int", "mufu", "issue")))
    t_bytes = bytes_ / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# The card's SMs and top SM clock (``device_facts``, this run's card) and
# K2's instructions a draw by pipe (``draw_pipes``, this run's build)
DEVICE = {}
LIBRARY = {}
# SASS opcodes by the pipe that runs them (the opcode before its first
# '.'): the integer pipe, FP32 (HFMA2.MMA moves a constant on the FMA
# pipe) and the MUFU (transcendentals and the conversions it runs);
# uniform-datapath (U...), control, memory and special-register
# instructions use none of the three
SASS_PIPES = {
    "int": {"IMAD", "IADD3", "VIADD", "LOP3", "SHF", "LEA", "ISETP",
            "IMNMX", "VIMNMX", "IABS", "SEL", "MOV", "PRMT", "POPC", "FLO",
            "BREV", "I2FP", "PLOP3", "IMUL", "BMSK", "SGXT", "P2R", "R2P"},
    "fp32": {"FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FSET",
             "FCHK", "HFMA2"},
    "mufu": {"MUFU", "F2I", "I2F", "F2F", "FRND"}}
SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?"
                       r"([A-Z0-9_.]+)([^;]*);")


def device_facts() -> None:
    """The card's SM count and its top SM clock, from this run's card."""
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0]
    DEVICE["sms"] = torch.cuda.get_device_properties(0).multi_processor_count
    DEVICE["clock_hz"] = float(clock) * 1e6


def sass_instructions(text: str) -> list:
    """cuobjdump -sass text -> [(address, predicated, opcode, operands)]."""
    return [(int(m.group(1), 16), m.group(2) is not None, m.group(3),
             m.group(4)) for m in SASS_LINE.finditer(text)]


def hot_draw_path(ins: list, steps: int) -> list:
    """The instructions one draw of crt_draws executes on the path its
    inputs take, weighted: the step loop's body once (one draw a pass), the
    rest of the ray loop once a ray (1 / steps of it a draw).  Left out:
    the subroutines after the kernel's EXIT (reached by CALL: the slow
    paths of the division and the square roots) and every region that a
    forward branch skips where the region holds a CALL or a loop of its
    own but not the draw's store (the large-argument reduction of sinf /
    cosf, whose arguments here are below 2 pi) -> [(weight, opcode)]."""
    end = next(a for a, pred, op, _ in ins if op == "EXIT" and not pred)
    main = [x for x in ins if x[0] <= end]
    target = {a: int(m.group(1), 16) for a, _, op, args in main
              if op.startswith("BRA")
              for m in [re.search(r"0x([0-9a-f]+)", args)] if m}
    cold = set()
    for a, pred, op, _ in main:
        t = target.get(a)
        if not pred or t is None or t <= a:
            continue
        inside = [x for x in main if a < x[0] < t]
        if any(x[2].startswith("CALL") or a < target.get(x[0], t) < x[0]
               for x in inside) and not any(x[2].startswith("STG")
                                            for x in inside):
            cold.update(x[0] for x in inside)
    loops = sorted((t, a) for a, t in target.items()
                   if t < a and a not in cold)
    check(len(loops) == 2, f"crt_draws: {len(loops)} hot loops, expected "
          "the ray loop and the step loop")
    (ray_lo, ray_hi), (step_lo, step_hi) = loops
    check(ray_lo < step_lo and step_hi < ray_hi, "crt_draws: the step "
          "loop is not inside the ray loop")
    out = []
    for a, _, op, _ in main:
        if a in cold or not ray_lo <= a <= ray_hi:
            continue
        out.append((1.0 if step_lo <= a <= step_hi else 1.0 / steps, op))
    return out


def draw_pipes(steps: int = DEPTH + 1) -> dict:
    """K2's instructions a draw by pipe (SASS_PIPES; ``other``: those on
    none of them; ``issue``: all of them), counted on ``hot_draw_path`` of
    the crt_draws kernel in this run's build of the megakernel library
    (cuobjdump -sass), a launch of ``steps`` bounces; cached."""
    from cudaraytracer_tpu_torch.ops import _cuda
    if "draw_pipes" not in DEVICE:
        tool = os.path.join(os.path.dirname(_cuda.nvcc_path()), "cuobjdump")
        text = subprocess.run([tool, "-sass", "-fun", "crt_draws",
                               str(LIBRARY["megakernel"])],
                              capture_output=True, text=True,
                              check=True).stdout
        counts = {p: 0.0 for p in (*SASS_PIPES, "other")}
        for w, op in hot_draw_path(sass_instructions(text), steps):
            base = op.split(".")[0]
            pipe = next((p for p, ops in SASS_PIPES.items() if base in ops),
                        "other")
            counts[pipe] += w
        counts["issue"] = sum(counts.values())
        DEVICE["draw_pipes"] = {p: round(v, 3) for p, v in counts.items()}
    return DEVICE["draw_pipes"]


def draw_pipe_seconds() -> dict:
    """Seconds a draw takes the card on each pipe: its instructions there
    (``draw_pipes``) over the pipe's lanes a clock x SMs x clock."""
    pipes = draw_pipes()
    return {p: pipes[p] / (lanes * DEVICE["sms"] * DEVICE["clock_hz"])
            for p, lanes in PIPE_LANES.items()}


def takes_mxu(tables, cfg) -> bool:
    """Whether a launch under ``cfg`` on these tables takes K12."""
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    return cfg is not None and mk.launch_modes(tables, cfg, False)[1]


def counting_cfg(tables, cfg):
    """The config whose counting instance counts the tests that a launch
    under ``cfg`` needs: under K12, which tests every triangle of a reached
    super, K6's (the chunk boxes cull inside a super; no shells), else
    ``cfg`` itself."""
    if not takes_mxu(tables, cfg):
        return cfg
    return dataclasses.replace(cfg, mega_mxu=False, mega_f2b_shells=0)


def launch_bound(tables, n: int, tests: dict, out_bytes: int = 12,
                 extra_bytes: int = 0, cfg=None,
                 ray_bytes: Optional[int] = None,
                 draws: bool = False) -> tuple:
    """(bound ms, bound_by) of one launch over n rays that needed ``tests``
    (count_tests): their FLOPs (box, segment and box-distance tests
    included; with ``draws`` also each draw the kernel made, the counting
    instance's ``draw``, at K2's instructions a draw by pipe) against the
    rays in, ``out_bytes`` per ray out (or in all ``ray_bytes``, the rays'
    own bytes in and out),
    the box and rect / TRS tables, the sphere and triangle rows of the
    chunks whose prims were tested (under K12, which ``cfg`` decides: the
    coefficients of those chunks' triangles, N_COEF floats = 96 bytes
    each), and ``extra_bytes`` (K9: 3 per texel fetched; K10: the state a
    route's windows move)."""
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    mxu = takes_mxu(tables, cfg)
    dn = cfg is not None and cfg.quirks.triangle_backface_only
    tri_flops = (FLOP_MXU + (FLOP_MXU_DN if dn else 0) if mxu
                 else FLOP_TRI)
    flops = (tests["box"] * FLOP_BOX + tests["seg"] * FLOP_BOX
             + tests["sph"] * FLOP_SPHERE + tests["tri"] * tri_flops
             + tests["dist"] * FLOP_DIST + tests.get("xbox", 0) * FLOP_XBOX
             + sum(tests[k] * f for k, f in zip(("rect", "tsph", "ttri"),
                                                FLOP_XFORM)))
    tri_row = mk.N_COEF * 4 if mxu else mk.TRI_COLS * 4
    rows = (tests["touched_sph_chunks"] * mk.PRIM_CHUNK * mk.SPH_COLS * 4
            + tests["touched_tri_chunks"] * mk.PRIM_CHUNK * tri_row)
    tables_bytes = (mk.table_bytes(tables) - tables.sph.nbytes
                    - tables.tri.nbytes - tables.tri_coef.nbytes + rows)
    if ray_bytes is None:
        ray_bytes = n * (24 + out_bytes)
    return bound(flops, ray_bytes + tables_bytes + extra_bytes,
                 tests["draw"] if draws else 0)


def count_tests(tables, rays, cfg, seed, window=None,
                hold: bool = False) -> dict:
    """The tests one launch needs (the counting variant under
    ``counting_cfg``), by name (megakernel.COUNT_NAMES), the chunks whose
    prims it tested, and (a package that counts them) its schedule
    (megakernel.WORK_NAMES: bounces, warp steps, draws made).  Under K12
    also ``tri_done``: the triangle tests that
    K12's own counting instance makes, every triangle of a reached super.
    hold: also count with the one-thread-per-ray sweeps (per_thread) and
    require the same counts and touched chunks, since the cooperative
    sweeps (K6, K11, K12) make the same (ray, triangle) tests."""
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    n_sc = tables.sph_box.shape[0]

    def counted(c, per_thread=False):
        counts = torch.zeros(mk.N_COUNTS, dtype=torch.int64,
                             device=rays.origin.device)
        touched = torch.zeros(max(n_sc + tables.tri_box.shape[0], 1),
                              dtype=torch.uint8, device=rays.origin.device)
        work = (torch.zeros(mk.N_WORK, dtype=torch.int64,
                            device=rays.origin.device)
                if hasattr(mk, "N_WORK") else None)
        mk._launch_mega(tables, rays.origin.contiguous(),
                        rays.direction.contiguous(), c, None, seed,
                        counts=counts, touched=touched,
                        window=window if window is not None else mk.WHOLE,
                        per_thread=per_thread,
                        **({} if work is None else {"work": work}))
        return counts, touched, work

    def held(c):
        counts, touched, work = counted(c)
        if hold:
            c_pt, t_pt, _ = counted(c, True)
            check(torch.equal(counts, c_pt) and torch.equal(touched, t_pt),
                  f"cooperative counts {counts.tolist()} differ from the "
                  f"per-thread sweep's {c_pt.tolist()}")
        out = counted_tests(counts, touched, n_sc)
        if work is not None:
            out.update(zip(mk.WORK_NAMES, work.tolist()))
        return out

    need = counting_cfg(tables, cfg)
    out = held(need)
    if need is not cfg:
        out["tri_done"] = held(cfg)["tri"]
    if hold:
        print(f"[count] the cooperative and per-thread counting instances "
              f"made the same tests: {out}")
    return out


def counted_tests(counts, touched, n_sph_chunks: int) -> dict:
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    out = dict(zip(mk.COUNT_NAMES, counts.tolist()))
    out["touched_sph_chunks"] = int(touched[:n_sph_chunks].sum())
    out["touched_tri_chunks"] = int(touched[n_sph_chunks:].sum())
    return out


# nvcc's -Xptxas -v report of this run's build (phase_build), and whether
# this run built the megakernel (a reused build reports nothing)
PTXAS = {"text": "", "built": False}
# path_instance_of's keys, copied into the kernels line's rows
INSTANCE_KEYS = ("instance", "registers", "spill_bytes", "local_bytes",
                 "grid_blocks", "refill_idle")


def ptxas_usage(name: str) -> tuple:
    """(registers, spill store bytes) of the instance whose mangled name
    is ``name``, from this run's ptxas report, or (None, None) when the
    report does not hold it."""
    lines = PTXAS["text"].splitlines()
    for k, line in enumerate(lines):
        if line.rstrip().endswith(f"Function properties for {name}"):
            spill = re.search(r"(\d+) bytes spill stores", lines[k + 1])
            for nxt in lines[k + 1:k + 4]:
                regs = re.search(r"Used (\d+) registers", nxt)
                if regs:
                    return int(regs.group(1)), int(spill.group(1))
    return None, None


def path_mangled(count=False, xform=False, winners=False, tex=False,
                 shells=False, mxu=False, window=False) -> str:
    """The mangled name of crt::mega_path<COUNT, XFORM, WINNERS, TEX,
    SHELLS, MXU, WINDOW>(crt::Params), as ptxas -v reports it."""
    flags = (count, xform, winners, tex, shells, mxu, window)
    return ("_ZN3crt9mega_pathI" + "".join(f"Lb{int(v)}E" for v in flags)
            + "EEvNS_6ParamsE")


def path_flags(tables, cfg, want_winners: bool = False) -> dict:
    """The mega_path template flags of a production path launch."""
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    tex, _, f2b = mk.launch_modes(tables, cfg, want_winners)
    xform = sum(getattr(tables, k).shape[0] for k in ("rect", "tsph", "ttri"))
    return {"xform": xform > 0, "winners": want_winners, "tex": tex,
            "shells": f2b > 0}


def path_instance_of(tables, cfg, n: int, want_winners: bool = False) -> dict:
    """The mega_path instance that a production path launch of n rays over
    ``tables`` takes: its registers and local memory a thread (the
    runtime's count), its spill stores (this run's ptxas report, which
    must hold it) and the grid blocks the launch takes (the occupancy and
    SM count it launches with, megakernel.path_instance)."""
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    flags = path_flags(tables, cfg, want_winners)
    info = mk.path_instance(n, **flags)
    name = path_mangled(**flags)
    regs, spill = ptxas_usage(name)
    check(not PTXAS["built"] or regs == info["registers"], f"this run's "
          f"ptxas report gives {name} {regs} registers, the runtime "
          f"{info['registers']}")
    return {"instance": name, "registers": info["registers"],
            "spill_bytes": spill, "local_bytes": info["local_bytes"],
            "grid_blocks": info["grid_blocks"],
            "refill_idle": info["refill_idle"]}


def lane_use_model(scene, win: torch.Tensor) -> float:
    """A model, not a measurement, of the lanes' use of the
    one-thread-per-ray schedule that mega_path replaced, from K7's winners
    int32[depth + 1, n] of a launch: a ray's
    steps are its recorded bounces plus its miss, and a warp of 32
    consecutive rays runs its longest.  A path that ends on a hit ends at
    a light or at the depth limit, or on a metal's absorbed scatter, which
    the winners cannot tell from a miss (counted as a miss step)."""
    from cudaraytracer_tpu_torch.models import materials as mt
    mats = torch.cat([scene.spheres.mat, scene.triangles.mat,
                      scene.rects.mat, scene.t_spheres.mat,
                      scene.t_triangles.mat]).long()
    light = scene.materials.kind[mats] == mt.DIFFUSE_LIGHT
    depth1, n = win.shape
    hits = (win >= 0).sum(0)
    last = win.gather(0, (hits - 1).clamp(min=0)[None].long())[0]
    ended = (hits == depth1) | ((hits > 0) & light[last.clamp(min=0).long()])
    steps = hits + (~ended).long()
    pad = (-n) % 32
    warps = torch.cat([steps, steps.new_zeros(pad)]).view(-1, 32)
    return float(steps.sum()) / float(32 * warps.amax(1).sum())


def print_schedule_model(label: str, scene, win: torch.Tensor) -> None:
    """Prints on a line of its own the model of the one-thread-per-ray
    schedule that mega_path replaced (kept out of the kernels line, which
    holds what this run measured): its lanes' use and the ceil(n / 128)
    blocks that its launch code took for n rays."""
    n = win.shape[1]
    print(f"[parity] {label}: model, not measured: one thread per ray "
          f"would use {lane_use_model(scene, win):.4f} of the lanes on "
          f"{-(-n // 128)} blocks")


def lane_use(tests: dict) -> float:
    """The lanes' use the counting instance measured on mega_path's
    schedule: bounces over 32 lanes x warp steps."""
    return tests["bounce"] / (32.0 * tests["warp_step"])


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_build():
    from cudaraytracer_tpu_torch.ops import _cuda
    t0 = time.perf_counter()
    reports = _cuda.build()
    wall = time.perf_counter() - t0
    LIBRARY.update((k, r.library) for k, r in reports.items())
    device_facts()
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "build.log"), "w") as f:
        for r in reports.values():
            f.write(f"== {r.name} ({r.seconds:.1f} s)\n{r.ptxas}\n")
    PTXAS["text"] = "\n".join(r.ptxas for r in reports.values())
    PTXAS["built"] = reports["megakernel"].ptxas != "(reused)"
    for r in reports.values():
        print(f"[build] {r.name}: {r.seconds:.1f} s -> {r.library.name}")
        for line in r.ptxas.splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling entry" in line):
                print(f"[build]   {line.strip()}")
    print(f"[build] total {wall:.1f} s")


def main_frames(dev) -> list:
    """The two phase-5 frames, with their Morton tables."""
    from cudaraytracer_tpu_torch.config import Quirks, RenderConfig
    from cudaraytracer_tpu_torch.models import presets
    from cudaraytracer_tpu_torch.models.check_scenes import icosphere_scene
    from cudaraytracer_tpu_torch.ops.megakernel import morton_tables
    sa, ca = presets.random_spheres(aspect=1920 / 1080, device=dev)
    cfg_a = RenderConfig(width=1920, height=1080, samples=16,
                         max_depth=DEPTH, engine="mega")
    sb, cb = icosphere_scene(1280 / 720, device=dev)
    check(sb.n_triangles == 5120, "icosphere size")
    cfg_b = RenderConfig(width=1280, height=720, samples=8, max_depth=DEPTH,
                         quirks=Quirks.fixed(), engine="mega")
    return [Frame("random_spheres", sa, ca, cfg_a, morton_tables(sa)),
            Frame("icosphere", sb, cb, cfg_b, morton_tables(sb))]


def first_chunk(f: Frame, gen, index: int = 0):
    """The rays of one of the frame's kernel launches (default the first),
    as render_pixels makes them: ray_chunk // samples pixels in swizzled
    order."""
    from cudaraytracer_tpu_torch.core.camera import generate_pixel_rays
    from cudaraytracer_tpu_torch.ops.render import swizzled_pixels
    c = f.cfg
    per = c.ray_chunk // c.samples
    pix = swizzled_pixels(c.width, c.height, device=f.scene.device)
    return generate_pixel_rays(f.camera, c.width, c.height, c.samples,
                               pix[index * per:(index + 1) * per],
                               generator=gen)


def middle_chunk(f: Frame) -> int:
    """The index of the frame's middle launch: the icosphere frame's first
    launch covers its bottom rows, which see only the ground sphere."""
    per = f.cfg.ray_chunk // f.cfg.samples
    return -(-f.cfg.width * f.cfg.height // per) // 2


def chunk_parity(dev, frames) -> dict:
    """One full main-path launch of each frame against the plain version;
    times both and counts the tests of the path launch."""
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    from cudaraytracer_tpu_torch.ops.integrators import stream_from_generator
    gen = torch.Generator(device=dev).manual_seed(7)
    out = {"max_abs_err": 0.0}
    for f in frames:
        rays = first_chunk(f, gen)
        n = rays.origin.shape[0]
        check(n == f.cfg.ray_chunk, f"{f.name}: first chunk of {n} rays")
        stream = stream_from_generator(gen, n, DEPTH, dev)
        st = mk.stream_tensor(stream, n, DEPTH + 1)
        for integrator in INTEGRATORS:
            cfg = dataclasses.replace(f.cfg, integrator=integrator)
            got = mk.trace_path_mega(f.scene, rays, cfg, tables=f.tables,
                                     samples=stream)
            ref = mk.trace_path_mega_plain(f.tables, rays, cfg, st)
            err = compare(f"{f.name} chunk {integrator} injected", got, ref)
            out["max_abs_err"] = max(out["max_abs_err"], err)
        seed = mk.draw_seed(gen)
        ms, got = device_ms(lambda: mk.trace_path_mega(
            f.scene, rays, f.cfg, tables=f.tables, seed=seed))
        inst = path_instance_of(f.tables, f.cfg, n)
        call_ms, _ = cuda_ms(lambda: mk.trace_path_mega(
            f.scene, rays, f.cfg, tables=f.tables, seed=seed))
        plain_ms, ref = cuda_ms(lambda: mk.trace_path_mega_plain(
            f.tables, rays, f.cfg, None, seed), reps=1, warmup=0)
        err = compare(f"{f.name} chunk path in-kernel draws", got, ref)
        out["max_abs_err"] = max(out["max_abs_err"], err)
        tests = count_tests(f.tables, rays, f.cfg, seed)
        _, win = mk.trace_path_mega(f.scene, rays, f.cfg, tables=f.tables,
                                    seed=seed, want_winners=True)
        lanes = lane_use(tests)
        bound, bound_by = launch_bound(f.tables, n, tests, draws=True)
        no_draws, _ = launch_bound(f.tables, n, tests)
        print(f"[parity] {f.name} chunk path: kernel {ms:.4f} ms (the call "
              f"{call_ms:.4f} ms), plain "
              f"{plain_ms:.3f} ms, bound {bound:.4f} ms ({bound_by}; "
              f"{no_draws:.4f} ms without the draws), lanes' use "
              f"{lanes:.4f}, instance {inst}, tests {tests}")
        print_schedule_model(f"{f.name} chunk path", f.scene, win)
        out[f.name] = {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                       "bound_ms": bound,
                       "bound_by": bound_by, "bound_no_draws_ms": no_draws,
                       "lane_use": lanes, **inst, "tests": tests, "rays": n}
    return out


def phase_parity(dev, frames) -> dict:
    """mega_trace against trace_path_mega_plain on the card."""
    from cudaraytracer_tpu_torch.config import Quirks, RenderConfig
    from cudaraytracer_tpu_torch.core.camera import generate_pixel_rays
    from cudaraytracer_tpu_torch.core.rays import make_rays
    from cudaraytracer_tpu_torch.models import check_scenes as cs
    from cudaraytracer_tpu_torch.models import presets
    from cudaraytracer_tpu_torch.models.scene import SceneBuilder
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    from cudaraytracer_tpu_torch.ops.integrators import stream_from_generator
    result = chunk_parity(dev, frames)
    w, h, spp = PHASE3
    gen = torch.Generator(device=dev).manual_seed(1)
    mixed = cs.mixed_scene(dev)
    cases = [("three_spheres", presets.three_spheres(2.0, device=dev),
              Quirks.reference()),
             ("mixed_reference", mixed, Quirks.reference()),
             ("mixed_fixed", mixed, Quirks.fixed()),
             ("random_spheres", presets.random_spheres(2.0, device=dev),
              Quirks.reference())]
    for name, (scene, cam), quirks in cases:
        tables = mk.morton_tables(scene)
        rays = generate_pixel_rays(cam, w, h, spp, generator=gen)
        n = rays.origin.shape[0]
        stream = stream_from_generator(gen, n, DEPTH, dev)
        for integrator in INTEGRATORS:
            cfg = RenderConfig(width=w, height=h, samples=spp,
                               max_depth=DEPTH, integrator=integrator,
                               quirks=quirks, engine="mega")
            got = mk.trace_path_mega(scene, rays, cfg, tables=tables,
                                     samples=stream)
            ref = mk.trace_path_mega_plain(
                tables, rays, cfg, mk.stream_tensor(stream, n, DEPTH + 1))
            err = compare(f"{name} {w}x{h}x{spp} {integrator}", got, ref)
            result["max_abs_err"] = max(result["max_abs_err"], err)
    # duplicated prims: the copies change nothing
    scene, cam = cs.duplicate_scene(dev)
    single, _ = cs.duplicate_scene(dev, duplicates=False)
    rays = generate_pixel_rays(cam, 64, 32, 2, generator=gen)
    for integrator in INTEGRATORS:
        cfg = RenderConfig(width=64, height=32, samples=2, max_depth=DEPTH,
                           integrator=integrator, quirks=Quirks.fixed(),
                           engine="mega")
        tables = mk.morton_tables(scene)
        got = mk.trace_path_mega(scene, rays, cfg, tables=tables, seed=3)
        ref = mk.trace_path_mega_plain(tables, rays, cfg, None, 3)
        one = mk.trace_path_mega(single, rays, cfg,
                                 tables=mk.morton_tables(single), seed=3)
        err = compare(f"duplicates {integrator}", got, ref)
        result["max_abs_err"] = max(result["max_abs_err"], err)
        check(torch.equal(got, one), "duplicate prims changed the image")
    # exact ties across chunks and between a sphere and a triangle
    scene = cs.fill_tie_scene(SceneBuilder()).build(dev)
    rays = make_rays(cs.TIE_ORIGINS, cs.TIE_DIRECTIONS, device=dev)
    cfg = RenderConfig(max_depth=0, quirks=Quirks.fixed(), engine="mega")
    got = mk.trace_path_mega(scene, rays, cfg,
                             tables=mk.build_mega_tables(scene), seed=0)
    err = float((got.cpu() - torch.from_numpy(cs.TIE_EXPECTED)).abs().max())
    print(f"[parity] exact ties path max_abs_err vs expected {err}")
    check(err == 0.0, "exact ties: a later prim won")
    return result


def phase_draws(dev, n_path: int):
    """K2 as the wavefront launches it: every bounce of a depth-DEPTH trace
    of one chunk (DEPTH + 1 bounces x n_path rays) in one launch, timed on
    the card (device_ms) and as the call, against the plain version, the
    one-bounce launches stacked and a launch of a later range of bounces;
    one bounce of 2^22 samples against the plain version and the unit-ball
    and uniform distributions; its bound from this run's SASS
    (``draw_pipes``: the instructions a draw by pipe); and, for scale only,
    torch.rand's Philox over n_path x 4 floats on the same card (not the
    same function)."""
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    steps, seed = DEPTH + 1, 0xD1CE
    path_out = torch.empty(steps, n_path, 4, device=dev)
    ms, _ = device_ms(lambda: mk.scatter_draws(path_out, seed), reps=20)
    call_ms, _ = cuda_ms(lambda: mk.scatter_draws(path_out, seed), reps=20)
    plain_ms, ref = cuda_ms(
        lambda: mk.scatter_draws_plain(n_path, seed, 0, dev, steps), reps=3)
    err = float((path_out - ref).abs().max())
    one = torch.stack([mk.scatter_draws(torch.empty(n_path, 4, device=dev),
                                        seed, s) for s in range(steps)])
    check(torch.equal(one, path_out), "scatter_draws: the launch of every "
          "bounce differs from the one-bounce launches")
    later = mk.scatter_draws(torch.empty(steps - 5, n_path, 4, device=dev),
                             seed, 5)
    check(torch.equal(later, path_out[5:]), "scatter_draws: bounces from 5 "
          "differ from those of the launch from bounce 0")
    rand_ms, _ = device_ms(lambda: torch.rand(n_path, 4, device=dev),
                           reps=20)
    pipes = draw_pipes()
    draws = steps * n_path
    bound_ms, bound_by = bound(0.0, draws * 16, draws)
    pipe_ms = {p: draws * t * 1e3 for p, t in draw_pipe_seconds().items()}
    print(f"[draws] {steps} bounces x {n_path} rays (one trace of a "
          f"wavefront chunk) in one launch: kernel {ms:.4f} ms "
          f"({ms / steps * (1 << 18) / n_path:.4f} ms per 2^18 draws; the "
          f"call {call_ms:.4f} ms), plain {plain_ms:.3f} ms, max_abs_err "
          f"{err:.3g}, equal to the {steps} one-bounce launches; bound "
          f"{bound_ms:.4f} ms ({bound_by}) from {pipes} instructions a draw "
          f"at {DEVICE['clock_hz'] / 1e6:.0f} MHz on {DEVICE['sms']} SMs "
          f"(ms by pipe {pipe_ms}); torch.rand 2^18 x 4 floats "
          f"{rand_ms:.4f} ms")
    n = 1 << 22
    out = mk.scatter_draws(torch.empty(n, 4, device=dev), seed, 3)
    err = max(err, float(
        (out - mk.scatter_draws_plain(n, seed, 3, dev)).abs().max()))
    ball, prob = out[:, :3].double(), out[:, 3]
    r = ball.norm(dim=1)
    mean = ball.mean(dim=0).abs().max()
    ks_r, ks_p = ks_uniform(r ** 3), ks_uniform(prob)
    print(f"[draws] {n} samples: max|ball| {float(r.max()):.7f} "
          f"max|mean| {float(mean):.2e} KS(r^3) {ks_r:.5f} "
          f"KS(prob) {ks_p:.5f}, max_abs_err vs plain {err:.3g}")
    check(float(r.max()) <= 1.0 + 1e-6, "ball sample outside the unit ball")
    check(float(mean) < 5e-3, "ball mean off 0")
    check(ks_r < 0.01 and ks_p < 0.01, "draws fail the KS checks")
    check(err == 0.0, "scatter_draws disagrees with its plain version")
    return {"name": "scatter_draws", "route": "cuda",
            "source": "cudaraytracer_tpu_torch/csrc/megakernel.cu",
            "replaces": "cudaraytracer_tpu/ops/pallas_intersect.py:1122",
            "launches": 0, "max_abs_err": err, "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
            "ms_at": f"one trace's draws: {steps} bounces x {n_path} rays",
            "ms_per_2_18_draws": ms / steps * (1 << 18) / n_path,
            "pipe_bound_ms": pipe_ms, "sass_per_draw": pipes,
            "torch_rand_2_18x4_ms": rand_ms, "draws": draws}


# ---------------------------------------------------------------------------
# The winner sum crt_winner_add
# ---------------------------------------------------------------------------

# The benchmark's fit cell (rtbench/workloads/one_weekend.fit.json): the
# rays of one step, at path depth DEPTH
FIT_CELL = (1280, 720, 4)


def fit_cell_winners(dev) -> torch.Tensor:
    """int32[DEPTH + 1, N]: each bounce's winners (-1: a miss or a dead
    lane) of one trace of random_spheres (the One Weekend scene, 484
    spheres) at the fit cell's 1280x720x4 on the fit's wavefront (K5)."""
    from cudaraytracer_tpu_torch.config import RenderConfig
    from cudaraytracer_tpu_torch.core.camera import generate_pixel_rays
    from cudaraytracer_tpu_torch.models import presets
    from cudaraytracer_tpu_torch.ops import integrators as integ
    from cudaraytracer_tpu_torch.ops.render import sweep_intersector_pair
    from cudaraytracer_tpu_torch.parallel.train import fit_config
    w, h, spp = FIT_CELL
    scene, cam = presets.random_spheres(aspect=w / h, device=dev)
    cfg = fit_config(RenderConfig(width=w, height=h, samples=spp,
                                  max_depth=DEPTH, gamma=False))
    rays = generate_pixel_rays(cam, w, h, spp, generator=torch.Generator(
        device=dev).manual_seed(0))
    with torch.no_grad():
        _, win = integ.trace_path(scene, rays, cfg,
                                  sweep_intersector_pair(cfg), seed=0x57,
                                  return_winners=True)
    return win, scene.n_spheres


def phase_winner_add(dev) -> dict:
    """crt_winner_add at the fit cell's shape: each bounce's winners of a
    real trace (``fit_cell_winners``), K5's row blocks (centre 3, radius 1,
    the 21 attributes, K = 25; the attributes contiguous, as autograd
    hands them over) over 484 spheres, against winner_add_plain and the
    three index_add_ calls it replaced (a yardstick only, ``library_ms``),
    each sum to 1e-5 of the |values| added into it; timed on the card
    (device_ms) and as the call; its bound: the bytes these inputs need
    (idx, the hit lanes' rows, the sums) over the memory rate, and beside
    it every lane's row read (``bound_all_rows_ms``)."""
    from cudaraytracer_tpu_torch.ops import sweeps as sw
    win, c = fit_cell_winners(dev)
    n = win.shape[1]
    gen = torch.Generator(device=dev).manual_seed(0x5A)
    g_c, g_r, g_attrs = (torch.randn(*s, generator=gen, device=dev)
                         for s in ((n, 3), (n,), (n, N_ATTRS)))
    blocks = (g_c, g_r, g_attrs)
    k = 3 + 1 + N_ATTRS

    def index_adds(idx):
        """The backward's three scatters before the winner sum."""
        hit = idx >= 0
        safe = idx.clamp(min=0).long()
        gc = torch.where(hit[:, None], g_c, 0.0)
        gr = torch.where(hit, g_r, 0.0)
        return (torch.zeros(c, 3, device=dev).index_add_(0, safe, gc),
                torch.zeros(c, device=dev).index_add_(0, safe, gr),
                torch.zeros(N_ATTRS, c, device=dev).index_add_(
                    1, safe, torch.where(hit[None], g_attrs.t(), 0.0)).t())

    rows, err = [], 0.0
    for b in range(win.shape[0]):
        idx = win[b].contiguous()
        hits = int((idx >= 0).sum())
        sw.reset_launch_counts()
        got = sw.winner_add(idx, blocks, c)
        check(sw.LAUNCH_KINDS["winner_add"] == {
            **dict.fromkeys(sw.WINNER_FORMS, 0), "shared": 1},
            f"winner_add took {sw.LAUNCH_KINDS['winner_add']}")
        mass = sw.winner_add_plain(idx, [x.double().abs() for x in blocks],
                                   c)
        for ref in (sw.winner_add_plain(idx, blocks, c), index_adds(idx)):
            for g, r, m in zip(got, ref, mass):
                d = (g - r).double().abs()
                check(bool((d <= 1e-5 * m).all()), f"winner_add bounce {b}: "
                      f"off by {float(d.max())}")
                err = max(err, float((d / m.clamp(min=1e-30)).max()))
        ms, _ = device_ms(lambda: sw.winner_add(idx, blocks, c), reps=10)
        call_ms, _ = cuda_ms(lambda: sw.winner_add(idx, blocks, c), reps=10)
        plain_ms, _ = cuda_ms(lambda: sw.winner_add_plain(idx, blocks, c),
                              reps=3)
        lib_ms, _ = device_ms(lambda: index_adds(idx), reps=3)
        bound_ms, bound_by = bound(0.0, 4 * n + 4 * k * (hits + c))
        all_ms, _ = bound(0.0, 4 * n + 4 * k * (n + c))
        rows.append({"bounce": b, "hits": hits, "ms": ms,
                     "call_ms": call_ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "bound_all_rows_ms": all_ms})
        print(f"[winner_add] bounce {b}: {n} rays, {hits} hits, {c} x {k}: "
              f"kernel {ms:.4f} ms (call {call_ms:.4f}), bound "
              f"{bound_ms:.4f} ms ({bound_by}; every row "
              f"{all_ms:.4f}), plain {plain_ms:.3f} ms, three index_add_ "
              f"{lib_ms:.3f} ms")
    step = {key: sum(r[key] for r in rows) for key in (
        "ms", "call_ms", "plain_ms", "library_ms", "bound_ms",
        "bound_all_rows_ms")}
    print(f"[winner_add] a step's {len(rows)} bounces: {step}; max error "
          f"over the |values| summed {err:.3g}")
    return {"name": "winner_add", "route": "cuda",
            "source": "cudaraytracer_tpu_torch/csrc/sweeps.cu",
            "replaces": None,
            "replaces_note": "no pallas_call: XLA's scatter, "
                             "cudaraytracer_tpu/ops/pallas_intersect.py"
                             ":1038-1043",
            "launches": 0, "max_rel_err": err, **step,
            "bound_by": "bytes",
            "ms_at": f"a step's {len(rows)} bounces of the fit cell: "
                     f"{n} rays of random_spheres {FIT_CELL}, path "
                     f"{DEPTH}, {c} spheres x K = {k}",
            "per_bounce": rows}


# ---------------------------------------------------------------------------
# The sweep kernels K3, K4, K5
# ---------------------------------------------------------------------------

def compare_hits(label: str, got, ref) -> float:
    """Kernel (t, idx[, attrs]) against plain: idx equal on every ray, t
    and attrs to PARITY_ATOL -> max abs error."""
    t, i, rt, ri = got[0], got[1], ref[0], ref[1]
    n_diff = int((i != ri).sum())
    err = float((t - rt).abs().max())
    if len(got) > 2:
        err = max(err, float((got[2] - ref[2]).abs().max()))
    hit = float((i >= 0).float().mean())
    print(f"[sweeps] {label:46s} rays {t.shape[0]:7d} hit {hit * 100:6.2f}% "
          f"idx differ {n_diff} max_abs_err {err:.3g}")
    check(n_diff == 0, f"{label}: idx differs on {n_diff} rays")
    check(err <= PARITY_ATOL, f"{label}: kernel and plain differ by {err}")
    return err


def one_bounce(scene, rays, cfg, seed: int, gen):
    """The rays after one wavefront bounce on K2 draws: (rays, the alive
    mask that bounce leaves (the lanes that go on: what the main path's
    next sweep sees), that mask randomly thinned to 70% (more dead lanes,
    the check of earlier PRs))."""
    from cudaraytracer_tpu_torch.core.rays import Rays
    from cudaraytracer_tpu_torch.ops import integrators as integ
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    from cudaraytracer_tpu_torch.ops.render import sweep_intersector
    o, d, tm = rays
    n = o.shape[0]
    draws = mk.scatter_draws(torch.empty(n, 4, device=o.device), seed, 0)
    with torch.no_grad():
        o2, d2, t2, _, _, cont, _ = integ._bounce(
            scene, cfg, sweep_intersector(cfg, coherent=True), 0, None, None,
            o, d, tm,
            torch.ones(n, 3, device=o.device),
            torch.zeros(n, 3, device=o.device),
            torch.ones(n, dtype=torch.bool, device=o.device),
            draws[:, :3], draws[:, 3])
    keep = torch.rand(n, generator=gen, device=o.device) < 0.7
    return Rays(o2, d2, t2), cont, cont & keep


def sweep_cost(n: int, tests, prim_flops: int, tables, out_floats: int,
               alive: bool) -> tuple:
    """(bound ms, bound_by) of one sweep launch over n rays that made
    ``tests`` (box, prim): rays in, (t, idx[, attrs]) out, tables read
    once."""
    n_box, n_prim = tests[:2]
    bytes_ = (n * (24 + 4 * out_floats + (1 if alive else 0))
              + sum(t.numel() * 4 for t in tables if t is not None))
    return bound(n_box * FLOP_BOX + n_prim * prim_flops, bytes_)


def sweep_instance(prim: str, cull: bool, coop: bool, attrs: bool) -> str:
    """The name of the csrc/sweeps.cu instance a launch takes (its extern
    "C" name, as ptxas -v reports it)."""
    form = "plain" if not cull else ("coop" if coop else "cull")
    return f"crt_{prim}_{form}" + ("_attrs" if attrs else "")


def sweep_counts(launch, dev, **kw) -> list:
    """The counting instance's counts (ops/sweeps.py COUNT_NAMES) of
    ``launch(counts=..., **kw)`` on device ``dev``."""
    from cudaraytracer_tpu_torch.ops import sweeps as sw
    c = torch.zeros(sw.N_COUNTS, dtype=torch.int64, device=dev)
    launch(counts=c, **kw)
    return c.tolist()


def hold_instances(label: str, launch, ref, sup) -> float:
    """Every culled instance of ``launch(sup=, coop=, counts=)`` (one and two
    box levels, one thread per ray and cooperative) against the plain
    version's ``ref``; the cooperative counting instance must count the
    per-thread one's box and prim tests -> max abs error."""
    err = 0.0
    for s_ in (None,) if sup is None else (None, sup):
        counts = []
        for coop in (False, True):
            kw = {"sup": s_, "coop": coop}
            err = max(err, compare_hits(
                f"{label}, {1 if s_ is None else 2} level(s), "
                f"{'coop' if coop else 'per-thread'}", launch(**kw), ref))
            counts.append(sweep_counts(launch, ref[0].device, **kw)[:2])
        check(counts[0] == counts[1], f"{label}: the cooperative instance "
              f"counts {counts[1]}, the per-thread one {counts[0]}")
    return err


def sliver_losses(label: str, v, nrm, o, d, quirks, t_min: float,
                  t_max: float) -> dict:
    """K4 on a sliver mesh under grazing rays: the public entry and every
    culled instance give the same (t, idx) bit for bit, the plain form the
    plain version's, and a culled ray leaves the plain version's (t, idx)
    only farther and only where that winner lies outside the margin's
    proof (ops/sweeps.py TRI_MARGIN, ``triangle_conditioned``) -> the
    counts of such winners and of the rays the cull lost."""
    from cudaraytracer_tpu_torch.ops import sweeps as sw
    v0, v1, v2 = v
    ref = sw.triangle_best_hit_plain(o, d, v0, v1, v2, nrm, t_min, t_max,
                                     quirks)
    tbl, box, sup = sw.triangle_table(v0, v1, v2, nrm)
    compare_hits(f"K4 plain form {label}", sw.launch_triangle_sweep(
        o, d, tbl, None, None, t_min, t_max, quirks), ref)
    outs = {"the public entry": sw.triangle_best_hit_raw(
        o, d, v0, v1, v2, nrm, t_min, t_max, quirks)}
    for s_ in (None, sup):
        for coop in (False, True):
            outs[f"{1 if s_ is None else 2} level(s), "
                 f"{'coop' if coop else 'per-thread'}"] = \
                sw.launch_triangle_sweep(o, d, tbl, box, None, t_min, t_max,
                                         quirks, sup=s_, coop=coop)
    t, i = outs["2 level(s), coop"]
    for k, got in outs.items():
        check(torch.equal(got[0], t) and torch.equal(got[1], i),
              f"{label}: {k} differs from the default instance")
    w = ref[1].long().clamp(min=0)
    covered = sw.triangle_conditioned(d, v1[w] - v0[w], v2[w] - v0[w])
    hit = ref[1] >= 0
    lost = (i != ref[1]) | (t != ref[0])
    n_lost, n_out = int(lost.sum()), int((hit & ~covered).sum())
    print(f"[sweeps] K4 {label}: rays {t.shape[0]} plain hits "
          f"{int(hit.sum())}, winners outside the margin's proof {n_out}, "
          f"lost to the cull {n_lost}")
    check(not bool((lost & covered & hit).any()),
          f"{label}: the cull lost a hit that the margin covers")
    check(bool((t >= ref[0]).all()), f"{label}: the cull found a nearer hit")
    return {"rays": int(t.shape[0]), "plain_hits": int(hit.sum()),
            "uncovered_winners": n_out, "lost": n_lost}


def time_sweep(label: str, launch, raw, plain, n: int, prim_flops: int,
               tables, out_floats: int, alive: bool, coop: bool,
               instance: str, sup=None) -> dict:
    """One main-path launch: ``launch(**kw)`` over prebuilt tables as the
    public entry ``raw()`` makes it (with ``sup`` when it takes the super
    level), timed on the card (``ms``, device_ms) and ``raw()`` as the call
    (``call_ms``, its table build and host time included) and on the card
    (``raw_ms``); the plain version's time; the bound from the launch's
    own counted tests (the work this design needs) and, beside it, the
    bound from the tests of the one-level per-thread counting instance on
    the same rays (``bound_one_level_ms``); the lanes' use (prim and box
    tests over 32 x warp
    steps); the other cooperation choice's time and, for a two-level
    launch, the one-level time; the instance's registers and spill.
    coop: the launch's own cooperation choice (the wrapper's default)."""
    ms, _ = device_ms(lambda: launch(sup=sup), reps=10)
    raw_ms, _ = device_ms(raw, reps=10)
    call_ms, _ = cuda_ms(raw, reps=10)
    plain_ms, _ = cuda_ms(plain, reps=1)
    other_ms, _ = device_ms(lambda: launch(sup=sup, coop=not coop), reps=10)
    dev = tables[0].device
    one_level = sweep_counts(launch, dev, sup=None, coop=False)
    own = sweep_counts(launch, dev, sup=sup, coop=coop)
    bound_ms, bound_by = sweep_cost(n, own, prim_flops, tables, out_floats,
                                    alive)
    one_level_bound_ms, _ = sweep_cost(n, one_level, prim_flops, tables,
                                       out_floats, alive)
    regs, spill = ptxas_usage(instance)
    out = {"ms": ms, "raw_ms": raw_ms, "call_ms": call_ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_one_level_ms": one_level_bound_ms,
           "tests_one_level": one_level[:2], "tests": own[:2],
           "lane_use": own[1] / (32.0 * max(own[3], 1)),
           "box_lane_use": own[0] / (32.0 * max(own[2], 1)),
           "coop": coop, f"{'per_thread' if coop else 'coop'}_ms": other_ms,
           "instance": instance, "registers": regs, "spill_bytes": spill,
           "rays": n, "at": label}
    if sup is not None:
        out["one_level_ms"] = device_ms(lambda: launch(sup=None),
                                        reps=10)[0]
    print(f"[sweeps] {label}: kernel {ms:.4f} ms (the public entry "
          f"{raw_ms:.4f} ms on the card, {call_ms:.4f} ms the call), plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}; tests "
          f"{own[:2]}), one level per thread: tests {one_level[:2]} bound "
          f"{one_level_bound_ms:.4f} ms, lanes' use {out['lane_use']:.4f} "
          f"(box {out['box_lane_use']:.4f}), "
          f"{'one thread per ray' if coop else 'cooperative'} "
          f"{other_ms:.4f} ms"
          + (f", one level {out['one_level_ms']:.4f} ms" if sup is not None
             else "") + f", {instance} {regs} registers, {spill} B spill")
    return out


def fit_shape():
    """The bench's fit shape: (width, height, samples, depth)."""
    return 512, 256, 4, 4


def sweep_scenes(dev, frames, gen) -> dict:
    """The sweeps' main-path launches: (c)'s first 2^18 camera rays on
    random_spheres (Morton order, as the wavefront sweeps it) and the same
    rays after one bounce, (d)'s middle 2^18 camera rays on the icosphere
    and the same after one bounce, and (e)'s first 2^18 camera rays on
    three_spheres and the same after one bounce; each bounce with the
    wavefront's alive mask and with that mask thinned."""
    from cudaraytracer_tpu_torch.config import RenderConfig
    from cudaraytracer_tpu_torch.core.camera import generate_pixel_rays
    from cudaraytracer_tpu_torch.models import presets
    from cudaraytracer_tpu_torch.ops import integrators as integ
    fa, fb = frames
    out = {}
    for key, f, k in (("c", fa, 0), ("d", fb, middle_chunk(fb))):
        scene = integ._morton_scene(f.scene)[0]
        cam = first_chunk(f, gen, k)
        b, alive, thin = one_bounce(scene, cam, dataclasses.replace(
            f.cfg, engine="wavefront"), 21, gen)
        out[key] = (scene, cam, b, alive, thin, k)
    w, h, spp, depth = fit_shape()
    s3, c3 = presets.three_spheres(aspect=w / h, device=dev)
    r3 = generate_pixel_rays(c3, w, h, spp, generator=gen)
    n = fa.cfg.ray_chunk
    r3 = r3._replace(origin=r3.origin[:n], direction=r3.direction[:n],
                     time=r3.time[:n])
    b, alive, thin = one_bounce(s3, r3, RenderConfig(
        width=w, height=h, samples=spp, max_depth=depth), 23, gen)
    out["e"] = (s3, r3, b, alive, thin, 0)
    return out


def phase_sweep_parity(dev, frames) -> dict:
    """K3, K5 and K4 against their plain versions, through the public
    entries and every culled instance; times and bounds of the main-path
    camera and bounce launches of each."""
    from cudaraytracer_tpu_torch.config import Quirks
    from cudaraytracer_tpu_torch.core.camera import generate_pixel_rays
    from cudaraytracer_tpu_torch.core.rays import make_rays
    from cudaraytracer_tpu_torch.models import check_scenes as cs
    from cudaraytracer_tpu_torch.models.scene import SceneBuilder
    from cudaraytracer_tpu_torch.ops import intersect as isect
    from cudaraytracer_tpu_torch.ops import sweeps as sw
    fa, fb = frames
    t_min, t_max = fa.cfg.t_min, fa.cfg.t_max
    gen = torch.Generator(device=dev).manual_seed(5)
    err = {"sphere_sweep": 0.0, "sphere_sweep_attrs": 0.0,
           "triangle_sweep": 0.0}

    def note(name, e):
        err[name] = max(err[name], e)

    def spheres(label, scene, o, d, alive=None):
        sp = scene.spheres
        attr = isect.sphere_attr_table(scene)
        ref = sw.sphere_best_hit_plain(o, d, sp.center, sp.radius, t_min,
                                       t_max, alive)
        refa = sw.sphere_best_hit_attrs_plain(o, d, sp.center, sp.radius,
                                              attr, t_min, t_max, alive)
        for cull in (True, False):
            form = "culled" if cull else "plain"
            got = sw.sphere_best_hit_raw(o, d, sp.center, sp.radius, t_min,
                                         t_max, cull, alive)
            note("sphere_sweep", compare_hits(f"K3 {form} {label}", got, ref))
            gota = sw.sphere_best_hit_attrs_raw(o, d, sp.center, sp.radius,
                                                attr, t_min, t_max, cull,
                                                alive)
            note("sphere_sweep_attrs", compare_hits(f"K5 {form} {label}",
                                                    gota, refa))
            check(torch.equal(gota[1], got[1]), f"{label}: K5 and K3 differ")
            check(tuple(gota[2].shape) == (o.shape[0], attr.shape[0]),
                  f"{label}: K5's attributes of shape "
                  f"{tuple(gota[2].shape)}")
            if alive is not None:
                check(bool((got[1][~alive] == -1).all()
                           and (gota[1][~alive] == -1).all()),
                      f"{label}: a dead lane hit")
                check(bool((gota[2][~alive] == attr[:, 0]).all()),
                      f"{label}: a dead lane's attributes are not prim 0's")
        tbl, box, sup = sw.sphere_table(sp.center, sp.radius)
        rows = sw.attr_rows(attr)
        note("sphere_sweep", hold_instances(
            f"K3 {label}", lambda **kw: sw.launch_sphere_sweep(
                o, d, tbl, box, alive, None, t_min, t_max, **kw), ref, sup))
        note("sphere_sweep_attrs", hold_instances(
            f"K5 {label}", lambda **kw: sw.launch_sphere_sweep(
                o, d, tbl, box, alive, rows, t_min, t_max, **kw), refa, sup))
        return got

    def triangles(label, scene, o, d, quirks, cull, alive=None, v=None):
        tr = scene.triangles
        v0, v1, v2, nrm = v or (tr.v0, tr.v1, tr.v2, tr.normal)
        ref = sw.triangle_best_hit_plain(o, d, v0, v1, v2, nrm, t_min,
                                         t_max, quirks, alive)
        got = sw.triangle_best_hit_raw(o, d, v0, v1, v2, nrm, t_min, t_max,
                                       quirks, cull, alive)
        note("triangle_sweep", compare_hits(
            f"K4 {'culled' if cull else 'plain'} {label}", got, ref))
        if cull:
            tbl, box, sup = sw.triangle_table(v0, v1, v2, nrm)
            note("triangle_sweep", hold_instances(
                f"K4 {label}", lambda **kw: sw.launch_triangle_sweep(
                    o, d, tbl, box, alive, t_min, t_max, quirks, **kw), ref,
                sup))
        return got

    scenes = sweep_scenes(dev, frames, gen)
    n_check = fa.cfg.ray_chunk        # 2^18 rays, a main-path launch
    # (c)'s first launch: camera rays, then the same rays after one bounce
    sa, cam_a, bounce_a, alive_a, thin_a, _ = scenes["c"]
    spheres("random_spheres camera", sa, cam_a.origin, cam_a.direction)
    for what, al in (("wavefront's alive", alive_a), ("thinned", thin_a)):
        spheres(f"random_spheres bounce, {what}", sa, bounce_a.origin,
                bounce_a.direction, al)
    # the icosphere frame: K4 culled under both quirk profiles, on its
    # first launch and on its middle one (the first sees only the ground),
    # then on the middle launch's rays after one bounce
    sb, cam_b, bounce_b, alive_b, thin_b, mid = scenes["d"]
    for k in (0, mid):
        cam = cam_b if k == mid else first_chunk(fb, gen, k)
        for q in ("reference", "fixed"):
            triangles(f"icosphere launch {k} camera {q}", sb, cam.origin,
                      cam.direction, getattr(Quirks, q)(), True)
    for q in ("reference", "fixed"):
        for what, al in (("wavefront's alive", alive_b), ("thinned",
                                                          thin_b)):
            triangles(f"icosphere bounce, {what}, {q}", sb, bounce_b.origin,
                      bounce_b.direction, getattr(Quirks, q)(), True, al)
    # axis-parallel rays whose origins lie on chunk and super planes (the
    # slab's NaN): the two levels must keep every hit of the plain version;
    # and on the planes of the vertices' own chunk boxes (rays through
    # shared vertices and edges, which the widened boxes must keep)
    tr = sb.triangles
    _, tbox, tsup = sw.triangle_table(tr.v0, tr.v1, tr.v2, tr.normal)
    vbox = sw.group_boxes(torch.minimum(torch.minimum(tr.v0, tr.v1), tr.v2),
                          torch.maximum(torch.maximum(tr.v0, tr.v1), tr.v2),
                          sw.PRIM_CHUNK, sw.PRIM_CHUNK)
    for what, bx in (("chunk", tbox), ("super", tsup), ("vertex", vbox)):
        po, pd = cs.plane_rays(bx.cpu().numpy(),
                               tr.v0.mean(0).cpu().numpy(), n_check, 3)
        rays_p = make_rays(po, pd, device=dev)
        for q in ("reference", "fixed"):
            triangles(f"icosphere, rays on {what} planes, {q}", sb,
                      rays_p.origin, rays_p.direction, getattr(Quirks, q)(),
                      True)
    # a duplicate of triangle 37 (super 0) appended in super 20: the first
    # copy wins every tie
    k = 37
    vd = tuple(torch.cat([x, x[k:k + 1]]) for x in (tr.v0, tr.v1, tr.v2,
                                                    tr.normal))
    cen = (vd[0][k] + vd[1][k] + vd[2][k]) / 3
    nrm = torch.linalg.cross(vd[1][k] - vd[0][k], vd[2][k] - vd[0][k])
    o_dup = (cen + 0.5 * nrm / nrm.norm()).expand(n_check, 3).contiguous()
    d_dup = (cen - o_dup) + 0.002 * torch.randn(
        n_check, 3, generator=gen, device=dev)
    got = triangles("a duplicate in another super", sb, o_dup, d_dup,
                    Quirks.fixed(), True, v=vd)
    check(bool((got[1] == k).any())
          and not bool((got[1] == tr.v0.shape[0]).any()),
          "a duplicate triangle in another super won")
    # a cylinder of slivers under grazing rays, moderate and extreme (the
    # triangle margin's limit: only winners outside its proof may be lost)
    sv = [torch.as_tensor(x, device=dev) for x in cs.sliver_cylinder()]
    order = sw.morton_argsort((sv[0] + sv[1] + sv[2]) / 3)
    sv = [x[order].contiguous() for x in sv]
    snrm = torch.linalg.cross(sv[1] - sv[0], sv[2] - sv[0])
    slivers = {}
    for band, lo_g, hi_g in (("moderate", 1e-3, 1e-1),
                             ("extreme", 1e-6, 1e-3)):
        go, gd = (torch.as_tensor(x, device=dev) for x in cs.grazing_rays(
            n_check, lo_g, hi_g, seed=7))
        for q in ("reference", "fixed"):
            slivers[f"{band}_{q}"] = sliver_losses(
                f"slivers, {band} grazing, {q}", sv, snrm, go, gd,
                getattr(Quirks, q)(), t_min, t_max)
    # more than SPH_SUPER_MIN spheres: the sphere sweeps' two levels
    field = cs.fill_sphere_field(SceneBuilder()).build(dev)
    fo, fd = cs.sphere_field_rays(n_check)
    rays_f = make_rays(fo, fd, device=dev)
    spheres("sphere field (9,216 spheres)", field, rays_f.origin,
            rays_f.direction)
    # fewer than 128 triangles: the plain form (and the culled one)
    mixed, cam_m = cs.mixed_scene(dev)
    rays_m = generate_pixel_rays(cam_m, 512, 256, 2, generator=gen)
    for q in ("reference", "fixed"):
        for cull in (False, True):
            triangles(f"mixed 5 triangles {q}", mixed, rays_m.origin,
                      rays_m.direction, getattr(Quirks, q)(), cull)
    # duplicated prims: the copies (spheres 2 and 4, triangle 1) never win
    dup, cam_d = cs.duplicate_scene(dev)
    rays_d = generate_pixel_rays(cam_d, 256, 128, 8, generator=gen)
    got = spheres("duplicates", dup, rays_d.origin, rays_d.direction)
    check(bool((got[1] == 1).any() and (got[1] == 3).any()
               and not ((got[1] == 2) | (got[1] == 4)).any()),
          "duplicates: a sphere's copy won")
    for cull in (False, True):
        got = triangles("duplicates", dup, rays_d.origin, rays_d.direction,
                        Quirks.fixed(), cull)
        check(bool((got[1] == 0).any() and not (got[1] == 1).any()),
              "duplicates: the triangle's copy won")
    # exact ties: sphere B (id 22) over the triangle at t = 4, sphere A
    # (id 0) over its copy A' (id 21, another chunk) at t = 4.5
    tie = cs.fill_tie_scene(SceneBuilder()).build(dev)
    rays_t = make_rays(cs.TIE_ORIGINS, cs.TIE_DIRECTIONS, device=dev)
    got = spheres("ties", tie, rays_t.origin, rays_t.direction)
    check(got[1].tolist() == [22, 0] and got[0].tolist() == [4.0, 4.5],
          f"ties: sphere sweep gave {got}")
    for cull in (False, True):
        got = triangles("ties", tie, rays_t.origin, rays_t.direction,
                        Quirks.fixed(), cull)
        check(got[1].tolist() == [0, -1], f"ties: triangle sweep gave {got}")
    for policy in ("all", "off"):
        hits = isect.intersect_scene_sweeps(tie, rays_t, t_min, t_max,
                                            Quirks.fixed(),
                                            sphere_cull=policy)
        check(hits.prim.tolist() == [22, 0],
              f"ties: intersect_scene_sweeps gave {hits.prim.tolist()}")
    print(f"[sweeps] max abs error {err}")

    # ---- times and bounds of the main-path launches of each ----
    out = {"sphere_sweep": {}, "sphere_sweep_attrs": {},
           "triangle_sweep": {}}
    fixed = Quirks.fixed()
    for key, name in (("c", "sphere_sweep"), ("e", "sphere_sweep_attrs"),
                      ("d", "triangle_sweep")):
        scene, cam, bounce, alive, thin, k = scenes[key]
        n = cam.origin.shape[0]
        tri = name == "triangle_sweep"
        if tri:
            tr = scene.triangles
            tabs = sw.triangle_table(tr.v0, tr.v1, tr.v2, tr.normal)
            tbl, box, sup = tabs
        else:
            sp = scene.spheres
            tbl, box, sup = sw.sphere_table(sp.center, sp.radius)
            attr = isect.sphere_attr_table(scene)
            rows = sw.attr_rows(attr) if name == "sphere_sweep_attrs" else None
        for kind, o, d, al in (("camera", cam.origin, cam.direction, None),
                               ("bounce", bounce.origin, bounce.direction,
                                alive),
                               ("bounce_thinned", bounce.origin,
                                bounce.direction, thin)):
            if tri:
                def launch(o=o, d=d, al=al, **kw):
                    return sw.launch_triangle_sweep(o, d, tbl, box, al, t_min,
                                                    t_max, fixed, **kw)

                def raw(o=o, d=d, al=al):
                    return sw.triangle_best_hit_raw(
                        o, d, tr.v0, tr.v1, tr.v2, tr.normal, t_min, t_max,
                        fixed, alive=al)

                def plain(o=o, d=d, al=al):
                    return sw.triangle_best_hit_plain(
                        o, d, tr.v0, tr.v1, tr.v2, tr.normal, t_min, t_max,
                        fixed, al)
                tables, prim_flops, outs = (tbl, box), FLOP_TRI, 2
            elif rows is None:
                def launch(o=o, d=d, al=al, **kw):
                    return sw.launch_sphere_sweep(o, d, tbl, box, al, None,
                                                  t_min, t_max, **kw)

                def raw(o=o, d=d, al=al):
                    return sw.sphere_best_hit_raw(o, d, sp.center, sp.radius,
                                                  t_min, t_max, True, al)

                def plain(o=o, d=d, al=al):
                    return sw.sphere_best_hit_plain(o, d, sp.center,
                                                    sp.radius, t_min, t_max,
                                                    al)
                tables, prim_flops, outs = (tbl, box), FLOP_SPHERE, 2
            else:
                def launch(o=o, d=d, al=al, **kw):
                    return sw.launch_sphere_sweep(o, d, tbl, box, al, rows,
                                                  t_min, t_max, **kw)

                def raw(o=o, d=d, al=al):
                    return sw.sphere_best_hit_attrs_raw(
                        o, d, sp.center, sp.radius, attr, t_min, t_max, True,
                        al)

                def plain(o=o, d=d, al=al):
                    return sw.sphere_best_hit_attrs_plain(
                        o, d, sp.center, sp.radius, attr, t_min, t_max, al)
                tables, prim_flops, outs = ((tbl, box, rows), FLOP_SPHERE,
                                            2 + N_ATTRS)
            note(name, compare_hits(f"{name} {key} {kind} (timed launch)",
                                    launch(sup=sup), plain()))
            label = (f"{name}, ({key})'s launch {k}, {kind}: {n} rays"
                     + ("" if al is None else
                        f", {int(al.sum())} alive"))
            coop = tri or al is not None
            out[name][kind] = time_sweep(
                label, launch, raw, plain, n, prim_flops, tables, outs,
                al is not None, coop, sweep_instance(
                    "tri" if tri else "sph", True, coop,
                    rows is not None and not tri), sup)
    # K5 on (c)'s 484 spheres (its camera launch), beside (e)'s 4
    scene, cam, _, _, _, k = scenes["c"]
    sp = scene.spheres
    tbl, box, sup = sw.sphere_table(sp.center, sp.radius)
    attr = isect.sphere_attr_table(scene)
    rows = sw.attr_rows(attr)
    o, d = cam.origin, cam.direction
    out["sphere_sweep_attrs"]["random_spheres"] = time_sweep(
        f"sphere_sweep_attrs, (c)'s launch {k}, camera: {o.shape[0]} rays",
        lambda **kw: sw.launch_sphere_sweep(o, d, tbl, box, None, rows,
                                            t_min, t_max, **kw),
        lambda: sw.sphere_best_hit_attrs_raw(o, d, sp.center, sp.radius,
                                             attr, t_min, t_max, True),
        lambda: sw.sphere_best_hit_attrs_plain(o, d, sp.center, sp.radius,
                                               attr, t_min, t_max),
        o.shape[0], FLOP_SPHERE, (tbl, box, rows), 2 + N_ATTRS, False, False,
        sweep_instance("sph", True, False, True), sup)
    out["triangle_sweep"]["slivers"] = slivers
    for k, v in out.items():
        v["max_abs_err"] = err[k]
    return out


def phase_cross_engine(dev, launches):
    """The wavefront (sweep pair, rects and TRS prims folded in by tensor
    ops) and the fused engine on the same 2^18 rays and injected stream,
    for each (frame, launch index): count the rays that differ by more
    than 1e-3."""
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    from cudaraytracer_tpu_torch.ops.integrators import (
        integrate, stream_from_generator)
    from cudaraytracer_tpu_torch.ops.render import sweep_intersector_pair
    gen = torch.Generator(device=dev).manual_seed(9)
    for f, k in launches:
        rays = first_chunk(f, gen, k)
        n = rays.origin.shape[0]
        stream = stream_from_generator(gen, n, f.cfg.max_depth, dev)
        wcfg = dataclasses.replace(f.cfg, engine="wavefront")
        with torch.no_grad():
            wave = integrate(f.scene, rays, wcfg, samples=stream,
                             intersect_fn=sweep_intersector_pair(wcfg))
        mega = mk.trace_path_mega(f.scene, rays, f.cfg, tables=f.tables,
                                  samples=stream)
        diff = (wave - mega).abs().amax(dim=1)
        n_diff = int((diff > 1e-3).sum())
        limit = max(2, n // 200)
        print(f"[cross] {f.name} launch {k}: wavefront vs mega on {n} rays, "
              f"{n_diff} differ by >1e-3 ({n_diff / n:.4%}; limit {limit}), "
              f"max {float(diff.max()):.3g}")
        check(bool(torch.isfinite(wave).all()), f"{f.name}: non-finite")
        check(n_diff <= limit,
              f"{f.name}: wavefront and mega differ on {n_diff} rays")


def render_frame(dev, f: Frame, gen):
    """Warm-up + min of 5 frames through render_image (the frame waits on
    the host's launches, whose speed swings between runs); checks the
    image."""
    from cudaraytracer_tpu_torch.ops.render import render_image
    from cudaraytracer_tpu_torch.utils.image import write_png
    cfg = f.cfg
    torch.cuda.reset_peak_memory_stats(dev)
    ms, img = cuda_ms(lambda: render_image(f.scene, f.camera, cfg,
                                           generator=gen, tables=f.tables),
                      reps=5)
    peak = torch.cuda.max_memory_allocated(dev)
    rays = cfg.width * cfg.height * cfg.samples
    mean = img.reshape(-1, 3).mean(dim=0).tolist()
    print(f"[main] {f.name}: {cfg.width}x{cfg.height}x{cfg.samples} depth "
          f"{cfg.max_depth}: {ms / 1e3:.4f} s/frame, "
          f"{rays / (ms / 1e3) / 1e6:.1f} Mrays/s, peak "
          f"{peak / 2 ** 30:.2f} GiB, channel means "
          f"{[round(x, 4) for x in mean]}")
    check(bool(torch.isfinite(img).all()), f"{f.name}: non-finite pixels")
    check(all(0.05 < x < 1.0 for x in mean),
          f"{f.name}: channel means {mean}")
    write_png(os.path.join(OUT_DIR, f"{f.name}.png"), img)
    return ms, img, peak


def render_wavefront(dev, f: Frame, gen):
    """(c) and (d): the frame on the wavefront through sweep_intersector
    (K2 draws): warm-up + min of 2 frames; checks the image."""
    from cudaraytracer_tpu_torch.ops.render import (render_image,
                                                    sweep_intersector)
    from cudaraytracer_tpu_torch.utils.image import write_png
    cfg = dataclasses.replace(f.cfg, engine="wavefront")
    isect = sweep_intersector(cfg)
    torch.cuda.reset_peak_memory_stats(dev)
    with torch.no_grad():
        ms, img = cuda_ms(lambda: render_image(f.scene, f.camera, cfg,
                                               generator=gen,
                                               intersect_fn=isect), reps=2)
    peak = torch.cuda.max_memory_allocated(dev)
    rays = cfg.width * cfg.height * cfg.samples
    mean = img.reshape(-1, 3).mean(dim=0).tolist()
    print(f"[main] {f.name} wavefront: {cfg.width}x{cfg.height}x"
          f"{cfg.samples} depth {cfg.max_depth}: {ms / 1e3:.4f} s/frame, "
          f"{rays / (ms / 1e3) / 1e6:.1f} Mrays/s, peak "
          f"{peak / 2 ** 30:.2f} GiB, channel means "
          f"{[round(x, 4) for x in mean]}")
    check(bool(torch.isfinite(img).all()), f"{f.name}: non-finite pixels")
    check(all(0.05 < x < 1.0 for x in mean),
          f"{f.name} wavefront: channel means {mean}")
    write_png(os.path.join(OUT_DIR, f"{f.name}_wavefront.png"), img)
    return ms, img, peak


def fit_scene(name: str, dev, engine: str = "wavefront"):
    """(scene, camera, rays, target, start params) of a fit at the bench's
    shape, the target rendered from the true scene on the same rays and
    draws (seed 1) that every step uses."""
    from cudaraytracer_tpu_torch.config import RenderConfig
    from cudaraytracer_tpu_torch.core.camera import generate_pixel_rays
    from cudaraytracer_tpu_torch.models import presets
    from cudaraytracer_tpu_torch.ops.render import (render_pixels,
                                                    sweep_intersector_pair)
    from cudaraytracer_tpu_torch.parallel.train import fit_config
    w, h, spp, depth = fit_shape()
    scene, cam = getattr(presets, name)(aspect=w / h, device=dev)
    cfg = RenderConfig(width=w, height=h, samples=spp, max_depth=depth,
                       gamma=False, wavefront_kernel_attrs=True,
                       engine=engine)
    rays = generate_pixel_rays(cam, w, h, spp, generator=torch.Generator(
        device=dev).manual_seed(0))
    lcfg = fit_config(cfg)
    isect = sweep_intersector_pair(lcfg) if engine == "wavefront" else None
    with torch.no_grad():
        target = render_pixels(scene, cam, lcfg, torch.arange(w * h,
                                                              device=dev),
                               torch.Generator(device=dev).manual_seed(1),
                               rays=rays, intersect_fn=isect)
    params = {"albedo": (scene.textures.color0 * 0.6 + 0.1).requires_grad_(),
              "centers": (scene.spheres.center + 0.05).requires_grad_()}
    return scene, cam, cfg, rays, target, params


def run_fit(dev, engine: str = "wavefront") -> dict:
    """(e), or (f) under engine='mega_diff': a warm-up step, then 5 timed
    SGD steps on three_spheres at the bench's shape, then one step on
    random_spheres."""
    from cudaraytracer_tpu_torch.parallel.train import make_fit_step
    tag = f"[fit {engine}]"
    scene, cam, cfg, rays, target, p0 = fit_scene("three_spheres", dev,
                                                  engine)
    step = make_fit_step(scene, cam, cfg, lr=0.5)

    def run(p):
        return step(p, target, torch.Generator(device=dev).manual_seed(1),
                    rays=rays)

    run(p0)                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    params, losses, times = p0, [], []
    for i in range(5):
        t0 = time.perf_counter()
        loss, params = run(params)
        losses.append(float(loss))            # waits for the device
        times.append(time.perf_counter() - t0)
        print(f"{tag} three_spheres step {i}: loss {losses[-1]:.6e}, "
              f"{times[-1]:.4f} s")
    peak = torch.cuda.max_memory_allocated(dev)
    moved = max(float((params[k] - p0[k]).detach().abs().max())
                for k in p0)
    print(f"{tag} three_spheres {'x'.join(map(str, fit_shape()[:3]))} depth "
          f"{fit_shape()[3]}: {min(times):.4f} s/step (min of 5), peak "
          f"{peak / 2 ** 30:.2f} GiB, params moved by up to {moved:.3e}")
    check(all(math.isfinite(x) for x in losses), f"fit losses {losses}")
    check(losses[-1] < losses[0], f"fit loss did not fall: {losses}")
    check(moved > 0.0, "the fit did not move the parameters")
    scene, cam, cfg, rays, target, p = fit_scene("random_spheres", dev,
                                                 engine)
    check(scene.n_spheres == 484, "random_spheres size")
    step = make_fit_step(scene, cam, cfg, lr=0.5)
    t0 = time.perf_counter()
    loss, p1 = step(p, target, torch.Generator(device=dev).manual_seed(1),
                    rays=rays)
    loss = float(loss)
    dt = time.perf_counter() - t0
    print(f"{tag} random_spheres one step (484 Morton-ordered "
          f"spheres): loss {loss:.6e}, {dt:.4f} s (first call)")
    check(math.isfinite(loss) and loss > 0.0, f"random_spheres loss {loss}")
    check(all(bool(torch.isfinite(v).all()) for v in p1.values()),
          "random_spheres fit step: non-finite params")
    return {"s_per_step": min(times), "losses": losses,
            "peak_gib": peak / 2 ** 30, "random_spheres_step_s": dt}


def fit_grad_parity(dev, engine: str = "wavefront",
                    name: str = "three_spheres") -> tuple:
    """The fit's first-step gradients on the card against the plain CPU run
    on the same injected rays and stream, at 64x32x2 (the preset ``name``,
    depth 4, no gamma) -> (the largest relative difference, the card's
    gradients)."""
    from cudaraytracer_tpu_torch.config import RenderConfig
    from cudaraytracer_tpu_torch.core.camera import generate_pixel_rays
    from cudaraytracer_tpu_torch.core.rays import Rays
    from cudaraytracer_tpu_torch.models import presets
    from cudaraytracer_tpu_torch.ops.integrators import (
        SampleStream, stream_from_generator)
    from cudaraytracer_tpu_torch.ops.render import (render_pixels,
                                                    sweep_intersector_pair)
    from cudaraytracer_tpu_torch.parallel.train import (fit_config,
                                                        value_and_grad)
    w, h, spp, depth = 64, 32, 2, 4
    cfg = fit_config(RenderConfig(width=w, height=h, samples=spp,
                                  max_depth=depth, gamma=False,
                                  engine=engine))
    gen = torch.Generator().manual_seed(4)
    _, cam_cpu = getattr(presets, name)(aspect=2.0, device="cpu")
    rays = generate_pixel_rays(cam_cpu, w, h, spp, generator=gen)
    stream = stream_from_generator(gen, w * h * spp, depth, "cpu")
    out = {}
    for device in ("cpu", dev):
        scene, cam = getattr(presets, name)(aspect=2.0, device=device)
        r = Rays(*(x.to(device) for x in rays))
        st = SampleStream(stream.ball.to(device), stream.prob.to(device))
        pix = torch.arange(w * h, device=device)
        isect = sweep_intersector_pair(cfg) if engine == "wavefront" else None
        with torch.no_grad():
            target = render_pixels(scene, cam, cfg, pix, rays=r, samples=st,
                                   intersect_fn=isect)
        params = {
            "albedo": (scene.textures.color0 * 0.6 + 0.1).requires_grad_(),
            "centers": (scene.spheres.center + 0.05).requires_grad_()}
        loss, grads = value_and_grad(scene, params, cam, cfg, pix, target,
                                     intersect_fn=isect, rays=r, samples=st)
        out[str(device)] = (float(loss), {k: g.cpu() for k, g in
                                          grads.items()})
    (l_cpu, g_cpu), (l_dev, g_dev) = out["cpu"], out[str(dev)]
    worst = 0.0
    for k in g_cpu:
        scale = float(g_cpu[k].abs().max())
        rel = float((g_dev[k] - g_cpu[k]).abs().max()) / scale
        worst = max(worst, rel)
        print(f"[fit {engine}] {name} first-step grad {k}: card vs CPU max "
              f"rel {rel:.3g} (max |g| {scale:.3g})")
        check(scale > 0.0, f"zero gradient on {k}")
    print(f"[fit {engine}] {name} 64x32x2 loss card {l_dev:.8e} cpu "
          f"{l_cpu:.8e}")
    check(abs(l_dev - l_cpu) <= 1e-5 * abs(l_cpu), "fit loss card vs CPU")
    check(worst <= GRAD_RTOL, f"fit gradients card vs CPU differ by {worst}")
    return worst, g_dev


def frame_launch(dev, f: Frame, gen, reps: int = 3) -> tuple:
    """(min ms over reps, rays): the kernel alone over a whole frame's rays
    in one launch, in-kernel draws."""
    from cudaraytracer_tpu_torch.core.camera import generate_pixel_rays
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    from cudaraytracer_tpu_torch.ops.render import swizzled_pixels
    c = f.cfg
    pix = swizzled_pixels(c.width, c.height, device=dev)
    rays = generate_pixel_rays(f.camera, c.width, c.height, c.samples, pix,
                               generator=gen)
    ms, _ = cuda_ms(lambda: mk.trace_path_mega(f.scene, rays, c,
                                               tables=f.tables, seed=11),
                    reps=reps)
    return ms, rays


def frame_against_per_thread(dev, f: Frame, gen) -> dict:
    """The kernel alone over a whole frame's rays in one launch, the
    cooperative sweep against one thread per ray (min of 3 each), equal
    radiance."""
    ms, rays = frame_launch(dev, f, gen)
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    got = mk.trace_path_mega(f.scene, rays, f.cfg, tables=f.tables, seed=11)
    pt = per_thread_ms(f, rays, f.cfg, 11, got)
    print(f"[coop] {f.name} frame-sized ({rays.origin.shape[0]} rays): "
          f"cooperative {ms:.3f} ms, one thread per ray {pt:.3f} ms")
    return {"coop_ms": ms, "per_thread_ms": pt}


def kernel_at_frame_shape(dev, f: Frame, gen):
    """The kernel alone over a whole frame's rays in one launch, and the
    tests these rays need (one extra counting launch)."""
    c = f.cfg
    ms, rays = frame_launch(dev, f, gen)
    n = rays.origin.shape[0]
    tests = count_tests(f.tables, rays, c, 11)
    bound, bound_by = launch_bound(f.tables, n, tests, cfg=c,
                                   draws=c.integrator == "path")
    out = {"ms": ms, "bound_ms": bound, "bound_by": bound_by,
           "tests": tests, "rays": n}
    if c.integrator == "path" and f.tables.tri_seg.shape[0] == 0:
        # a launch on mega_path (resident tables)
        out["grid_blocks"] = path_instance_of(f.tables, c, n)["grid_blocks"]
    return out


# ---------------------------------------------------------------------------
# Kernel modes K8 (rects, runtime-TRS prims) and K7 (winners)
# ---------------------------------------------------------------------------

TRS_FIELD = 1100        # rects, TRS spheres and TRS triangles each in (i)


def xform_frames(dev) -> list:
    """(h) light_box 1280x720x16, path depth 8, reference quirks; the TRS
    showcase at the same shape under fixed quirks; (i) 1,100 each of
    rects, TRS spheres and TRS triangles, 640x360x4, depth 4, fixed
    quirks.  All fused, Morton tables."""
    from cudaraytracer_tpu_torch.config import Quirks, RenderConfig
    from cudaraytracer_tpu_torch.models import check_scenes as cs
    from cudaraytracer_tpu_torch.models import presets
    from cudaraytracer_tpu_torch.ops.megakernel import morton_tables
    cfg_h = RenderConfig(width=1280, height=720, samples=16,
                         max_depth=DEPTH, engine="mega")
    sh, ch = presets.light_box(1280 / 720, device=dev)
    ss, cs_ = cs.trs_showcase_scene(1280 / 720, device=dev)
    si, ci = cs.trs_field_scene(TRS_FIELD, 640 / 360, device=dev)
    check(min(si.n_rects, si.n_t_spheres, si.n_t_triangles) > 1024,
          "the TRS field is above the JAX engine's per-class cap")
    cfg_i = RenderConfig(width=640, height=360, samples=4, max_depth=4,
                         quirks=Quirks.fixed(), engine="mega")
    return [Frame("light_box", sh, ch, cfg_h, morton_tables(sh)),
            Frame("trs_showcase", ss, cs_,
                  dataclasses.replace(cfg_h, quirks=Quirks.fixed()),
                  morton_tables(ss)),
            Frame("trs_field", si, ci, cfg_i, morton_tables(si))]


def compare_ids(label: str, got: torch.Tensor, ref: torch.Tensor) -> None:
    n_diff = int((got != ref).sum())
    hit = float((got >= 0).float().mean())
    print(f"[winners] {label:40s} entries {got.numel():8d} hit "
          f"{hit * 100:6.2f}% differ {n_diff}")
    check(n_diff == 0, f"{label}: winners differ on {n_diff} entries")


def phase_xform_parity(dev, xframes) -> dict:
    """K8 against its plain version: one full 2^18-ray launch of light_box
    and of the showcase, 2^16 rays of the TRS field; the three integrators
    on an injected stream, the path on in-kernel draws, with and without
    winners.  Times and bounds of each path launch."""
    from cudaraytracer_tpu_torch.core.rays import Rays
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    from cudaraytracer_tpu_torch.ops.integrators import stream_from_generator
    gen = torch.Generator(device=dev).manual_seed(11)
    out = {"max_abs_err": 0.0}
    for f in xframes:
        rays = first_chunk(f, gen)
        if f.name == "trs_field":
            rays = Rays(*(x[:1 << 16] for x in rays))
        n = rays.origin.shape[0]
        depth = f.cfg.max_depth
        stream = stream_from_generator(gen, n, depth, dev)
        st = mk.stream_tensor(stream, n, depth + 1)
        for integrator in INTEGRATORS:
            cfg = dataclasses.replace(f.cfg, integrator=integrator)
            got = mk.trace_path_mega(f.scene, rays, cfg, tables=f.tables,
                                     samples=stream)
            ref = mk.trace_path_mega_plain(f.tables, rays, cfg, st)
            out["max_abs_err"] = max(out["max_abs_err"], compare(
                f"K8 {f.name} {integrator} injected", got, ref))
        seed = mk.draw_seed(gen)
        ms, got = device_ms(lambda: mk.trace_path_mega(
            f.scene, rays, f.cfg, tables=f.tables, seed=seed))
        inst = path_instance_of(f.tables, f.cfg, n)
        call_ms, _ = cuda_ms(lambda: mk.trace_path_mega(
            f.scene, rays, f.cfg, tables=f.tables, seed=seed))
        plain_ms, (ref, wref) = cuda_ms(lambda: mk.trace_path_mega_plain(
            f.tables, rays, f.cfg, None, seed, True), reps=1, warmup=0)
        out["max_abs_err"] = max(out["max_abs_err"], compare(
            f"K8 {f.name} path in-kernel draws", got, ref))
        got_w, win = mk.trace_path_mega(f.scene, rays, f.cfg,
                                        tables=f.tables, seed=seed,
                                        want_winners=True)
        compare_ids(f"K7+K8 {f.name}", win, wref)
        check(torch.equal(got_w, got), f"{f.name}: recording changed the "
              "radiance")
        tests = count_tests(f.tables, rays, f.cfg, seed)
        b, by = launch_bound(f.tables, n, tests, draws=True)
        print(f"[K8] {f.name} path launch of {n} rays: kernel {ms:.4f} ms "
              f"(the call {call_ms:.4f} ms), "
              f"plain (with winners) {plain_ms:.3f} ms, bound {b:.4f} ms "
              f"({by}), lanes' use {lane_use(tests):.4f}, instance {inst}, "
              f"tests {tests}")
        print_schedule_model(f"K8 {f.name} path launch", f.scene, win)
        out[f.name] = {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                       "bound_ms": b, "bound_by": by, **inst,
                       "tests": tests, "rays": n}
    out["trs_field_2_18"] = xform_field_launch(dev, xframes[2], gen)
    return out


def brute_xform_tests(tables, tests: dict) -> dict:
    """``tests`` as the brute-force walk would make them: every rect / TRS
    row at every bounce, no chunk test."""
    out = dict(tests, xbox=0)
    for k in ("rect", "tsph", "ttri"):
        out[k] = tests["bounce"] * getattr(tables, k).shape[0]
    return out


def xform_field_launch(dev, f: Frame, gen) -> dict:
    """K8 on (i)'s first launch, 2^18 rays, in-kernel draws: the card's time
    and the call's, the tests the counting instance made (chunk boxes,
    rows of each class), the lanes' use, the bound from those counted tests
    and the brute-force walk's bound beside it, the instance's registers
    and spill.  (Parity runs at 2^16 rays of the same frame.)"""
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    rays = first_chunk(f, gen)
    n = rays.origin.shape[0]
    seed = mk.draw_seed(gen)

    def call():
        return mk.trace_path_mega(f.scene, rays, f.cfg, tables=f.tables,
                                  seed=seed)

    ms, _ = device_ms(call)
    call_ms, _ = cuda_ms(call)
    inst = path_instance_of(f.tables, f.cfg, n)
    tests = count_tests(f.tables, rays, f.cfg, seed)
    b, by = launch_bound(f.tables, n, tests, draws=True)
    bb, _ = launch_bound(f.tables, n, brute_xform_tests(f.tables, tests),
                         draws=True)
    per = {k: tests[k] / tests["bounce"] for k in ("xbox", "rect", "tsph",
                                                   "ttri") if k in tests}
    print(f"[K8] {f.name} path launch of {n} rays: kernel {ms:.4f} ms (the "
          f"call {call_ms:.4f} ms), bound {b:.4f} ms ({by}; the brute-force "
          f"walk's {bb:.4f} ms), tests a bounce {per}, lanes' use "
          f"{lane_use(tests):.4f}, instance {inst}")
    return {"ms": ms, "call_ms": call_ms, "bound_ms": b, "bound_by": by,
            "bound_brute_ms": bb, "tests_per_bounce": per,
            "lane_use": lane_use(tests), **inst, "tests": tests, "rays": n}


def phase_xform_edges(dev, fi: Frame) -> dict:
    """K8's culled walk against the plain version where its cull is
    tightest: ``xform_edge_rays`` (rect edges, TRS sphere tangents, TRS
    triangle vertices, axis-parallel) and camera rays, 2^14 each, on (i)'s
    rows and on a TRS field of 40 rows a class each copied once (the
    copies walked first, in earlier chunks: exact ties across chunks in
    reverse row order, which the lowest row must win), both quirk
    profiles, the three integrators on an injected stream and the path on
    in-kernel draws with its winners (K7) equal; the copied field's frame
    equal under the Morton order and the copies-first order."""
    from cudaraytracer_tpu_torch.config import Quirks
    from cudaraytracer_tpu_torch.core.rays import Rays
    from cudaraytracer_tpu_torch.models import check_scenes as cs
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    from cudaraytracer_tpu_torch.ops.integrators import stream_from_generator
    gen = torch.Generator(device=dev).manual_seed(17)
    n = 1 << 14
    k = 40
    sd, cam = cs.trs_duplicates_scene(k, 640 / 360, device=dev)
    td = mk.build_mega_tables(sd, xform_orders=cs.duplicate_orders(k))
    check(td.rect_box.shape[0] > 1, "the copied field walks in chunks")
    fd = fi._replace(name="trs_copies", scene=sd, camera=cam, tables=td)
    out = {"max_abs_err": 0.0}
    for f in (fi, fd):
        sets = {"camera": tuple(x[:n] for x in first_chunk(f, gen)[:2])}
        for name, (o, d) in cs.xform_edge_rays(f.scene, n, 19).items():
            sets[name] = (torch.as_tensor(o, device=dev),
                          torch.as_tensor(d, device=dev))
        for profile in ("reference", "fixed"):
            cfg0 = dataclasses.replace(f.cfg,
                                       quirks=getattr(Quirks, profile)())
            for name, (o, d) in sets.items():
                rays = Rays(o.contiguous(), d.contiguous(), o.new_zeros(0))
                label = f"K8 {f.name} {name} {profile}"
                m = o.shape[0]
                stream = stream_from_generator(gen, m, cfg0.max_depth, dev)
                st = mk.stream_tensor(stream, m, cfg0.max_depth + 1)
                for integrator in INTEGRATORS:
                    cfg = dataclasses.replace(cfg0, integrator=integrator)
                    got = mk.trace_path_mega(f.scene, rays, cfg,
                                             tables=f.tables, samples=stream)
                    ref = mk.trace_path_mega_plain(f.tables, rays, cfg, st)
                    out["max_abs_err"] = max(out["max_abs_err"], compare(
                        f"{label} {integrator}", got, ref))
                got, win = mk.trace_path_mega(f.scene, rays, cfg0,
                                              tables=f.tables, seed=5,
                                              want_winners=True)
                ref, wref = mk.trace_path_mega_plain(f.tables, rays, cfg0,
                                                     None, 5, True)
                out["max_abs_err"] = max(out["max_abs_err"], compare(
                    f"{label} path in-kernel draws", got, ref))
                compare_ids(f"K7+K8 {f.name} {name} {profile}", win, wref)
    morton = mk.morton_tables(sd)
    rays = first_chunk(fd, gen)
    a = mk.trace_path_mega(sd, rays, fd.cfg, tables=td, seed=9)
    b = mk.trace_path_mega(sd, rays, fd.cfg, tables=morton, seed=9)
    check(torch.equal(a, b), "the copied field's frame depends on the "
          "order of K8's chunks")
    print(f"[K8] copied field: copies-first and Morton order give the same "
          f"{rays.origin.shape[0]}-ray launch")
    return out


def phase_winner_parity(dev, f: Frame) -> dict:
    """K7 against its plain version on (g)'s first launch (random_spheres,
    2^18 rays, in-kernel draws): winners equal on every ray and bounce,
    radiance equal to the launch that records nothing."""
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    gen = torch.Generator(device=dev).manual_seed(13)
    rays = first_chunk(f, gen)
    n = rays.origin.shape[0]
    seed = mk.draw_seed(gen)
    ms, (got, win) = device_ms(lambda: mk.trace_path_mega(
        f.scene, rays, f.cfg, tables=f.tables, seed=seed, want_winners=True))
    inst = path_instance_of(f.tables, f.cfg, n, want_winners=True)
    call_ms, _ = cuda_ms(lambda: mk.trace_path_mega(
        f.scene, rays, f.cfg, tables=f.tables, seed=seed, want_winners=True))
    plain_launch = mk.trace_path_mega(f.scene, rays, f.cfg, tables=f.tables,
                                      seed=seed)
    check(torch.equal(got, plain_launch), "K7 changed the radiance")
    plain_ms, (ref, wref) = cuda_ms(lambda: mk.trace_path_mega_plain(
        f.tables, rays, f.cfg, None, seed, True), reps=1, warmup=0)
    err = compare(f"K7 {f.name} path in-kernel draws", got, ref)
    compare_ids(f"K7 {f.name}", win, wref)
    tests = count_tests(f.tables, rays, f.cfg, seed)
    b, by = launch_bound(f.tables, n, tests, 12 + 4 * (DEPTH + 1),
                         draws=True)
    print(f"[K7] {f.name} recording launch of {n} rays: kernel {ms:.4f} ms "
          f"(the call {call_ms:.4f} ms), plain {plain_ms:.3f} ms, bound "
          f"{b:.4f} ms ({by}), instance {inst}")
    return {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by,
            **inst, "tests": tests, "rays": n, "max_abs_err": err}


def render_mega_diff(dev, f: Frame, gen) -> dict:
    """(g), (l): f's frame through engine='mega_diff', without a gradient
    (the fused launch) and with the centres requiring one (the recording
    launch, K7): warm-up + min of 3 each, peak memory."""
    from cudaraytracer_tpu_torch.ops.render import render_image
    cfg = dataclasses.replace(f.cfg, engine="mega_diff")
    out = {}
    for mode in ("no_grad", "recording"):
        scene = f.scene
        if mode == "recording":
            sp = scene.spheres
            scene = scene._replace(spheres=sp._replace(
                center=sp.center.clone().requires_grad_()))
        torch.cuda.reset_peak_memory_stats(dev)
        with torch.set_grad_enabled(mode == "recording"):
            ms, img = cuda_ms(lambda: render_image(
                scene, f.camera, cfg, generator=gen, tables=f.tables))
        peak = torch.cuda.max_memory_allocated(dev)
        check(img.requires_grad == (mode == "recording"),
              f"{f.name} mega_diff {mode}: autograd graph")
        check(bool(torch.isfinite(img).all()),
              f"{f.name} mega_diff {mode}: non-finite")
        print(f"[main] {f.name} mega_diff {mode}: {ms / 1e3:.4f} "
              f"s/frame, peak {peak / 2 ** 30:.2f} GiB")
        out[mode] = {"frame_s": ms / 1e3, "peak_gib": peak / 2 ** 30}
        del img
    return out


# ---------------------------------------------------------------------------
# The boxes' margins: the fused kernels and K3 on rays that stress the boxes
# ---------------------------------------------------------------------------

STRESS_RAYS = 1 << 16


def here_check_scenes():
    """This checkout's ``check_scenes`` (its stress-ray generators), as a
    module of whichever package this run imports (``--ab --root``), whose
    own check_scenes may predate them."""
    import importlib.util
    from cudaraytracer_tpu_torch.models import check_scenes as cs
    if hasattr(cs, "tangent_rays") and hasattr(cs, "xform_edge_rays"):
        return cs
    path = os.path.join(ROOT, "cudaraytracer_tpu_torch", "models",
                        "check_scenes.py")
    spec = importlib.util.spec_from_file_location(
        "cudaraytracer_tpu_torch.models._here_check_scenes", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def exact_boxes(lo: torch.Tensor, hi: torch.Tensor, group: int):
    """float32[k, 8] exact boxes of consecutive groups of ``group`` prims
    (bounds lo, hi float32[N, 3]), as the TPU tables hold them, whichever
    package runs."""
    pad = -lo.shape[0] % group
    lo = torch.cat([lo, lo[-1:].expand(pad, 3)]).view(-1, group, 3)
    hi = torch.cat([hi, hi[-1:].expand(pad, 3)]).view(-1, group, 3)
    return torch.cat([lo.amin(1), hi.amax(1), lo.new_zeros(lo.shape[0], 2)],
                     1)


def first_hit_losses(label: str, scene, tables, o, d, quirks, strict: bool,
                     f2b: int = 0) -> dict:
    """The fused kernel's first hit on rays (o, d) against the plain
    version's: the path integrator at depth 0 recording its winners (the
    persistent warps, or the cooperative instances above 8,192 triangles;
    ``f2b`` shells) and the lambert integrator (one thread per ray), ray by
    ray.  A lost winner is a ray whose kernel winner differs; a triangle
    winner of the plain version is covered by the margins' proof when
    ``triangle_conditioned`` holds for it, every sphere winner is.  strict:
    a covered winner lost fails the run -> the counts."""
    from cudaraytracer_tpu_torch.config import RenderConfig
    from cudaraytracer_tpu_torch.core.rays import Rays
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    from cudaraytracer_tpu_torch.ops import sweeps as sw
    rays = Rays(o, d, o.new_zeros(0))
    cfg = RenderConfig(max_depth=0, quirks=quirks, engine="mega",
                       mega_f2b_shells=f2b)
    _, win = mk.trace_path_mega(scene, rays, cfg, tables=tables, seed=1,
                                want_winners=True)
    _, wref = mk.trace_path_mega_plain(tables, rays, cfg, None, 1, True)
    win, wref = win[0].long(), wref[0].long()
    n_s, n_t = scene.n_spheres, scene.n_triangles
    tri = (wref >= n_s) & (wref < n_s + n_t)
    covered = torch.ones_like(tri)
    if n_t:
        k = (wref - n_s).clamp(0, n_t - 1)
        tr = scene.triangles
        covered = ~tri | sw.triangle_conditioned(
            d, tr.v1[k] - tr.v0[k], tr.v2[k] - tr.v0[k])
    lost = win != wref
    lam = dataclasses.replace(cfg, integrator="lambert")
    got = mk.trace_path_mega(scene, rays, lam, tables=tables)
    ref = mk.trace_path_mega_plain(tables, rays, lam)
    lost_l = (got != ref).any(1)
    out = {"rays": int(o.shape[0]), "plain_hits": int((wref >= 0).sum()),
           "uncovered": int(((wref >= 0) & ~covered).sum()),
           "path_lost": int(lost.sum()), "lambert_lost": int(lost_l.sum()),
           "covered_lost": int(((lost | lost_l) & covered).sum())}
    print(f"[margins] {label}: {out}")
    if strict:
        check(out["covered_lost"] == 0, f"{label}: the cull lost "
              f"{out['covered_lost']} winners that the margins cover")
    return out


def phase_margins(dev, strict: bool = True) -> dict:
    """The fused tables' boxes under the rays that stress them, the fused
    kernels against the plain version (``first_hit_losses``): axis-parallel
    rays from the planes of the icosphere's exact chunk and super boxes and
    of the package's own (widened) boxes, both quirk profiles (K1's
    persistent warps and the lambert instance); the same from the exact
    chunk and super planes of (m)'s 128,000-triangle field (the cooperative
    K6, K11 with 8 shells, the lambert K6); 4,096 slivers under grazing
    rays, moderate and extreme, both profiles; rays tangent to the spheres
    of random_spheres and of the 9,216-sphere field where they touch their
    boxes (K1 with one and two sphere levels, K6's sphere segments), and
    the same rays through K3's culled instances.  2^16 rays each.  strict:
    fail on a covered winner lost (the repaired kernels); else count only
    (``--ab`` on a checkout before the margins) -> counts by case."""
    from cudaraytracer_tpu_torch.config import Quirks, RenderConfig
    from cudaraytracer_tpu_torch.models import presets
    from cudaraytracer_tpu_torch.models.scene import SceneBuilder
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    from cudaraytracer_tpu_torch.ops import sweeps as sw
    cs = here_check_scenes()
    n = STRESS_RAYS
    out = {}

    def rays_of(o, d):
        return (torch.as_tensor(o, device=dev).contiguous(),
                torch.as_tensor(d, device=dev).contiguous())

    def planes(tables, scene, morton):
        """name -> box planes float32[k, 8] of the tables' triangles."""
        tr = scene.triangles
        order = morton.long()
        v0, v1, v2 = (x[order] for x in (tr.v0, tr.v1, tr.v2))
        lo = torch.minimum(torch.minimum(v0, v1), v2)
        hi = torch.maximum(torch.maximum(v0, v1), v2)
        return {"exact chunk": exact_boxes(lo, hi, 16),
                "exact super": exact_boxes(lo, hi, 256),
                "table chunk": tables.tri_box, "table super": tables.tri_super}

    sb, _ = cs.icosphere_scene(16 / 9, device=dev)
    tb = mk.morton_tables(sb)
    target = sb.triangles.v0.mean(0).cpu().numpy()
    for name, box in planes(tb, sb, tb.tri_map).items():
        o, d = rays_of(*cs.plane_rays(box.cpu().numpy(), target, n, 5))
        for profile in ("reference", "fixed"):
            out[f"icosphere {name} {profile}"] = first_hit_losses(
                f"(b) icosphere, {name} planes, {profile}", sb, tb, o, d,
                getattr(Quirks, profile)(), strict)
    sm, _ = cs.big_field_scene(16 / 9, device=dev)
    tm = mk.morton_tables(sm)
    target = sm.triangles.v0.mean(0).cpu().numpy()
    for name, box in planes(tm, sm, tm.tri_map).items():
        if not name.startswith("exact"):
            continue
        o, d = rays_of(*cs.plane_rays(box.cpu().numpy(), target, n, 6))
        for f2b in (0, 8):
            out[f"big_field {name} f2b {f2b}"] = first_hit_losses(
                f"(m) big_field, {name} planes, {f2b} shells", sm, tm, o, d,
                Quirks.fixed(), strict, f2b)
    del sm, tm
    v = cs.sliver_cylinder()
    b = SceneBuilder()
    mat = b.materials.lambertian(color=(0.5, 0.5, 0.5))
    pts = np.concatenate(v)
    b.add_mesh(pts, np.arange(len(pts)).reshape(3, -1).T, mat,
               reverse_winding=False)
    sc = b.build(dev)
    ts = mk.morton_tables(sc)
    for band, (lo_, hi_) in (("moderate", (1e-3, 1e-1)),
                             ("extreme", (1e-6, 1e-3))):
        o, d = rays_of(*cs.grazing_rays(n, lo_, hi_, seed=11))
        for profile in ("reference", "fixed"):
            out[f"slivers {band} {profile}"] = first_hit_losses(
                f"slivers, {band} grazing, {profile}", sc, ts, o, d,
                getattr(Quirks, profile)(), strict)
    sa, _ = presets.random_spheres(16 / 9, device=dev)
    field = cs.fill_sphere_field(SceneBuilder()).build(dev)
    for name, scene in (("random_spheres", sa), ("sphere_field", field)):
        tables = mk.morton_tables(scene)
        sp = scene.spheres
        o, d = rays_of(*cs.tangent_rays(sp.center.cpu().numpy(),
                                        sp.radius.cpu().numpy(), n, 7))
        out[f"tangent {name}"] = first_hit_losses(
            f"{name}, tangent rays", scene, tables, o, d, Quirks.reference(),
            strict)
        t_min, t_max = RenderConfig().t_min, RenderConfig().t_max
        ref = sw.sphere_best_hit_plain(o, d, sp.center, sp.radius, t_min,
                                       t_max)
        tbl, box, sup = sw.sphere_table(sp.center, sp.radius)
        lost = 0
        for coop in (False, True):
            got = sw.launch_sphere_sweep(o, d, tbl, box, None, None, t_min,
                                         t_max, sup=sup, coop=coop)
            lost = max(lost, int((got[1] != ref[1]).sum()))
        print(f"[margins] K3 {name}, tangent rays: lost {lost} of {n}")
        if strict:
            check(lost == 0, f"K3 {name}: the cull lost {lost} tangent hits")
        out[f"tangent {name}"]["k3_lost"] = lost
    return out


# ---------------------------------------------------------------------------
# The BVH (crt_bvh_traverse, csrc/bvh.cu)
# ---------------------------------------------------------------------------

BVH_RAYS = 1 << 16
NODE_BYTES = 37    # a node's box (24 B), skip, prim0, prim1 and leaf flag
TRI_BYTES = 48     # a triangle's v0, v1, v2 and normal, as the walk reads


def bvh_walk(tree, tri, o, d, quirks, shrink=None, alive=None, plain=False):
    """(best_t, best_prim) of the walk over tree (FlatBVH) of the
    triangles ``tri`` (v0, v1, v2, normal): the kernel, or its plain
    version."""
    from cudaraytracer_tpu_torch.core.rays import Rays
    from cudaraytracer_tpu_torch.ops import bvh
    from cudaraytracer_tpu_torch.ops.sweeps import BIG
    fn = bvh.traverse_bvh_plain if plain else bvh.traverse_bvh
    return fn(tree, tri.v0, tri.v1, tri.v2, tri.normal,
              Rays(o, d, o.new_zeros(0)), 1e-3, BIG, quirks, shrink, alive)


def bvh_parity(label, tree, tri, o, d, quirks, shrink, alive=None) -> float:
    """crt_bvh_traverse against traverse_bvh_plain on the same rays: ids
    equal on every ray and t max abs error 0 -> the error."""
    got = bvh_walk(tree, tri, o, d, quirks, shrink, alive)
    ref = bvh_walk(tree, tri, o, d, quirks, shrink, alive, plain=True)
    n_diff = int((got[1] != ref[1]).sum())
    err = float((got[0] - ref[0]).abs().max())
    hit = float((ref[1] >= 0).float().mean())
    print(f"[bvh] {label:58s} rays {o.shape[0]:7d} hit {hit * 100:6.2f}% "
          f"idx differ {n_diff} max_abs_err {err:.3g}")
    check(n_diff == 0 and err == 0.0, f"{label}: the kernel and the plain "
          f"walk differ on {n_diff} ids, t by {err}")
    return err


def bvh_cost(tree, tri, o, d, quirks) -> dict:
    """The counting instance on these rays (shrink from the quirks): box
    and triangle tests, the nodes and triangles any ray tested, and the
    bound: tests x FLOPs over the FP32 peak against the rays (24 B in, 8 B
    out), touched nodes (37 B) and triangles (48 B) over the memory rate."""
    from cudaraytracer_tpu_torch.ops import bvh
    from cudaraytracer_tpu_torch.ops.sweeps import BIG
    n, dev = o.shape[0], o.device
    counts = bvh.BVHCounts(
        torch.zeros(2, n, dtype=torch.int32, device=dev),
        torch.zeros(tree.n_nodes, dtype=torch.uint8, device=dev),
        torch.zeros(tri.v0.shape[0], dtype=torch.uint8, device=dev))
    bvh.launch_bvh_traverse(tree, tri.v0, tri.v1, tri.v2, tri.normal, o, d,
                            1e-3, BIG, quirks, bvh._shrink_of(quirks, None),
                            counts=counts)
    box = int(counts.ray_tests[0].sum())
    tris = int(counts.ray_tests[1].sum())
    nodes = int(counts.node_seen.sum())
    seen = int(counts.tri_seen.sum())
    b, by = bound(box * FLOP_BOX + tris * FLOP_TRI,
                  n * 32 + nodes * NODE_BYTES + seen * TRI_BYTES)
    return {"box_tests": box, "tri_tests": tris, "nodes_touched": nodes,
            "tris_touched": seen,
            "box_tests_per_ray": box / n,
            "max_box_tests": int(counts.ray_tests[0].max()),
            "bound_ms": b, "bound_by": by}


def bvh_losses(label, tree, tri, o, d, quirks) -> dict:
    """The walk's first hits against brute force (K4's plain version, the
    first prim of the least t) on stress rays: a ray is lost where brute
    force hits at t > t_min and the walk keeps another winner; ``tie``
    (the walk's winner has the same t), ``behind`` (brute force's winner
    lies at t <= t_min, which no box reaches: t_min cuts the slab) apart.
    Counted only: the port keeps the JAX package's contract."""
    from cudaraytracer_tpu_torch.ops import sweeps as sw
    bt, bp = bvh_walk(tree, tri, o, d, quirks)
    rt, rp = sw.triangle_best_hit_plain(o, d, tri.v0, tri.v1, tri.v2,
                                        tri.normal, 1e-3, sw.BIG, quirks)
    differ = bp != rp
    behind = differ & (rp >= 0) & (rt <= np.float32(1e-3))
    tie = differ & (rp >= 0) & (bt == rt)
    lost = differ & (rp >= 0) & ~behind & ~tie
    out = {"rays": int(o.shape[0]), "brute_hits": int((rp >= 0).sum()),
           "lost": int(lost.sum()), "tie": int(tie.sum()),
           "behind": int(behind.sum()),
           "extra": int((differ & (rp < 0)).sum())}
    print(f"[bvh] pad losses, {label}: {out}")
    return out


def bvh_scene_rays(dev, f: Frame, gen, index: int):
    """(scene triangles, camera rays, bounce rays, their alive mask): the
    first BVH_RAYS rays of f's launch ``index`` and the same after one
    wavefront bounce."""
    rays = first_chunk(f, gen, index)
    cam = rays._replace(origin=rays.origin[:BVH_RAYS].contiguous(),
                        direction=rays.direction[:BVH_RAYS].contiguous(),
                        time=rays.time[:BVH_RAYS])
    b, alive, _ = one_bounce(f.scene, cam, dataclasses.replace(
        f.cfg, engine="wavefront"), 31, gen)
    return (f.scene.triangles, cam,
            b._replace(origin=b.origin.contiguous(),
                       direction=b.direction.contiguous()), alive)


def bvh_timing(label, f: Frame, rays, quirks, tables=None) -> dict:
    """The walk on one main-path launch of rays (f's cell's quirks):
    crt_bvh_traverse on the card (device_ms) and as the call, its plain
    version once, the bound from its counted tests, and beside them K4
    (the culled triangle sweep) and, above 8,192 triangles, K6 (the
    fused segment level, lambert: one closest hit a ray) on the same
    rays."""
    from cudaraytracer_tpu_torch.ops import bvh
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    from cudaraytracer_tpu_torch.ops import sweeps as sw
    tri = f.scene.triangles
    o, d = rays.origin.contiguous(), rays.direction.contiguous()
    t0 = time.perf_counter()
    tree = bvh.build_triangle_bvh(tri.v0, tri.v1, tri.v2, backend="native",
                                  device=o.device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    ms, got = device_ms(lambda: bvh_walk(tree, tri, o, d, quirks), reps=5)
    call_ms, _ = cuda_ms(lambda: bvh_walk(tree, tri, o, d, quirks), reps=5)
    plain_ms, ref = cuda_ms(lambda: bvh_walk(tree, tri, o, d, quirks,
                                             plain=True), reps=1, warmup=0)
    check(torch.equal(got[1], ref[1]) and torch.equal(got[0], ref[0]),
          f"{label}: the kernel and the plain walk differ")
    cost = bvh_cost(tree, tri, o, d, quirks)
    tbl = sw.triangle_table(tri.v0, tri.v1, tri.v2, tri.normal)
    k4_ms, k4 = device_ms(lambda: sw.launch_triangle_sweep(
        o, d, tbl[0], tbl[1], None, 1e-3, sw.BIG, quirks, sup=tbl[2]),
        reps=5)
    same = float((k4[1] == got[1]).float().mean())
    instance = f"crt_bvh_{bvh.mode_of(quirks, bvh._shrink_of(quirks, None))}"
    regs, spill = ptxas_usage(instance)
    out = {"rays": int(o.shape[0]), "ms": ms, "call_ms": call_ms,
           "plain_ms": plain_ms, **cost, "instance": instance,
           "registers": regs, "spill_bytes": spill, "k4_ms": k4_ms,
           "k4_same_winner": same, "native_build_s": build_s,
           "nodes": tree.n_nodes, "hit": float((got[1] >= 0).float().mean())}
    k6 = ""
    if tables is not None:
        cfg = dataclasses.replace(f.cfg, integrator="lambert")
        out["k6_lambert_ms"], _ = device_ms(lambda: mk.trace_path_mega(
            f.scene, rays, cfg, tables=tables), reps=5)
        k6 = f", K6 lambert {out['k6_lambert_ms']:.4f} ms"
    print(f"[bvh] {label}: kernel {ms:.4f} ms on the card (the call "
          f"{call_ms:.4f} ms), plain {plain_ms:.3f} ms, bound "
          f"{cost['bound_ms']:.4f} ms ({cost['bound_by']}; box tests "
          f"{cost['box_tests']} ({cost['box_tests_per_ray']:.1f} a ray, at "
          f"most {cost['max_box_tests']}), triangle tests "
          f"{cost['tri_tests']}, nodes touched {cost['nodes_touched']} of "
          f"{tree.n_nodes}); K4 {k4_ms:.4f} ms (same winner on "
          f"{same:.2%}){k6}; native build {build_s:.3f} s; {instance} "
          f"{regs} registers, {spill} B spill")
    return out


def phase_bvh(dev, fb: Frame, fm: Frame, fn: Frame) -> dict:
    """The BVH on the card: the native build's layout equal to the Python
    builder's on (b), and its seconds on (m) and (n); the card's refit
    equal to the CPU's on (b) and (m); crt_bvh_traverse against
    traverse_bvh_plain on 2^16 camera and 2^16 bounce rays of (b) and
    (m), both quirk profiles and both shrink values, and on skinned_field's
    bone forest (and that forest's winners against brute force, counted);
    the pad's losses against brute force on stress rays (box planes,
    slivers), counted per profile; the walk timed on the first 2^18 rays of
    (b), (m) (and their middle launches: the first sees the bottom rows,
    mostly ground) and (n), beside K4 and K6."""
    from cudaraytracer_tpu_torch.config import Quirks
    from cudaraytracer_tpu_torch.core.camera import generate_pixel_rays
    from cudaraytracer_tpu_torch.models import check_scenes as cs
    from cudaraytracer_tpu_torch.models import mesh as tmesh
    from cudaraytracer_tpu_torch.ops import bone_bvh as bb
    from cudaraytracer_tpu_torch.ops import bvh
    from cudaraytracer_tpu_torch.ops import intersect as isect
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(41)
    out = {"max_abs_err": 0.0}
    profiles = {"reference": Quirks.reference(), "fixed": Quirks.fixed()}
    # build: the native layout is the Python builder's
    tb = fb.scene.triangles
    t0 = time.perf_counter()
    py = bvh.build_triangle_bvh(tb.v0, tb.v1, tb.v2, backend="python",
                                device=dev)
    out["b_python_build_s"] = time.perf_counter() - t0
    nat = bvh.build_triangle_bvh(tb.v0, tb.v1, tb.v2, backend="native",
                                 device=dev)
    same = all(torch.equal(getattr(py, k), getattr(nat, k)) for k in (
        "bbox_min", "bbox_max", "is_leaf", "skip", "prim0", "prim1",
        "child_l", "child_r")) and len(py.levels) == len(nat.levels) and all(
        torch.equal(a, b) for a, b in zip(py.levels, nat.levels))
    print(f"[bvh] (b) native layout equal to the Python builder's: {same} "
          f"({nat.n_nodes} nodes, Python {out['b_python_build_s']:.3f} s)")
    check(same, "the native and Python builders differ on (b)")
    trees = {"b": nat}
    for key, f in (("m", fm), ("n", fn)):
        tri = f.scene.triangles
        t0 = time.perf_counter()
        trees[key] = bvh.build_triangle_bvh(tri.v0, tri.v1, tri.v2,
                                            backend="native", device=dev)
        torch.cuda.synchronize()
        out[f"{key}_native_build_s"] = time.perf_counter() - t0
        print(f"[bvh] ({key}) native build {out[f'{key}_native_build_s']:.3f}"
              f" s, {trees[key].n_nodes} nodes, {len(trees[key].levels)} "
              "levels")
    # refit: card against CPU, on a deformation of (b) and (m)
    for key, f in (("b", fb), ("m", fm)):
        tri = f.scene.triangles
        g = torch.Generator(device=dev).manual_seed(7)
        w = [v + 0.01 * torch.randn(v.shape, generator=g, device=dev)
             for v in (tri.v0, tri.v1, tri.v2)]
        host = bvh.FlatBVH(*(tuple(x.cpu() for x in fld)
                             if isinstance(fld, tuple) else fld.cpu()
                             for fld in trees[key]))
        ms, card = cuda_ms(lambda: bvh.refit_bvh(trees[key], *w), reps=3)
        ref = bvh.refit_bvh(host, *(x.cpu() for x in w))
        err = max(float((card.bbox_min.cpu() - ref.bbox_min).abs().max()),
                  float((card.bbox_max.cpu() - ref.bbox_max).abs().max()))
        print(f"[bvh] ({key}) refit on the card against the CPU: max abs "
              f"error {err}, {ms:.3f} ms ({len(trees[key].levels)} levels)")
        check(err == 0.0, f"({key}) refit differs from the CPU's")
        out[f"{key}_refit_ms"] = ms
    # kernel against plain: camera and bounce rays of (b) and (m)
    for key, f in (("b", fb), ("m", fm)):
        tri, cam, bnc, alive = bvh_scene_rays(dev, f, gen, middle_chunk(f))
        for pname, q in profiles.items():
            for shrink in (False, True):
                for kind, r, al in (("camera", cam, None),
                                    ("bounce", bnc, alive)):
                    out["max_abs_err"] = max(out["max_abs_err"], bvh_parity(
                        f"({key}) {kind} {pname} shrink {int(shrink)}",
                        trees[key], tri, r.origin, r.direction, q, shrink,
                        al))
    # the bone forest of skinned_field (frame 0's pose)
    mesh = cs.skinned_field()
    dm = tmesh.device_mesh(mesh, dev)
    v0, v1, v2 = tmesh.skin_frame(dm, 0)
    forest = bb.build_bone_forest(*(x.cpu().numpy() for x in (v0, v1, v2)),
                                  mesh.weights, mesh.faces, device=dev)
    check(forest.n_dropped == 0, "skinned_field's forest dropped triangles")
    fscene = tmesh.scene_with_frame(animate_scene(dev, mesh), dm, 0)
    ftri = fscene.triangles
    cam = cs.field_camera(2.0, device=dev)
    fr = generate_pixel_rays(cam, 512, 256, 1, generator=gen)
    fr = fr._replace(origin=fr.origin[:BVH_RAYS].contiguous(),
                     direction=fr.direction[:BVH_RAYS].contiguous(),
                     time=fr.time[:BVH_RAYS])
    fb_rays, falive, _ = one_bounce(fscene, fr, dataclasses.replace(
        fm.cfg, engine="wavefront"), 37, gen)
    for pname, q in profiles.items():
        for shrink in (False, True):
            for kind, r, al in (("camera", fr, None),
                                ("bounce", fb_rays, falive)):
                out["max_abs_err"] = max(out["max_abs_err"], bvh_parity(
                    f"skinned_field forest {kind} {pname} shrink "
                    f"{int(shrink)}", forest.bvh, ftri,
                    r.origin.contiguous(), r.direction.contiguous(), q,
                    shrink, al))
    brute_differ = {}
    for pname, q in profiles.items():
        got = isect.intersect_scene_bvh(fscene, fr, forest.bvh, quirks=q)
        ref = isect.intersect_scene(fscene, fr, quirks=q)
        brute_differ[pname] = int((got.prim != ref.prim).sum())
        print(f"[bvh] skinned_field forest against brute force "
              f"(intersect_scene), {pname}: {brute_differ[pname]} of "
              f"{fr.origin.shape[0]} winners differ")
    out["forest"] = {"trees": int(len(forest.root_bones)),
                     "nodes": forest.bvh.n_nodes,
                     "dropped": int(forest.n_dropped),
                     "brute_force_differ": brute_differ}
    # the pad's losses on stress rays
    losses = {}
    for name, scene in (("icosphere", fb.scene),
                        ("skinned_capsule",
                         animate_scene(dev, cs.skinned_capsule()))):
        tri = scene.triangles
        tree = bvh.build_triangle_bvh(tri.v0, tri.v1, tri.v2, device=dev)
        lo = torch.minimum(torch.minimum(tri.v0, tri.v1), tri.v2)
        hi = torch.maximum(torch.maximum(tri.v0, tri.v1), tri.v2)
        target = tri.v0.mean(0).cpu().numpy()
        for planes, box in (("node", torch.cat([tree.bbox_min,
                                                tree.bbox_max], 1)),
                            ("triangle", torch.cat([lo, hi], 1))):
            o, d = (torch.as_tensor(x, device=dev) for x in cs.plane_rays(
                box.cpu().numpy(), target, STRESS_RAYS, 5))
            for pname, q in profiles.items():
                losses[f"{name} {planes} planes {pname}"] = bvh_losses(
                    f"{name}, {planes} planes, {pname}", tree, tri, o, d, q)
    sv = cs.sliver_cylinder()
    sliv = type("Slivers", (), {})()
    sliv.v0, sliv.v1, sliv.v2 = (torch.as_tensor(x, device=dev) for x in sv)
    e1, e2 = sliv.v1 - sliv.v0, sliv.v2 - sliv.v0
    sliv.normal = torch.nn.functional.normalize(torch.linalg.cross(e1, e2),
                                                dim=1)
    stree = bvh.build_triangle_bvh(sliv.v0, sliv.v1, sliv.v2, device=dev)
    for band, (lo_, hi_) in (("moderate", (1e-3, 1e-1)),
                             ("extreme", (1e-6, 1e-3))):
        o, d = (torch.as_tensor(x, device=dev).contiguous()
                for x in cs.grazing_rays(STRESS_RAYS, lo_, hi_, seed=11))
        for pname, q in profiles.items():
            losses[f"slivers {band} {pname}"] = bvh_losses(
                f"slivers, {band} grazing, {pname}", stree, sliv, o, d, q)
    out["pad_losses"] = losses
    # timing on the first 2^18 rays of (b), (m) and (n)
    timing = {}
    for key, f, idx, tables in (("b", fb, 0, None),
                                ("b_middle", fb, middle_chunk(fb), None),
                                ("m", fm, 0, fm.tables),
                                ("m_middle", fm, middle_chunk(fm),
                                 fm.tables),
                                ("n", fn, 0, fn.tables)):
        rays = first_chunk(f, gen, idx)
        timing[key] = bvh_timing(f"({key}) first 2^18 rays" if idx == 0
                                 else f"({key}) launch {idx}", f, rays,
                                 f.cfg.quirks, tables)
    out["timing"] = timing
    print(f"[phase] bvh done in {time.perf_counter() - t_phase:.1f} s")
    return out


def animate_scene(dev, mesh):
    """A skinned mesh's bind pose as apps/animate.py builds its scene: one
    triangle a face, reversed winding, one red lambertian."""
    from cudaraytracer_tpu_torch.models.scene import SceneBuilder
    b = SceneBuilder()
    b.add_mesh(mesh.points, mesh.faces, b.materials.lambertian(
        color=(0.65, 0.05, 0.05)), normals=mesh.normals, reverse_winding=True)
    return b.build(dev)


# ---------------------------------------------------------------------------
# Kernel mode K9 (image textures)
# ---------------------------------------------------------------------------

def tex_frames(dev) -> list:
    """(j) random_spheres with images (about 1 in 5 small lambertians and
    the big left sphere on a 128x64 image), 1920x1080x16, path depth 8,
    fixed quirks (every lambertian hit samples its real uv); (k) the
    5,120-triangle icosphere on bench.py's 128x128 image, 1280x720x8, depth
    8, fixed quirks; (l) textured_globe (an image light on a rect: K8 and
    K9), 1280x720x16, depth 8, reference quirks.  All fused, Morton
    tables."""
    from cudaraytracer_tpu_torch.config import Quirks, RenderConfig
    from cudaraytracer_tpu_torch.models import check_scenes as cs
    from cudaraytracer_tpu_torch.models import presets
    from cudaraytracer_tpu_torch.ops.megakernel import morton_tables
    sj, cj = presets.random_spheres(aspect=1920 / 1080, textured=True,
                                    device=dev)
    cfg_j = RenderConfig(width=1920, height=1080, samples=16,
                         max_depth=DEPTH, quirks=Quirks.fixed(),
                         engine="mega")
    sk, ck = cs.tex_icosphere_scene(1280 / 720, device=dev)
    check(sk.n_triangles == 5120, "tex_icosphere size")
    cfg_k = RenderConfig(width=1280, height=720, samples=8, max_depth=DEPTH,
                         quirks=Quirks.fixed(), engine="mega")
    sl, cl = presets.textured_globe(1280 / 720, device=dev)
    cfg_l = RenderConfig(width=1280, height=720, samples=16,
                         max_depth=DEPTH, engine="mega")
    return [Frame("tex_spheres", sj, cj, cfg_j, morton_tables(sj)),
            Frame("tex_icosphere", sk, ck, cfg_k, morton_tables(sk)),
            Frame("textured_globe", sl, cl, cfg_l, morton_tables(sl))]


def constant_textures(tables):
    """The tables with every image material's block made a constant grey
    texture and the images dropped: the launch takes the instance without
    TEX over the same paths (textures never change a path), so the time
    against the K9 launch is the texel fetch's own cost."""
    from cudaraytracer_tpu_torch.models import textures as tx
    from cudaraytracer_tpu_torch.ops import megakernel as mk

    def strip(rows, k0):
        rows = rows.clone()
        img = rows[:, k0 + 1] == float(tx.IMAGE)
        rows[img, k0 + 1] = float(tx.CONSTANT)
        rows[img, k0 + 3:k0 + 6] = 0.5
        return rows

    return tables._replace(
        sph=strip(tables.sph, mk.S_MAT), tri=strip(tables.tri, mk.T_MAT),
        rect=strip(tables.rect, mk.X_MAT), tsph=strip(tables.tsph, mk.X_MAT),
        ttri=strip(tables.ttri, mk.X_MAT),
        images=tables.images[:1, :1, :1].contiguous())


def texel_fetches(scene, winners) -> int:
    """Texels a path launch fetched: one at each hit on an image lambertian
    (its attenuation) or an image light (its emission)."""
    from cudaraytracer_tpu_torch.models import materials as mt
    from cudaraytracer_tpu_torch.models import textures as tx
    mats = torch.cat([scene.spheres.mat, scene.triangles.mat,
                      scene.rects.mat, scene.t_spheres.mat,
                      scene.t_triangles.mat]).long()
    m = scene.materials
    kind = m.kind[mats]
    image = ((scene.textures.kind[m.tex_id[mats].long()] == tx.IMAGE)
             & ((kind == mt.LAMBERTIAN) | (kind == mt.DIFFUSE_LIGHT)))
    return int(image[winners[winners >= 0].long()].sum())


def compare_tex(label: str, got: torch.Tensor, ref: torch.Tensor) -> tuple:
    """K9 against its plain version -> (max abs error, flipped rays): every
    ray to PARITY_ATOL except rays whose texel flipped at an edge (the
    kernel's atan2f / asinf against PyTorch's, within rounding of a texel
    boundary), at most max(2, n / 10^4) of them."""
    diff = (got - ref).abs().amax(dim=1)
    n = got.shape[0]
    flips = int((diff > PARITY_ATOL).sum())
    limit = max(2, n // 10 ** 4)
    err = float(diff.max())
    print(f"[K9] {label:44s} rays {n:7d} flipped texels {flips} (limit "
          f"{limit}) max_abs_err {err:.3g}")
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite radiance")
    check(flips <= limit, f"{label}: {flips} rays differ by more than "
          f"{PARITY_ATOL}")
    return err, flips


def phase_tex_parity(dev, tframes) -> dict:
    """K9 against its plain version on full 2^18-ray launches: (j)'s middle
    launch under both quirk profiles, (k)'s middle launch, (l)'s first:
    three integrators on an injected stream, the path on in-kernel draws
    with winners (K7 on K9) equal to the plain version's and radiance equal
    to the launch that records nothing.  Times each path launch beside the
    same launch with constant textures, and its bound with 3 bytes per
    texel fetched."""
    from cudaraytracer_tpu_torch.config import Quirks
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    from cudaraytracer_tpu_torch.ops.integrators import stream_from_generator
    gen = torch.Generator(device=dev).manual_seed(17)
    fj, fk, fl = tframes
    launches = [(fj, "fixed", middle_chunk(fj)),
                (fj, "reference", middle_chunk(fj)),
                (fk, "fixed", middle_chunk(fk)), (fl, "reference", 0)]
    out = {"max_abs_err": 0.0, "flips": 0}
    for f, profile, k in launches:
        cfg = dataclasses.replace(f.cfg, quirks=getattr(Quirks, profile)())
        label = f"{f.name} {profile} launch {k}"
        rays = first_chunk(f, gen, k)
        n = rays.origin.shape[0]
        stream = stream_from_generator(gen, n, DEPTH, dev)
        st = mk.stream_tensor(stream, n, DEPTH + 1)

        def note(res):
            out["max_abs_err"] = max(out["max_abs_err"], res[0])
            out["flips"] += res[1]

        for integrator in INTEGRATORS:
            c = dataclasses.replace(cfg, integrator=integrator)
            got = mk.trace_path_mega(f.scene, rays, c, tables=f.tables,
                                     samples=stream)
            note(compare_tex(f"{label} {integrator} injected", got,
                             mk.trace_path_mega_plain(f.tables, rays, c,
                                                      st)))
        seed = mk.draw_seed(gen)
        ms, got = device_ms(lambda: mk.trace_path_mega(
            f.scene, rays, cfg, tables=f.tables, seed=seed))
        inst = path_instance_of(f.tables, cfg, n)
        call_ms, _ = cuda_ms(lambda: mk.trace_path_mega(
            f.scene, rays, cfg, tables=f.tables, seed=seed))
        ctab = constant_textures(f.tables)
        const_ms, _ = device_ms(lambda: mk.trace_path_mega(
            f.scene, rays, cfg, tables=ctab, seed=seed))
        plain_ms, (ref, wref) = cuda_ms(lambda: mk.trace_path_mega_plain(
            f.tables, rays, cfg, None, seed, True), reps=1, warmup=0)
        note(compare_tex(f"{label} path in-kernel draws", got, ref))
        got_w, win = mk.trace_path_mega(f.scene, rays, cfg, tables=f.tables,
                                        seed=seed, want_winners=True)
        compare_ids(f"K7+K9 {label}", win, wref)
        check(torch.equal(got_w, got), f"{label}: recording changed the "
              "radiance")
        tests = count_tests(f.tables, rays, cfg, seed)
        fetched = texel_fetches(f.scene, win)
        b, by = launch_bound(f.tables, n, tests, extra_bytes=3 * fetched,
                             draws=True)
        no_draws, _ = launch_bound(f.tables, n, tests,
                                   extra_bytes=3 * fetched)
        lanes = lane_use(tests)
        print(f"[K9] {label} path launch of {n} rays: kernel {ms:.4f} ms "
              f"(the call {call_ms:.4f} ms), constant textures "
              f"{const_ms:.4f} ms (texel fetch {ms - const_ms:+.4f} ms), "
              f"plain (with winners) "
              f"{plain_ms:.3f} ms, bound {b:.4f} ms ({by}; {no_draws:.4f} "
              f"ms without the draws), texels fetched {fetched}, lanes' use "
              f"{lanes:.4f}, instance {inst}, tests {tests}")
        print_schedule_model(f"K9 {label} path launch", f.scene, win)
        out[label] = {"ms": ms, "call_ms": call_ms,
                      "const_tex_ms": const_ms,
                      "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
                      "bound_no_draws_ms": no_draws, "lane_use": lanes,
                      **inst, "texels": fetched, "tests": tests, "rays": n}
    return out


def replay_divergence(dev, f: Frame, index: int = 0) -> int:
    """ROADMAP Queue 3's risk, counted: the rays of one 2^18-ray mega_diff
    launch whose replay (the backward's trace_path on the recorded winners,
    K2 draws of the same seed) meets a recorded winner that fails its own
    test on the replayed ray at some bounce (the caller requires 0)."""
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    from cudaraytracer_tpu_torch.ops.integrators import replay_misses
    gen = torch.Generator(device=dev).manual_seed(19)
    rays = first_chunk(f, gen, index)
    seed = mk.draw_seed(gen)
    cfg = dataclasses.replace(f.cfg, engine="mega_diff")
    _, win = mk.trace_path_mega(f.scene, rays, cfg, tables=f.tables,
                                seed=seed, want_winners=True)
    missed = int(replay_misses(f.scene, rays, dataclasses.replace(
        cfg, engine="wavefront", wavefront_tpu_prng=True), win,
        seed=seed).sum())
    print(f"[replay] {f.name} launch {index}: {missed} of "
          f"{rays.origin.shape[0]} rays meet a recorded winner that the "
          f"replayed ray misses")
    return missed


def tex_fit_step(dev, steps: int = 5) -> dict:
    """The mega_diff fit step on textured_globe at (e)'s 512x256x4 shape
    (depth 4, no gamma, SGD on albedo and centres, tables rebuilt from the
    params): a warm-up step, then ``steps`` timed steps from the same
    start (host clock around a step that ends in a read of the loss)."""
    from cudaraytracer_tpu_torch.parallel.train import make_fit_step
    scene, cam, cfg, rays, target, p0 = fit_scene("textured_globe", dev,
                                                  "mega_diff")
    step = make_fit_step(scene, cam, cfg, lr=0.5)

    def run(p):
        return step(p, target, torch.Generator(device=dev).manual_seed(1),
                    rays=rays)

    run(p0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss, p1 = run(p0)
        loss = float(loss)
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated(dev)
    med = sorted(times)[len(times) // 2]
    print(f"[fit mega_diff] textured_globe: loss {loss:.6e}, "
          f"{min(times):.4f} s/step (min of {steps}, median {med:.4f}), "
          f"peak {peak / 2 ** 30:.2f} GiB")
    check(math.isfinite(loss) and loss > 0.0, f"textured_globe loss {loss}")
    check(all(bool(torch.isfinite(v).all()) for v in p1.values()),
          "textured_globe fit step: non-finite params")
    return {"s_per_step": min(times), "median_s": med, "steps_s": times,
            "loss": loss, "peak_gib": peak / 2 ** 30}


# ---------------------------------------------------------------------------
# Kernel modes K6 (segment level), K10 (bounce windows), K11 (shells)
# ---------------------------------------------------------------------------

N_BIG1M_CHECK = 1 << 16     # rays of (n) held against the plain version


def stream_frames(dev) -> list:
    """(m) big_field: 5 x 5 icospheres, 128,000 triangles, 1280x720x8, path
    depth 8, fixed quirks (the default route: phased every 2 bounces,
    octants, 8 shells); (n) big1m: 12 x 17 icospheres, 1,044,480
    triangles, 1280x720x8, lambert, fixed quirks (monolithic K6).  Fused,
    Morton tables."""
    from cudaraytracer_tpu_torch.config import Quirks, RenderConfig
    from cudaraytracer_tpu_torch.models import check_scenes as cs
    from cudaraytracer_tpu_torch.ops.megakernel import morton_tables
    sm, cm = cs.big_field_scene(1280 / 720, device=dev)
    sn, cn = cs.big1m_scene(1280 / 720, device=dev)
    check(sm.n_triangles == 128000 and sn.n_triangles == 1044480,
          "field sizes")
    cfg_m = RenderConfig(width=1280, height=720, samples=8, max_depth=DEPTH,
                         quirks=Quirks.fixed(), engine="mega")
    cfg_n = dataclasses.replace(cfg_m, integrator="lambert")
    return [Frame("big_field", sm, cm, cfg_m, morton_tables(sm)),
            Frame("big1m", sn, cn, cfg_n, morton_tables(sn))]


def sphere_field_frame(dev):
    """The 9,216-sphere field (segment level over spheres), its Morton
    tables and 2^18 rays cast from above."""
    from cudaraytracer_tpu_torch.config import RenderConfig
    from cudaraytracer_tpu_torch.core.rays import make_rays
    from cudaraytracer_tpu_torch.models import check_scenes as cs
    from cudaraytracer_tpu_torch.models.scene import SceneBuilder
    from cudaraytracer_tpu_torch.ops.megakernel import morton_tables
    scene = cs.fill_sphere_field(SceneBuilder()).build(dev)
    rays = make_rays(*cs.sphere_field_rays(1 << 18), device=dev)
    cfg = RenderConfig(max_depth=DEPTH, engine="mega")
    return Frame("sphere_field", scene, None, cfg, morton_tables(scene)), rays


def timed_parity(label, f, rays, cfg, seed, out: dict, key: str,
                 plain=None, hold: bool = False) -> dict:
    """One launch with in-kernel draws: kernel against the plain version
    (timed once, or ``plain`` = (ms, result) measured already), its
    tests (hold: held against the per-thread sweep's, ``count_tests``) and
    bound; the kernel timed on the card (``ms``, device_ms) and as the
    call (``call_ms``, the wrapper's host time included)."""
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    ms, got = device_ms(lambda: mk.trace_path_mega(
        f.scene, rays, cfg, tables=f.tables, seed=seed), reps=3)
    call_ms, _ = cuda_ms(lambda: mk.trace_path_mega(
        f.scene, rays, cfg, tables=f.tables, seed=seed))
    if plain is None:
        plain = cuda_ms(lambda: mk.trace_path_mega_plain(
            f.tables, rays, cfg, None, seed), reps=1, warmup=0)
    plain_ms, ref = plain
    out[key] = max(out.get(key, 0.0), compare(label, got, ref))
    tests = count_tests(f.tables, rays, cfg, seed, hold=hold)
    b, by = launch_bound(f.tables, rays.origin.shape[0], tests, cfg=cfg)
    print(f"[stream] {label}: kernel {ms:.4f} ms on the card (the call "
          f"{call_ms:.4f} ms), plain {plain_ms:.3f} ms, bound {b:.4f} ms "
          f"({by}), tests {tests}")
    return {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by, "tests": tests,
            "rays": rays.origin.shape[0], "got": got}


def per_thread_ms(f, rays, cfg, seed, got, window=None) -> float:
    """The same launch with the one-thread-per-ray triangle sweep
    (``_launch_mega(per_thread=True)``), min of 3: its radiance must equal
    the cooperative launch's ``got``."""
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    ms, out = cuda_ms(lambda: mk._launch_mega(
        f.tables, rays.origin.contiguous(), rays.direction.contiguous(),
        cfg, None, seed, window=window if window is not None else mk.WHOLE,
        per_thread=True))
    check(torch.equal(out, got), f"{f.name}: the per-thread sweep's "
          "radiance differs from the cooperative one's")
    return ms


def coop_against_per_thread(f, rays, seed) -> dict:
    """K6 cooperative against one thread per ray on one launch of f (path),
    the whole path, bounce 0 alone (window [0, 1), coherent camera rays)
    and bounces 1-8 resumed in place from its planes (incoherent): ms of
    each, min of 3, their radiance (and planes) equal."""
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    out = {}
    n = rays.origin.shape[0]
    for name, w in (("whole", mk.WHOLE), ("bounce_0", mk.Window(0, 1))):
        ms, got = cuda_ms(lambda: mk.trace_path_mega(
            f.scene, rays, f.cfg, tables=f.tables, seed=seed, window=w))
        pt = per_thread_ms(f, rays, f.cfg, seed, got, w)
        out[name] = {"coop_ms": ms, "per_thread_ms": pt}
    planes = torch.empty(mk.N_PLANES, n, device=rays.origin.device)
    mk.trace_path_mega(f.scene, rays, f.cfg, tables=f.tables, seed=seed,
                       window=mk.Window(0, 1, planes))
    start_from = planes.clone()
    w = mk.Window(1, None, planes)
    o, d = rays.origin.contiguous(), rays.direction.contiguous()
    got = {}
    for key, per_thread in (("coop_ms", False), ("per_thread_ms", True)):
        ms = inplace_ms(lambda: mk._launch_mega(
            f.tables, o, d, f.cfg, None, seed, window=w,
            per_thread=per_thread), planes, start_from)
        got[key] = planes.clone()
        out.setdefault("bounces_1_8", {})[key] = ms
    check(torch.equal(got["coop_ms"], got["per_thread_ms"]),
          f"{f.name}: the per-thread sweep's planes differ from the "
          "cooperative one's")
    for name, v in out.items():
        print(f"[coop] {f.name} {name}: cooperative {v['coop_ms']:.4f} ms, "
              f"one thread per ray {v['per_thread_ms']:.4f} ms, equal "
              "radiance")
    return out


def window_parity(f, rays, seed, whole, err: dict) -> dict:
    """K10 on one launch of f (path, in-kernel draws): the window [0, 2)
    writes every ray's planes and, in each key mode, keys equal to the
    plain key function's on those planes (and, octant, the plain version's
    planes and keys); the window [2, 4) resumed in place, timed (min of 3,
    each from the same planes) in the order the octant keys sort to, as
    the default route serves it, against the plain version, and in ray-id
    order (the figure earlier PRs timed) against one thread per ray; the
    rest of the path completes ``whole``, the monolithic launch."""
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    dev = rays.origin.device
    n = rays.origin.shape[0]
    bounds = f.tables.key_bounds
    planes = torch.empty(mk.N_PLANES, n, device=dev)
    key = torch.empty(n, dtype=torch.int32, device=dev)
    for mode in (mk.KEY_ALIVE, mk.KEY_MORTON, mk.KEY_OCTANT):
        w0 = mk.Window(0, 2, planes, None, key, mode)
        mk.trace_path_mega(f.scene, rays, f.cfg, tables=f.tables, seed=seed,
                           window=w0)
        plain_key = mk.regroup_keys(planes[3:6].t(), planes[6:9].t(),
                                    planes[12] > 0.0, mode, bounds)
        check(torch.equal(key, plain_key), f"K10 key mode {mode}: the "
              "kernel's keys differ from the plain key function's")
    print("[stream] K10 window [0, 2): the kernel's keys equal the plain key "
          "function's (alive first, Morton, octant)")
    ref = w0._replace(planes=torch.empty_like(planes),
                      key=torch.empty_like(key))
    mk.trace_path_mega_plain(f.tables, rays, f.cfg, None, seed, window=ref)
    err["mega_window"] = compare("K10 big_field window [0, 2) planes",
                                 planes.t(), ref.planes.t())
    check(torch.equal(key, ref.key), "K10: the kernel's octant keys differ "
          "from the plain version's")
    after_0_2 = planes.clone()
    o, d = rays.origin.contiguous(), rays.direction.contiguous()
    w1 = mk.Window(2, 2, planes)
    id_ms = inplace_ms(lambda: mk.trace_path_mega(
        f.scene, rays, f.cfg, tables=f.tables, seed=seed, window=w1),
        planes, after_0_2)
    got = planes.clone()
    ref = after_0_2.clone()
    t0 = time.perf_counter()
    mk.trace_path_mega_plain(f.tables, rays, f.cfg, None, seed,
                             window=w1._replace(planes=ref))
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err["mega_window"] = max(err["mega_window"], compare(
        "K10 big_field window [2, 4) in place", got.t(), ref.t()))
    pt = inplace_ms(lambda: mk._launch_mega(
        f.tables, o, d, f.cfg, None, seed, window=w1, per_thread=True),
        planes, after_0_2)
    check(torch.equal(planes, got), "K10: the per-thread sweep's planes "
          "differ from the cooperative one's")
    order = mk._next_order(key)
    ms, call_ms = (inplace_ms(lambda: mk.trace_path_mega(
        f.scene, rays, f.cfg, tables=f.tables, seed=seed,
        window=w1._replace(order=order)), planes, after_0_2, card=card)
        for card in (True, False))
    check(torch.equal(planes, got), "K10: the window in the octant order "
          "differs from the window in ray-id order")
    mk.trace_path_mega(f.scene, rays, f.cfg, tables=f.tables, seed=seed,
                       window=mk.Window(4, None, planes, order))
    check(torch.equal(planes[:3].t(), whole), "K10: the windows in place "
          "differ from the unbroken launch")
    counting = w1._replace(planes=after_0_2.clone(), order=order)
    tests = count_tests(f.tables, rays, f.cfg, seed, counting)
    # every ray's order entry and alive flag (8 B); a ray alive after [0, 2)
    # reads its other 12 planes (48 B) and writes all 13 back (52 B)
    alive = int((after_0_2[mk.PL_ALIVE] > 0.0).sum())
    b, by = launch_bound(f.tables, n, tests, cfg=f.cfg,
                         ray_bytes=8 * n + 100 * alive)
    print(f"[stream] K10 big_field window [2, 4) in place: kernel "
          f"{ms:.4f} ms on the card in the octant order (the call "
          f"{call_ms:.4f} ms), {id_ms:.4f} ms in ray-id order "
          f"(earlier PRs' figure), one thread per ray {pt:.4f} ms (ray-id "
          f"order), plain {plain_ms:.3f} ms, bound {b:.4f} ms ({by}; "
          f"{alive} of {n} rays alive), tests {tests}; the rest of the path "
          "completes the monolithic launch bit for bit")
    return {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "bound_ms": b, "bound_by": by, "tests": tests, "rays": n,
            "alive_rays": alive, "per_thread_ms": pt,
            "ray_id_order_ms": id_ms}


def phase_stream_parity(dev, sframes) -> dict:
    """K6, K10 and K11 against the plain version on the card: (m)'s first
    2^18-ray launch (path: three integrators on an injected stream, the
    path on in-kernel draws with the winners of K7 on K6), the sphere
    field's 2^18 rays, 2^16 rays of (n) (lambert: the plain brute force
    over 1M triangles at 2^18 rays would take minutes); K10: a window's
    dump and a resumed window against the plain version, the compaction
    drivers equal to the monolithic launch; K11: shells 8 against 0,
    equal radiance and winners."""
    from cudaraytracer_tpu_torch.core.rays import Rays
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    from cudaraytracer_tpu_torch.ops.integrators import stream_from_generator
    fm, fn = sframes
    gen = torch.Generator(device=dev).manual_seed(23)
    err = {}
    res = {}
    rays = first_chunk(fm, gen)
    n = rays.origin.shape[0]
    check(n == 1 << 18 and fm.tables.tri_seg.shape[0] == 63,
          "(m)'s launch and segments")
    stream = stream_from_generator(gen, n, DEPTH, dev)
    st = mk.stream_tensor(stream, n, DEPTH + 1)
    got_inj = None
    for integrator in INTEGRATORS:
        cfg = dataclasses.replace(fm.cfg, integrator=integrator)
        got = mk.trace_path_mega(fm.scene, rays, cfg, tables=fm.tables,
                                 samples=stream)
        ref = mk.trace_path_mega_plain(fm.tables, rays, cfg, st)
        err["mega_stream"] = max(err.get("mega_stream", 0.0), compare(
            f"K6 big_field launch 0 {integrator} injected", got, ref))
        got_inj = got if integrator == "path" else got_inj
    seed = mk.draw_seed(gen)
    plain = cuda_ms(lambda: mk.trace_path_mega_plain(
        fm.tables, rays, fm.cfg, None, seed, True), reps=1, warmup=0)
    ref, wref = plain[1]
    k6 = timed_parity("K6 big_field launch 0 path in-kernel draws", fm,
                      rays, fm.cfg, seed, err, "mega_stream",
                      (plain[0], ref), hold=True)
    got = k6.pop("got")
    k6["against_per_thread"] = coop_against_per_thread(fm, rays, seed)
    got_w, win = mk.trace_path_mega(fm.scene, rays, fm.cfg, tables=fm.tables,
                                    seed=seed, want_winners=True)
    compare_ids("K7+K6 big_field launch 0", win, wref)
    check(torch.equal(got_w, got), "K7 changed K6's radiance")
    res["mega_stream"] = k6
    # K11: shells 8 against table order
    cfg8 = dataclasses.replace(fm.cfg, mega_f2b_shells=8)
    k11 = timed_parity("K11 big_field launch 0 shells 8", fm, rays, cfg8,
                       seed, err, "mega_f2b", (plain[0], ref), hold=True)
    got8 = k11.pop("got")
    k11["per_thread_ms"] = per_thread_ms(fm, rays, cfg8, seed, got8)
    got8_w, win8 = mk.trace_path_mega(fm.scene, rays, cfg8,
                                      tables=fm.tables, seed=seed,
                                      want_winners=True)
    check(torch.equal(got8, got) and torch.equal(got8_w, got),
          "K11: shells 8 changed the radiance")
    compare_ids("K11 shells 8 against 0", win8, win)
    print("[stream] K11 shells 8 against 0: radiance and winners equal")
    res["mega_f2b"] = k11
    # K10: the window [0, 2) writes the planes and the keys; [2, 4) resumed
    # in place; the drivers
    k10 = window_parity(fm, rays, seed, got, err)
    drivers = {
        "phased every 2, octants, shells 8": lambda: mk.trace_path_mega_phased(
            fm.scene, rays, cfg8, tables=fm.tables, compact_every=2,
            seed=seed, octants=True),
        "phased every 1, partition": lambda: mk.trace_path_mega_phased(
            fm.scene, rays, fm.cfg, tables=fm.tables, compact_every=1,
            seed=seed, octants=False),
        "phased every 3, octants, first window 1":
            lambda: mk.trace_path_mega_phased(
                fm.scene, rays, fm.cfg, tables=fm.tables, compact_every=3,
                seed=seed, octants=True, first_window=1),
        "compact after 1": lambda: mk.trace_path_mega_compact(
            fm.scene, rays, fm.cfg, tables=fm.tables, primary_steps=1,
            seed=seed)}
    for label, run in drivers.items():
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")     # no host sync inside
        try:
            out = run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        check(torch.equal(out, got), f"K10 {label}: differs from the "
              "monolithic launch")
        ms = cuda_ms(run, reps=1)[0]
        print(f"[stream] K10 {label}: bit-equal to the monolithic launch, "
              f"no host sync, {ms:.4f} ms")
        k10[label] = ms
    ph = mk.trace_path_mega_phased(fm.scene, rays, cfg8, tables=fm.tables,
                                   compact_every=2, samples=stream,
                                   octants=True)
    check(torch.equal(ph, got_inj), "K10 phased differs under injection")
    print("[stream] K10 phased, injected stream: bit-equal to monolithic")
    res["mega_window"] = k10
    # K6 over spheres: the 9,216-sphere field
    fs, rays_s = sphere_field_frame(dev)
    check(fs.tables.sph_seg.shape[0] == 5, "sphere field segments")
    ns = rays_s.origin.shape[0]
    stream = stream_from_generator(gen, ns, DEPTH, dev)
    st = mk.stream_tensor(stream, ns, DEPTH + 1)
    for integrator in INTEGRATORS:
        cfg = dataclasses.replace(fs.cfg, integrator=integrator)
        got = mk.trace_path_mega(fs.scene, rays_s, cfg, tables=fs.tables,
                                 samples=stream)
        err["mega_stream"] = max(err["mega_stream"], compare(
            f"K6 sphere_field {integrator} injected", got,
            mk.trace_path_mega_plain(fs.tables, rays_s, cfg, st)))
    res["sphere_field"] = timed_parity(
        "K6 sphere_field path in-kernel draws", fs, rays_s, fs.cfg,
        mk.draw_seed(gen), err, "mega_stream")
    res["sphere_field"].pop("got")
    # K6 at the ceiling: 2^16 rays of (n), lambert
    rays_n = first_chunk(fn, gen, middle_chunk(fn))
    rays_n = Rays(*(x[:N_BIG1M_CHECK] for x in rays_n))
    check(fn.tables.tri_seg.shape[0] == 510, "(n)'s segments")
    res["big1m"] = timed_parity(
        f"K6 big1m {N_BIG1M_CHECK} rays lambert", fn, rays_n, fn.cfg, 0,
        err, "mega_stream")
    res["big1m"].pop("got")
    for k in ("mega_stream", "mega_window", "mega_f2b"):
        res[k]["max_abs_err"] = err[k]
    return res


def mxu_frame(f: Frame) -> Frame:
    """f under cfg.mega_mxu, with Morton tables that hold K12's
    coefficients."""
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    return f._replace(name=f"{f.name}_mxu",
                      cfg=dataclasses.replace(f.cfg, mega_mxu=True),
                      tables=mk.morton_tables(f.scene, mxu=True))


def phase_mxu_parity(dev, sframes, mframes) -> dict:
    """K12 against the plain version on the card: (m)'s first 2^18 rays
    (path, lambert and normal on an injected stream, the path on in-kernel
    draws, timed beside monolithic K6 on the same rays), 2^16 rays of (n)
    (lambert), and the terrain's 2^18 rays under the reference quirks (the
    d.n block and the no-t-clip window); the phased driver bit-equal to
    the monolithic launch under K12, injected and in-kernel.  mframes:
    ``mxu_frame`` of each of ``sframes``."""
    from cudaraytracer_tpu_torch.config import RenderConfig
    from cudaraytracer_tpu_torch.core.rays import Rays, make_rays
    from cudaraytracer_tpu_torch.models import check_scenes as cs
    from cudaraytracer_tpu_torch.models.scene import SceneBuilder
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    from cudaraytracer_tpu_torch.ops.integrators import stream_from_generator
    fm, fn = mframes
    gen = torch.Generator(device=dev).manual_seed(41)
    err, res = {"mega_mxu": 0.0}, {}

    def injected(label, f, rays):
        n = rays.origin.shape[0]
        stream = stream_from_generator(gen, n, DEPTH, dev)
        st = mk.stream_tensor(stream, n, DEPTH + 1)
        out = None
        for integrator in INTEGRATORS:
            cfg = dataclasses.replace(f.cfg, integrator=integrator)
            got = mk.trace_path_mega(f.scene, rays, cfg, tables=f.tables,
                                     samples=stream)
            err["mega_mxu"] = max(err["mega_mxu"], compare(
                f"K12 {label} {integrator} injected", got,
                mk.trace_path_mega_plain(f.tables, rays, cfg, st)))
            out = got if integrator == "path" else out
        return stream, out

    rays = first_chunk(fm, gen)
    n = rays.origin.shape[0]
    check(n == 1 << 18 and fm.tables.tri_coef.numel() == (
        mk.N_COEF * fm.tables.tri.shape[0]), "(m)'s K12 tables")
    stream, got_inj = injected("big_field launch 0", fm, rays)
    seed = mk.draw_seed(gen)
    k12 = timed_parity("K12 big_field launch 0 path in-kernel draws", fm,
                       rays, fm.cfg, seed, err, "mega_mxu", hold=True)
    got = k12.pop("got")
    k6_ms, _ = cuda_ms(lambda: mk.trace_path_mega(
        sframes[0].scene, rays, sframes[0].cfg, tables=sframes[0].tables,
        seed=seed))
    k12["k6_ms_same_rays"] = k6_ms
    print(f"[mxu] (m)'s first 2^18 rays: K12 {k12['ms']:.4f} ms against "
          f"monolithic K6 {k6_ms:.4f} ms on the same rays and draws")
    for label, out in (
            ("in-kernel draws", mk.trace_path_mega_phased(
                fm.scene, rays, fm.cfg, tables=fm.tables, compact_every=2,
                seed=seed, octants=True)),
            ("injected stream", mk.trace_path_mega_phased(
                fm.scene, rays, fm.cfg, tables=fm.tables, compact_every=2,
                samples=stream, octants=True))):
        want = got if label == "in-kernel draws" else got_inj
        check(torch.equal(out, want), f"K12 phased ({label}) differs from "
              "the monolithic launch")
        print(f"[mxu] phased every 2, octants, {label}: bit-equal to the "
              "monolithic launch")
    res["big_field"] = k12
    rays_n = first_chunk(fn, gen, middle_chunk(fn))
    rays_n = Rays(*(x[:N_BIG1M_CHECK] for x in rays_n))
    res["big1m"] = timed_parity(
        f"K12 big1m {N_BIG1M_CHECK} rays lambert", fn, rays_n, fn.cfg, 0,
        err, "mega_mxu")
    res["big1m"].pop("got")
    scene = cs.fill_terrain(SceneBuilder()).build(dev)
    ft = Frame("terrain_mxu", scene, None, RenderConfig(
        max_depth=DEPTH, engine="mega", mega_mxu=True),
        mk.morton_tables(scene, mxu=True))
    check(ft.cfg.quirks.triangle_backface_only
          and ft.cfg.quirks.triangle_no_t_clip, "terrain under the "
          "reference quirks")
    rays_t = make_rays(*cs.terrain_rays(1 << 18), device=dev)
    injected("terrain reference quirks", ft, rays_t)
    res["terrain"] = timed_parity("K12 terrain reference quirks path "
                                  "in-kernel draws", ft, rays_t, ft.cfg,
                                  mk.draw_seed(gen), err, "mega_mxu")
    res["terrain"].pop("got")
    res["max_abs_err"] = err["mega_mxu"]
    return res


def render_mxu_cells(dev, mframes) -> tuple:
    """(q): (m) under mega_mxu through select_mega's route (compact_auto:
    phased every 2 bounces with octants, the shells forced off) and
    monolithic, each over the frame's rays in one call against its bound;
    (r): (n) under mega_mxu, lambert, and one frame-sized launch.  Each
    counted from zero; (q)'s two frames must be equal."""
    fm, fn = mframes
    out, launches, imgs = {}, {}, []
    for name, cfg, need in (
            ("default", fm.cfg, ("mega_mxu", "mega_window")),
            ("monolithic", dataclasses.replace(fm.cfg, compact_auto=False),
             ("mega_mxu",))):
        f = fm._replace(name=f"big_field_mxu_{name}", cfg=cfg)
        (ms, img, peak), l_r = counted(
            f"(q) big_field mega_mxu {name}",
            lambda: render_frame(dev, f, torch.Generator(
                device=dev).manual_seed(31)), need)
        check(l_r["mega_f2b"] == 0, "(q): K12 ran front-to-back shells")
        k = route_at_frame_shape(dev, f, torch.Generator(
            device=dev).manual_seed(32))
        print(f"[main] (q) big_field mega_mxu {name}: {ms / 1e3:.4f} "
              f"s/frame, peak {peak / 2 ** 30:.2f} GiB; the route over the "
              f"frame's {k['rays']} rays in one call {k['ms']:.3f} ms "
              f"({k['launches']} launches), bound {k['bound_ms']:.3f} ms "
              f"({k['bound_by']}), tests {k['tests']}")
        out[name] = {"frame_s": ms / 1e3, "peak_gib": peak / 2 ** 30,
                     "launches": l_r, "frame_launch": k}
        launches[f"q_{name}"] = l_r
        imgs.append(img)
    check(torch.equal(imgs[0], imgs[1]), "(q)'s two routes gave different "
          "frames")
    (ms_r, _, peak_r), l_r = counted(
        "(r) big1m mega_mxu, lambert",
        lambda: render_frame(dev, fn, torch.Generator(
            device=dev).manual_seed(33)), ("mega_mxu",))
    kr = kernel_at_frame_shape(dev, fn, torch.Generator(
        device=dev).manual_seed(34))
    coef = fn.tables.tri_coef.nbytes
    print(f"[main] (r) big1m mega_mxu: {ms_r / 1e3:.4f} s/frame, peak "
          f"{peak_r / 2 ** 30:.2f} GiB, coefficients {coef} B; one launch "
          f"over {kr['rays']} rays {kr['ms']:.3f} ms, bound "
          f"{kr['bound_ms']:.3f} ms ({kr['bound_by']}), tests {kr['tests']}")
    out["r_big1m"] = {"frame_s": ms_r / 1e3, "peak_gib": peak_r / 2 ** 30,
                      "coef_bytes": coef, "frame_launch": kr}
    launches["r"] = l_r
    return out, launches


# the last frame of each animation cell, by name (the BVH cells' agreement
# with the mega pipeline's)
LAST_FRAMES = {}


def animate_cell(dev, name: str, mesh, camera, pipeline: str = "mega",
                 frames: int = 31) -> dict:
    """(o), (p), (s), (t): ``frames`` frames of apps/animate.py's loop at
    its defaults (1024x512x4, depth 8, lambert, a PNG a frame) through
    ``pipeline``: the median update, per-frame table build and rendering
    s/frame, the CSV's build, peak memory; the last frame's mean and the
    share of its pixels on the red mesh must pass 10%."""
    import statistics

    from cudaraytracer_tpu_torch.apps import animate
    from cudaraytracer_tpu_torch.utils.csvlog import HEADER, MetricsLog
    csv = os.path.join(OUT_DIR, f"{name}.csv")
    args = animate.parse_args(["--out", os.path.join(OUT_DIR, name),
                               "--csv", csv, "--pipeline", pipeline,
                               "--frames", str(frames)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    run = animate.animate(mesh, args, camera=camera)
    peak = torch.cuda.max_memory_allocated(dev)
    rows = MetricsLog.read_csv(csv).rows
    check(rows[0] == HEADER and len(rows) == 2 + frames, f"{name}: CSV rows")
    med = {k: statistics.median(getattr(run, k))
           for k in ("update", "tables", "rendering")}
    img = run.image
    LAST_FRAMES[name] = img
    mean = float(img.mean())
    hit = float((img[..., 0] > img[..., 1]).mean())
    print(f"[main] {name}: {len(run.frames)} frames "
          f"{args.width}x{args.height}x{args.samples} {args.integrator} "
          f"--pipeline {pipeline}, median update {med['update']:.4f} s, "
          f"table build {med['tables']:.4f} s, rendering "
          f"{med['rendering']:.4f} s (tables included), build "
          f"{float(rows[1][3]):.4f} s, peak {peak / 2 ** 30:.2f} GiB; last "
          f"frame mean {mean:.4f}, on the mesh {hit:.2%}"
          + (f", {run.dropped} triangles dropped" if pipeline == "bonebvh"
             else ""))
    check(run.frames == list(range(frames)), f"{name}: frames {run.frames}")
    check(bool(np.isfinite(img).all()) and mean > 0.1 and hit > 0.1,
          f"{name}: mean {mean}, hit fraction {hit}")
    return {"pipeline": pipeline, "frames": len(run.frames),
            "median_update_s": med["update"],
            "median_tables_s": med["tables"],
            "median_rendering_s": med["rendering"],
            "build_s": float(rows[1][3]), "peak_gib": peak / 2 ** 30,
            "mean": mean, "hit_fraction": hit, "dropped": run.dropped}


def against_mega(name: str, mega: str) -> dict:
    """The pixels of cell ``name``'s last frame that differ from the mega
    pipeline's last frame (cell ``mega``, the same camera rays) by more
    than 1e-3 in a channel: at most max(2, n / 200) (silhouette rays whose
    winner an FMA-free rounding or the boxes' pad flips)."""
    a, b = LAST_FRAMES[name], LAST_FRAMES[mega]
    n = a.shape[0] * a.shape[1]
    differ = int((np.abs(a - b).max(axis=-1) > 1e-3).sum())
    limit = max(2, n // 200)
    print(f"[main] {name} against {mega} (--pipeline mega), last frame: "
          f"{differ} of {n} pixels differ by more than 1e-3 (limit {limit})")
    check(differ <= limit, f"{name}: {differ} pixels differ from mega")
    return {"pixels": n, "differ": differ, "limit": limit}


def animate_fbx_main() -> None:
    """apps/animate.py's main() on an ASCII FBX of the capsule's bind pose
    (3 frames), each of the mega, pallas, list, bvh and fused pipelines at
    256x128x2: the CSV's header and rows and a PNG a frame; bonebvh on the
    file, which has no skin, must raise the empty-forest error, as the JAX
    package's apps/animate.py does."""
    from cudaraytracer_tpu_torch.apps import animate
    from cudaraytracer_tpu_torch.models import check_scenes as cs
    from cudaraytracer_tpu_torch.utils.csvlog import HEADER, MetricsLog
    cap = cs.skinned_capsule()
    path = os.path.join(OUT_DIR, "capsule_bind.fbx")
    cs.write_ascii_fbx(path, cap.points, cap.faces, frames=3)
    for pipeline in ("mega", "pallas", "list", "bvh", "fused", "bonebvh"):
        out = os.path.join(OUT_DIR, f"fbx_{pipeline}")
        argv = ["--fbx", path, "--pipeline", pipeline, "--width", "256",
                "--height", "128", "--samples", "2", "--out", out, "--csv",
                out + ".csv"]
        if pipeline == "bonebvh":
            try:
                animate.main(argv)
            except ValueError as err:
                check("empty bone forest" in str(err), f"bonebvh: {err}")
                print("[main] animate.main --pipeline bonebvh on the "
                      "capsule's unskinned ASCII FBX raised: "
                      f"{str(err)[:60]}...")
                continue
            check(False, "bonebvh on an unskinned FBX did not raise")
        check(animate.main(argv) == 0, f"animate {pipeline}")
        rows = MetricsLog.read_csv(out + ".csv").rows
        check(rows[0] == HEADER and [r[0] for r in rows[1:]] == [
            "", "0", "1", "2"], f"animate {pipeline}: CSV rows {rows}")
        check(all(float(r[1]) > 0.0 for r in rows[2:]),
              f"animate {pipeline}: rendering times")
        check(sorted(os.listdir(out)) == [f"picture_{k}.png"
                                          for k in range(3)],
              f"animate {pipeline}: PNGs")
        print(f"[main] animate.main --pipeline {pipeline} on the capsule's "
              f"ASCII FBX: 3 frames, CSV and PNGs written")


def render_cli_bvh() -> dict:
    """apps/render.py --accel bvh through main(): the icosphere at (b)'s
    1280x720x8, path 8, fixed quirks, on the wavefront with the triangles
    through the BVH; its PNG written."""
    from cudaraytracer_tpu_torch.apps import render as app
    out = os.path.join(OUT_DIR, "icosphere_accel_bvh.png")
    t0 = time.perf_counter()
    check(app.main(["--scene", "icosphere", "--width", "1280", "--height",
                    "720", "--spp", "8", "--max-depth", str(DEPTH),
                    "--quirks", "fixed", "--accel", "bvh", "--out",
                    out]) == 0, "render --accel bvh")
    s = time.perf_counter() - t0
    check(os.path.getsize(out) > 0, "render --accel bvh: no PNG")
    print(f"[main] apps/render.py --accel bvh, icosphere 1280x720x8 path "
          f"{DEPTH}: {s:.3f} s through main() (the PNG included)")
    return {"s": s}


def route_at_frame_shape(dev, f: Frame, gen) -> dict:
    """f's route (select_mega under f.cfg) over the whole frame's rays in
    one call (its launches, and the regrouping between windows), timed;
    its tests counted by running the same route with the counting
    variant in every launch (``counting_cfg``: under K12, K6's)."""
    from cudaraytracer_tpu_torch.core.camera import generate_pixel_rays
    from cudaraytracer_tpu_torch.ops import integrators as integ
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    from cudaraytracer_tpu_torch.ops.render import swizzled_pixels
    c = f.cfg
    pix = swizzled_pixels(c.width, c.height, device=dev)
    rays = generate_pixel_rays(f.camera, c.width, c.height, c.samples, pix,
                               generator=gen)
    n = rays.origin.shape[0]
    ms, _ = cuda_ms(lambda: integ.integrate(f.scene, rays, c,
                                            tables=f.tables, seed=11),
                    reps=2)
    counts = torch.zeros(mk.N_COUNTS, dtype=torch.int64, device=dev)
    n_sc = f.tables.sph_box.shape[0]
    touched = torch.zeros(max(n_sc + f.tables.tri_box.shape[0], 1),
                          dtype=torch.uint8, device=dev)
    windows = []
    real = mk._trace

    def counting(tables, o, d, cfg, stream, seed, want_winners=False,
                 window=mk.WHOLE):
        alive = (None if window.planes is None or window.step_lo == 0 else
                 (window.planes[mk.PL_ALIVE] > 0.0).sum())
        windows.append((window, alive))
        return mk._launch_mega(tables, o.contiguous(), d.contiguous(),
                               counting_cfg(tables, cfg), stream, seed,
                               counts=counts, touched=touched, window=window)

    mk._trace = counting
    try:
        integ.integrate(f.scene, rays, c, tables=f.tables, seed=11)
    finally:
        mk._trace = real
    tests = counted_tests(counts, touched, n_sc)
    # K10's state: a window at step 0 writes every ray's 13 planes (52 B); a
    # later one reads every ray's alive flag and order entry (8 B, 4 with
    # no order), and a ray alive at its start reads its other 12 planes
    # (48 B) and writes all 13 back (52 B); a window that keys writes a key
    # for each ray it started or resumed (4 B), and the sort after it reads
    # the keys and writes the order (8 B a ray).  launch_bound counts the
    # camera rays in and the radiance out.
    k = len(windows)
    extra = 0
    for w, alive in windows:
        if w.planes is None:
            continue
        started = n if alive is None else int(alive)
        extra += (52 * n if alive is None else
                  (8 if w.order is not None else 4) * n + 100 * started)
        if w.key is not None:
            extra += 4 * started + 8 * n
    b, by = launch_bound(f.tables, n, tests, 12, extra, c)
    return {"ms": ms, "bound_ms": b, "bound_by": by, "tests": tests,
            "rays": n, "launches": k}


def render_routes(dev, fm: Frame) -> tuple:
    """(m) through its three routes, each counted from zero: the default
    (select_mega: phased every 2 bounces, octants, 8 shells), compact_auto
    off (monolithic K6) and monolithic with 8 shells; a fresh generator of
    one seed each, so the three frames must be equal bit for bit."""
    routes = (("default", fm.cfg, ("mega_stream", "mega_window", "mega_f2b")),
              ("monolithic", dataclasses.replace(fm.cfg, compact_auto=False),
               ("mega_stream",)),
              ("monolithic_f2b8", dataclasses.replace(
                  fm.cfg, compact_auto=False, mega_f2b_shells=8),
               ("mega_stream", "mega_f2b")))
    out, launches, imgs = {}, {}, []
    for name, cfg, need in routes:
        f = fm._replace(name=f"big_field_{name}", cfg=cfg)
        (ms, img, peak), l_r = counted(
            f"(m) big_field {name}",
            lambda: render_frame(dev, f, torch.Generator(
                device=dev).manual_seed(31)), need)
        k = route_at_frame_shape(dev, f, torch.Generator(
            device=dev).manual_seed(32))
        print(f"[main] (m) big_field {name}: {ms / 1e3:.4f} s/frame, peak "
              f"{peak / 2 ** 30:.2f} GiB; the route over the frame's "
              f"{k['rays']} rays in one call {k['ms']:.3f} ms "
              f"({k['launches']} launches), bound {k['bound_ms']:.3f} ms "
              f"({k['bound_by']}), tests {k['tests']}")
        out[name] = {"frame_s": ms / 1e3, "peak_gib": peak / 2 ** 30,
                     "launches": l_r, "frame_launch": k}
        launches[name] = l_r
        imgs.append(img)
    check(all(torch.equal(i, imgs[0]) for i in imgs),
          "(m)'s three routes gave different frames")
    print("[main] (m)'s three routes: equal frames")
    d, m8 = out["default"], out["monolithic_f2b8"]
    print(f"[main] (m) K10's window boundaries (the default route less "
          f"monolithic with 8 shells): "
          f"{d['frame_launch']['ms'] - m8['frame_launch']['ms']:.3f} ms "
          f"frame-sized, {d['frame_s'] - m8['frame_s']:.4f} s/frame")
    return out, launches


# The sweep launches of each main path by kind (camera or bounce)
KINDS = {}


def counted(name: str, fn, need, one_draw_per_trace: bool = False):
    """Run one main path with every launch count set to 0 just before it;
    read the counts just after and require a launch of each kernel in
    ``need``; one_draw_per_trace (a wavefront render without a gradient):
    require one K2 launch for each trace, as many as the trace's camera
    sweeps (the most camera launches of one sweep kind)."""
    from cudaraytracer_tpu_torch.ops import bvh
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    from cudaraytracer_tpu_torch.ops import sweeps as sw
    mk.reset_launch_counts()
    sw.reset_launch_counts()
    bvh.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    launches = {**mk.LAUNCHES, **sw.LAUNCHES, **bvh.LAUNCHES}
    print(f"[main] launches in {name}: {launches}")
    if any(sw.LAUNCHES.values()):
        KINDS[name] = {k: dict(v) for k, v in sw.LAUNCH_KINDS.items()}
        print(f"[main] sweep launches in {name} by kind: {KINDS[name]}")
    for k in need:
        check(launches[k] > 0, f"{name} never launched {k}")
    if one_draw_per_trace:
        traces = max(v.get("camera", 0) for v in sw.LAUNCH_KINDS.values())
        print(f"[main] {name}: {launches['scatter_draws']} scatter_draws "
              f"launches for {traces} traces")
        check(launches["scatter_draws"] == traces, f"{name}: "
              f"{launches['scatter_draws']} draws launches for {traces} "
              "traces")
    return out, launches


# ---------------------------------------------------------------------------
# Phase 7: the parallel layer (parallel/) and wavefront compaction
# ---------------------------------------------------------------------------

COMPACT_STEPS = (1, 4, 8)
# The parallel fit steps' rate: JAX's test_overlapped_grad_allreduce_
# matches_posthoc (tests/test_parallel.py:177), whose parameter tolerances
# they take; the gradients themselves are held by checks.regroup_limit,
# which does not depend on the rate
FIT_LR = 0.1


def bounce_states(scene, rays, stream, cfg, compact: bool) -> dict:
    """step -> (o, d, alive) at the start of each bounce of COMPACT_STEPS
    of a wavefront trace through sweep_intersector (the Morton scene its
    trace sorts to, its tables once), as trace_path runs it with
    cfg.wavefront_compact on or off; and the Morton scene and tables."""
    from cudaraytracer_tpu_torch.ops import integrators as integ
    from cudaraytracer_tpu_torch.ops.render import sweep_intersector
    fn = sweep_intersector(cfg)
    scene_m, _, _ = integ._morton_scene(scene)
    fn = integ._with_sweep_tables(scene_m, (fn,))[0]
    o, d, tm = rays
    n = o.shape[0]
    state = (o, d, tm, torch.ones(n, 3, device=o.device),
             torch.zeros(n, 3, device=o.device),
             torch.ones(n, dtype=torch.bool, device=o.device))
    idx = torch.arange(n, device=o.device)
    out = {}
    with torch.no_grad():
        for step in range(max(COMPACT_STEPS)):
            ball, prob = stream.ball[step], stream.prob[step]
            if compact:
                ball, prob = ball[idx], prob[idx]
            res = integ._bounce(scene_m, cfg, fn, step, None, None, *state,
                                ball, prob, idx if compact else None)
            state, idx = res[:6], (res[6] if compact else idx)
            if step + 1 in COMPACT_STEPS:
                out[step + 1] = (state[0], state[1], state[5])
    return out, scene_m, fn.keywords["tables"]


def compact_cell(dev) -> tuple:
    """(c)'s scene (random_spheres, 484 spheres) at 1920x1080x2, depth 8,
    reference quirks, on the wavefront through sweep_intersector with
    cfg.wavefront_compact off and on, one injected stream: the frames must
    be bit-equal; s/frame of each (min of 2 after a warm-up), and on the
    first 2^18 rays the alive share and K3's card time at the bounces of
    COMPACT_STEPS in each order -> (readings, the kernel launches of the
    two renders alone, not of the K3 timing)."""
    from cudaraytracer_tpu_torch.config import RenderConfig
    from cudaraytracer_tpu_torch.core.camera import generate_pixel_rays
    from cudaraytracer_tpu_torch.core.rays import Rays
    from cudaraytracer_tpu_torch.models import presets
    from cudaraytracer_tpu_torch.ops import sweeps as sw
    from cudaraytracer_tpu_torch.ops.integrators import (SampleStream,
                                                         stream_from_generator)
    from cudaraytracer_tpu_torch.ops.render import (render_image,
                                                    sweep_intersector,
                                                    swizzled_pixels)
    scene, cam = presets.random_spheres(aspect=1920 / 1080, device=dev)
    cfg = RenderConfig(width=1920, height=1080, samples=2, max_depth=DEPTH)
    gen = torch.Generator(device=dev).manual_seed(31)
    rays = generate_pixel_rays(cam, 1920, 1080, 2, swizzled_pixels(
        1920, 1080, device=dev), generator=gen)
    stream = stream_from_generator(gen, rays.origin.shape[0], DEPTH, dev)
    out, imgs = {}, {}

    def renders():
        for on in (False, True):
            c = dataclasses.replace(cfg, wavefront_compact=on)
            fn = sweep_intersector(c)
            with torch.no_grad():
                ms, imgs[on] = cuda_ms(lambda: render_image(
                    scene, cam, c, rays=rays, samples=stream,
                    intersect_fn=fn), reps=2)
            out["on_s_per_frame" if on else "off_s_per_frame"] = ms / 1e3

    _, launches = counted("(c) compacted", renders, ("sphere_sweep",))
    check(torch.equal(imgs[False], imgs[True]),
          "wavefront_compact changed the frame")
    n = cfg.ray_chunk
    first = Rays(*(x[:n] for x in rays))
    part = SampleStream(stream.ball[:, :n], stream.prob[:, :n])
    for on in (False, True):
        states, scene_m, tables = bounce_states(scene, first, part, cfg, on)
        sp = scene_m.spheres
        for step, (o, d, alive) in states.items():
            k3, _ = device_ms(lambda: sw.sphere_best_hit_raw(
                o, d, sp.center, sp.radius, cfg.t_min, cfg.t_max, True,
                alive, tables.sph))
            key = f"{'on' if on else 'off'}_step{step}"
            out[key + "_alive"] = float(alive.float().mean())
            out[key + "_k3_ms"] = k3
    out["bit_equal"] = True
    return out, launches


def summed_launches(outs: list) -> dict:
    """The kernel launches of each case of a spawn, summed over its ranks
    (``checks.run_cases`` counts only the case's sharded calls, each from
    0, never the single-process comparison)."""
    total = {}
    for o in outs:
        for label, counts in o["launches"].items():
            t = total.setdefault(label, dict.fromkeys(counts, 0))
            for k, v in counts.items():
                t[k] += v
    return total


def need_launches(launches: dict, label: str, need) -> None:
    for k in need:
        check(launches[label][k] > 0, f"[parallel] {label} never launched "
              f"{k}: {launches[label]}")


def phase_parallel(dev, smi: str) -> tuple:
    """Phase 7: wavefront compaction on (c)'s frame, then the parallel
    layer on the one card, its ranks spawned through gloo (they share the
    card) and one rank through NCCL: (returns its readings, the kernel
    launches by path)."""
    from cudaraytracer_tpu_torch.parallel import checks
    from cudaraytracer_tpu_torch.parallel.dryrun import (TOL,
                                                          dryrun_multichip)
    from cudaraytracer_tpu_torch.parallel.mesh import choose_backend, spawn
    t0 = time.perf_counter()
    res, per_path = {}, {}
    res["compact"], per_path["parallel_compact"] = compact_cell(dev)
    check(choose_backend(2, dev) == "gloo" and choose_backend(1, dev)
          == "nccl", "the backend rule on a one-card machine")
    rs = ("preset", "random_spheres", {"aspect": 1920 / 1080})
    c_cfg = dict(width=1920, height=1080, samples=2, max_depth=DEPTH)
    field = ("check", "big_field_scene", {"aspect": 1280 / 720})
    m_cfg = dict(width=1280, height=720, samples=1, max_depth=DEPTH,
                 quirks="fixed", wavefront_sphere_cull="primary")
    three = ("preset", "three_spheres", {"aspect": 2.0})
    e_cfg = dict(width=512, height=256, samples=4, max_depth=4, gamma=False)
    fit = dict(scene=three, names=("centers", "albedo"), inject=("seed", 6),
               cfg=e_cfg, reps=3, lr=FIT_LR, deterministic=True)
    two = [("dp_wavefront", "render", dict(
               scene=rs, cfg=c_cfg, tp=1, inject=("seed", 11),
               isect="sweeps", timed=True)),
           ("dp_mega", "render", dict(
               scene=rs, cfg=dict(c_cfg, engine="mega"), tp=1,
               inject=("seed", 11), timed=True)),
           ("tp_first_hits", "first_hits", dict(
               scene=field, cfg=m_cfg, tp=2, seed=5)),
           ("tp_render", "render", dict(
               scene=field, cfg=m_cfg, tp=2, inject=("seed", 5),
               timed=True)),
           ("sample_parallel", "sample_parallel", dict(
               scene=rs, cfg=c_cfg, tp=1, seed=13, isect="sweeps")),
           ("fit_dp2", "fit_step", dict(fit, tp=1, grad_scale=True))]
    outs = spawn(checks.run_cases, 2, (two,), device=dev)
    r2, l2 = outs[0], summed_launches(outs)
    for label in ("dp_wavefront", "dp_mega"):
        o = r2[label]
        check(np.array_equal(o["img"], o["single"]),
              f"[parallel] {label}: dp = 2 differs from one process")
        res[label] = {"s_per_frame": o["s"], "single_s": o["single_s"],
                      "bit_equal": True}
    need_launches(l2, "dp_wavefront", ("sphere_sweep",))
    need_launches(l2, "dp_mega", ("mega_trace",))
    fh = r2["tp_first_hits"]
    limit = max(2, fh["rays"] // 10 ** 4)
    check(fh["differ"] <= limit and fh["other"] == 0,
          f"[parallel] tp = 2 first hits: {fh}")
    res["tp_first_hits"] = dict(fh, limit=limit)
    tr = r2["tp_render"]
    px = int((np.abs(tr["img"] - tr["single"]) > 1e-3).any(-1).sum())
    px_limit = max(2, tr["img"].shape[0] * tr["img"].shape[1] // 200)
    check(px <= px_limit, f"[parallel] tp = 2 render: {px} pixels over 1e-3")
    res["tp_render"] = {"s_per_frame": tr["s"], "single_s": tr["single_s"],
                        "pixels_over_1e-3": px, "limit": px_limit}
    need_launches(l2, "tp_render", ("triangle_sweep",))
    sp = r2["sample_parallel"]
    d_sp = float(np.abs(sp["img"] - sp["ref"]).max())
    check(d_sp <= 1e-6, f"[parallel] sample-parallel off by {d_sp}")
    res["sample_parallel"] = {"max_abs": d_sp, "s_per_frame": sp["s"]}
    need_launches(l2, "sample_parallel", ("sphere_sweep", "scatter_draws"))

    def fit_check(label, o, aligned):
        """The compared steps made under deterministic algorithms
        (``checks.fit_step``; the timings under the default ones): the
        single process must repeat itself bit for bit; loss rtol 1e-6 and params within
        JAX's tolerance (as a share of it, <= 1) for every pair; with
        ``aligned`` (the single process's chunks are the ranks' tiles) the
        post-hoc step within checks.regroup_limit of the single process
        (as a share, <= 1).  grad_rel: the gradients' difference over
        their largest entry, reported."""
        got = {"mesh": o["mesh"]}
        a, r = o["single_again"], o["single"]
        same = a["loss"] == r["loss"] and all(
            np.array_equal(x, y) for x, y in zip(a["params"], r["params"]))
        got["single_repeats"] = same
        check(same, f"[parallel] {label}: the single-process step did not "
              "repeat itself under deterministic algorithms")
        pairs = [("overlapped", "posthoc"), ("overlapped", "single"),
                 ("posthoc", "single")]
        for mode, ref in pairs:
            a, r = o[mode], o[ref]
            lrel = abs(a["loss"] - r["loss"]) / abs(r["loss"])
            share = max(float((np.abs(x - y) / (1e-7 + 1e-5 * np.abs(y)))
                              .max()) for x, y in zip(a["params"],
                                                      r["params"]))
            grel = max(float(np.abs(x - y).max() / np.abs(s0 - y).max())
                       for x, y, s0 in zip(a["params"], r["params"],
                                           o["start"]))
            row = {"loss_rel": lrel, "tol_share": share, "grad_rel": grel}
            ok = lrel <= 1e-6 and share <= 1.0
            if aligned and (mode, ref) == ("posthoc", "single"):
                lim = checks.regroup_limit(o, mode, ref, FIT_LR)
                row["regroup_share"] = max(
                    float((np.abs(x - y) / m).max())
                    for x, y, m in zip(a["params"], r["params"], lim))
                ok = ok and row["regroup_share"] <= 1.0
            got[f"{mode}_vs_{ref}"] = row
            check(ok, f"[parallel] {label}: {mode} against {ref}: {row}")
        for mode in ("overlapped", "posthoc", "single"):
            got[f"{mode}_s_per_step"] = o[mode]["s"]
        return got

    # dp = 2: each rank's tile is one default chunk (2^18 rays)
    res["fit_dp2"] = fit_check("fit dp = 2", r2["fit_dp2"], True)
    need_launches(l2, "fit_dp2", ("sphere_sweep_attrs",))
    # 2 x 2 at the default chunk (the process sums two tiles in one chunk)
    # and with the chunks sized to the tiles (2^17 rays)
    aligned = dict(fit, tp=2, grad_scale=True,
                   cfg=dict(e_cfg, ray_chunk=1 << 17))
    outs4 = spawn(checks.run_cases, 4, ([
        ("fit_2x2", "fit_step", dict(fit, tp=2)),
        ("fit_2x2_aligned", "fit_step", aligned)],), device=dev)
    res["fit_2x2"] = fit_check("fit 2 x 2", outs4[0]["fit_2x2"], False)
    res["fit_2x2_aligned"] = fit_check(
        "fit 2 x 2, chunks = tiles", outs4[0]["fit_2x2_aligned"], True)
    l4 = summed_launches(outs4)
    need_launches(l4, "fit_2x2", ("sphere_sweep_attrs",))
    need_launches(l4, "fit_2x2_aligned", ("sphere_sweep_attrs",))
    outs1 = spawn(checks.run_cases, 1, ([
        ("nccl_fit", "fit_step", dict(fit, tp=1, grad_scale=True)),
        ("nccl_render", "render", dict(scene=rs, cfg=c_cfg, tp=1,
                                       inject=("seed", 11),
                                       isect="sweeps"))],), device=dev)
    r1, l1 = outs1[0], summed_launches(outs1)
    res["nccl_fit"] = fit_check("NCCL fit", r1["nccl_fit"], True)
    check(np.array_equal(r1["nccl_render"]["img"],
                         r1["nccl_render"]["single"]),
          "[parallel] the NCCL render differs from one process")
    res["nccl_render"] = {"s_per_frame": r1["nccl_render"]["s"],
                          "bit_equal": True}
    need_launches(l1, "nccl_render", ("sphere_sweep",))
    td = time.perf_counter()
    dry = dryrun_multichip(4, dev)
    res["dryrun_4"] = {"mesh": dry["mesh"], "loss": dry["loss"],
                       "mega_vs_wavefront": dry["mega_vs_wavefront"],
                       "sample_parallel_vs_single":
                           dry["sample_parallel_vs_single"], "tol": TOL,
                       "s": time.perf_counter() - td}
    for label, l in (("2", l2), ("4", l4), ("1_nccl", l1)):
        for case, counts in l.items():
            per_path[f"parallel_{label}_{case}"] = counts
    res["seconds"] = time.perf_counter() - t0
    print(f"[parallel] {smi}: {json.dumps(res)}")
    return res, per_path


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from cudaraytracer_tpu_torch.config import Quirks
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    from cudaraytracer_tpu_torch.ops.integrators import stream_from_generator
    from cudaraytracer_tpu_torch.ops.render import render_image
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"[env] device {kind}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    print(smi)
    os.makedirs(OUT_DIR, exist_ok=True)

    phase_build()
    frames = main_frames(dev)
    fa, fb = frames
    xframes = xform_frames(dev)
    fh, fs, fi = xframes
    parity = phase_parity(dev, frames)
    xparity = phase_xform_parity(dev, xframes)
    xedges = phase_xform_edges(dev, fi)
    margins = phase_margins(dev)
    wparity = phase_winner_parity(dev, fa)
    tframes = tex_frames(dev)
    fj, fk, fl = tframes
    tparity = phase_tex_parity(dev, tframes)
    sframes = stream_frames(dev)
    fm, fn = sframes
    sparity = phase_stream_parity(dev, sframes)
    bvh_res = phase_bvh(dev, fb, fm, fn)
    mframes = [mxu_frame(f) for f in sframes]
    mparity = phase_mxu_parity(dev, sframes, mframes)
    sweeps = phase_sweep_parity(dev, frames)
    draws = phase_draws(dev, fa.cfg.ray_chunk)
    winner = phase_winner_add(dev)
    phase_cross_engine(dev, [(fa, 0), (fb, middle_chunk(fb)), (fh, 0),
                             (fs, 0), (fj, middle_chunk(fj)),
                             (fk, middle_chunk(fk)), (fl, 0)])
    grad_rel, g_wave = fit_grad_parity(dev)
    grad_rel_m, g_mega = fit_grad_parity(dev, "mega_diff")
    grad_rel_l, _ = fit_grad_parity(dev, "mega_diff", "textured_globe")
    cross_rel = max(float((g_mega[k] - g_wave[k]).abs().max())
                    / float(g_wave[k].abs().max()) for k in g_wave)
    print(f"[fit] first-step grads on the card, mega_diff vs wavefront: max "
          f"rel {cross_rel:.3g}")
    check(cross_rel <= GRAD_RTOL, "mega_diff and wavefront gradients differ")
    print(f"[phase] parity and cross-engine checks done at "
          f"{time.perf_counter() - t_start:.1f} s")

    # ---- the main paths, each counted from zero ----
    gen = torch.Generator(device=dev).manual_seed(2024)
    n_a = fa.cfg.width * fa.cfg.height * fa.cfg.samples

    def fused():
        ra = render_frame(dev, fa, gen)
        rb = render_frame(dev, fb, gen)
        stream = stream_from_generator(gen, n_a, DEPTH, dev)
        inj = render_image(fa.scene, fa.camera, fa.cfg, generator=gen,
                           tables=fa.tables, samples=stream)
        return ra, rb, inj

    ((ms_a, img_a, peak_a), (ms_b, _, peak_b), img_inj), l_ab = counted(
        "(a) and (b), fused", fused, ("mega_trace",))
    per = fa.cfg.ray_chunk // fa.cfg.samples
    print(f"[main] {-(-fa.cfg.width * fa.cfg.height // per)} mega_trace "
          f"per 1920x1080x16 frame")
    mean_a = img_a.reshape(-1, 3).mean(0)
    mean_inj = img_inj.reshape(-1, 3).mean(0)
    rel = ((mean_a - mean_inj).abs() / mean_inj).max()
    print(f"[main] random_spheres in-kernel Philox vs injected torch stream: "
          f"channel means {mean_a.tolist()} vs {mean_inj.tolist()} "
          f"(max rel {float(rel):.4%})")
    check(float(rel) <= 0.02, "in-kernel draws bias the image")

    (ms_c, img_c, peak_c), l_c = counted(
        "(c) random_spheres, wavefront",
        lambda: render_wavefront(dev, fa, gen),
        ("sphere_sweep", "scatter_draws"), True)
    mean_c = img_c.reshape(-1, 3).mean(0)
    rel = ((mean_c - mean_a).abs() / mean_a).max()
    print(f"[main] random_spheres wavefront vs fused channel means "
          f"{mean_c.tolist()} vs {mean_a.tolist()} (max rel "
          f"{float(rel):.4%})")
    check(float(rel) <= 0.02, "the wavefront and fused images disagree")
    (ms_d, _, peak_d), l_d = counted(
        "(d) icosphere, wavefront", lambda: render_wavefront(dev, fb, gen),
        ("sphere_sweep", "triangle_sweep", "scatter_draws"), True)
    fit, l_e = counted("(e) fit", lambda: run_fit(dev),
                       ("sphere_sweep_attrs", "scatter_draws", "winner_add"))
    fit_f, l_f = counted("(f) mega_diff fit",
                         lambda: run_fit(dev, "mega_diff"),
                         ("mega_winners", "scatter_draws"))
    print(f"[main] (f) mega_diff {fit_f['s_per_step']:.4f} s/step beside (e) "
          f"wavefront {fit['s_per_step']:.4f} s/step")
    mdiff, l_g = counted("(g) random_spheres mega_diff forward",
                         lambda: render_mega_diff(dev, fa, gen),
                         ("mega_trace", "mega_winners"))
    (ms_h, img_h, peak_h), l_h = counted(
        "(h) light_box fused", lambda: render_frame(dev, fh, gen),
        ("mega_trace_xform",))
    (ms_hw, img_hw, peak_hw), l_hw = counted(
        "(h) light_box wavefront", lambda: render_wavefront(dev, fh, gen),
        ("sphere_sweep", "scatter_draws"), True)
    mean_h = img_h.reshape(-1, 3).mean(0)
    rel = ((img_hw.reshape(-1, 3).mean(0) - mean_h).abs() / mean_h).max()
    print(f"[main] light_box wavefront vs fused channel means: max rel "
          f"{float(rel):.4%}")
    check(float(rel) <= 0.02, "light_box: the wavefront and fused images "
          "disagree")
    (ms_i, _, peak_i), l_i = counted(
        "(i) TRS field fused", lambda: render_frame(dev, fi, gen),
        ("mega_trace_xform",))

    def tex_spheres():
        out = render_frame(dev, fj, gen)
        rays = first_chunk(fj, gen, middle_chunk(fj))
        rad = mk.trace_path_mega(fj.scene, rays, dataclasses.replace(
            fj.cfg, quirks=Quirks.reference()), tables=fj.tables,
            generator=gen)
        check(bool(torch.isfinite(rad).all()), "(j) reference launch")
        return out

    (ms_j, img_j, peak_j), l_j = counted(
        "(j) tex_spheres fused", tex_spheres, ("mega_trace_tex",))
    (ms_k, img_k, peak_k), l_k = counted(
        "(k) tex_icosphere fused", lambda: render_frame(dev, fk, gen),
        ("mega_trace_tex",))
    (ms_kw, img_kw, peak_kw), l_kw = counted(
        "(k) tex_icosphere wavefront", lambda: render_wavefront(dev, fk, gen),
        ("sphere_sweep", "triangle_sweep", "scatter_draws"), True)
    mean_k = img_k.reshape(-1, 3).mean(0)
    rel = ((img_kw.reshape(-1, 3).mean(0) - mean_k).abs() / mean_k).max()
    print(f"[main] tex_icosphere wavefront vs fused channel means: max rel "
          f"{float(rel):.4%}")
    check(float(rel) <= 0.02, "tex_icosphere: the wavefront and fused "
          "images disagree")
    (ms_l, _, peak_l), l_l = counted(
        "(l) textured_globe fused", lambda: render_frame(dev, fl, gen),
        ("mega_trace_tex", "mega_trace_xform"))
    mdiff_l, l_lg = counted("(l) textured_globe mega_diff forward",
                            lambda: render_mega_diff(dev, fl, gen),
                            ("mega_trace_tex", "mega_winners"))
    fit_l, l_lf = counted("(l) textured_globe mega_diff fit step",
                          lambda: tex_fit_step(dev),
                          ("mega_trace_tex", "mega_winners",
                           "scatter_draws"))
    routes_m, l_m = render_routes(dev, fm)
    (ms_n, _, peak_n), l_n = counted(
        "(n) big1m fused, lambert", lambda: render_frame(dev, fn, gen),
        ("mega_stream",))
    kn = kernel_at_frame_shape(dev, fn, gen)
    print(f"[main] (n) big1m: {ms_n / 1e3:.4f} s/frame, peak "
          f"{peak_n / 2 ** 30:.2f} GiB; one launch over {kn['rays']} rays "
          f"{kn['ms']:.3f} ms, bound {kn['bound_ms']:.3f} ms "
          f"({kn['bound_by']}), tests {kn['tests']}")
    frames_pt = {name: frame_against_per_thread(dev, f, gen) for name, f in (
        ("m", fm), ("m_f2b8", fm._replace(cfg=dataclasses.replace(
            fm.cfg, mega_f2b_shells=8))))}
    mxu_cells, l_qr = render_mxu_cells(dev, mframes)
    from cudaraytracer_tpu_torch.models import check_scenes as cs
    cell_o, l_o = counted(
        "(o) skinned_capsule, animate --pipeline mega",
        lambda: animate_cell(dev, "skinned_capsule", cs.skinned_capsule(),
                             None), ("mega_trace",))
    cell_p, l_p = counted(
        "(p) skinned_field, animate --pipeline mega",
        lambda: animate_cell(dev, "skinned_field", cs.skinned_field(),
                             cs.field_camera(2.0, device=dev)),
        ("mega_stream",))
    cell_s, l_s = counted(
        "(s) skinned_capsule, animate --pipeline bvh",
        lambda: animate_cell(dev, "skinned_capsule_bvh",
                             cs.skinned_capsule(), None, "bvh"),
        ("bvh_traverse",))
    cell_s["against_mega"] = against_mega("skinned_capsule_bvh",
                                          "skinned_capsule")
    cell_sf, l_sf = counted(
        "(s) skinned_capsule, animate --pipeline fused, 3 frames",
        lambda: animate_cell(dev, "skinned_capsule_fused",
                             cs.skinned_capsule(), None, "fused", 3),
        ("bvh_traverse",))
    cell_t = {}
    l_t = {}
    for pipeline in ("bonebvh", "bvh"):
        name = f"skinned_field_{pipeline}"
        cell_t[pipeline], l_t[f"t_{pipeline}"] = counted(
            f"(t) skinned_field, animate --pipeline {pipeline}",
            lambda: animate_cell(dev, name, cs.skinned_field(),
                                 cs.field_camera(2.0, device=dev),
                                 pipeline), ("bvh_traverse",))
        cell_t[pipeline]["against_mega"] = against_mega(name,
                                                        "skinned_field")
    _, l_fbx = counted("animate.main on an ASCII FBX", animate_fbx_main,
                       ("mega_trace", "triangle_sweep", "bvh_traverse"))
    accel_bvh, l_accel = counted("apps/render.py --accel bvh",
                                 render_cli_bvh, ("bvh_traverse",))
    parallel, l_parallel = phase_parallel(dev, smi)
    per_path = {"a_b": l_ab, "c": l_c, "d": l_d, "e": l_e, "f": l_f,
                "g": l_g, "h_fused": l_h, "h_wavefront": l_hw, "i": l_i,
                "j": l_j, "k_fused": l_k, "k_wavefront": l_kw,
                "l_fused": l_l, "l_mega_diff": l_lg, "l_fit": l_lf,
                **{f"m_{k}": v for k, v in l_m.items()}, "n": l_n,
                "o": l_o, "p": l_p, "s": l_s, "s_fused": l_sf, **l_t,
                "animate_fbx": l_fbx, "accel_bvh": l_accel, **l_qr,
                **l_parallel}
    launches = {k: sum(p[k] for p in per_path.values()) for k in l_ab}
    # the replay's divergence from the recorded path, (g) and (l): the
    # replay takes its decisions and rays from the plain version, so none
    replay_g = replay_divergence(dev, fa)
    replay_l = replay_divergence(dev, fl)
    check(replay_g == 0 and replay_l == 0, "the mega_diff replay left the "
          "recorded path")

    # ---- the fused kernel alone over a whole frame's rays ----
    ka = kernel_at_frame_shape(dev, fa, gen)
    kb = kernel_at_frame_shape(dev, fb, gen)
    for f, k in ((fa, ka), (fb, kb)):
        print(f"[kernel] {f.name}: one launch over {k['rays']} rays "
              f"{k['ms']:.3f} ms, bound {k['bound_ms']:.3f} ms "
              f"({k['bound_by']}), tests {k['tests']}")
    ca, cb = parity["random_spheres"], parity["icosphere"]
    mega = {"name": "mega_trace", "route": "cuda",
            "source": "cudaraytracer_tpu_torch/csrc/megakernel.cuh",
            "replaces": "cudaraytracer_tpu/ops/megakernel.py:476",
            "launches": launches["mega_trace"],
            "max_abs_err": parity["max_abs_err"],
            "ms": ca["ms"], "call_ms": ca["call_ms"],
            "plain_ms": ca["plain_ms"],
            "bound_ms": ca["bound_ms"], "bound_by": ca["bound_by"],
            "library_ms": None,
            "ms_at": "one main-path launch: the first 262144-ray chunk of "
                     "random_spheres 1920x1080x16, path 8, in-kernel draws",
            "lane_use": ca["lane_use"],
            "bound_no_draws_ms": ca["bound_no_draws_ms"],
            **{k: ca[k] for k in INSTANCE_KEYS},
            "tests": ca["tests"], "margins": margins,
            "icosphere_chunk": cb,
            "frame_launch": {"random_spheres": ka, "icosphere": kb},
            "frame_s": ms_a / 1e3, "icosphere_frame_s": ms_b / 1e3,
            "peak_gib": peak_a / 2 ** 30,
            "icosphere_peak_gib": peak_b / 2 ** 30}
    draws["launches"] = launches["scatter_draws"]
    winner["launches"] = launches["winner_add"]
    rows = [mega, draws, winner]
    for name, line in (("sphere_sweep", 181), ("sphere_sweep_attrs", 314),
                       ("triangle_sweep", 645)):
        k = sweeps[name]
        cam, bnc = k.pop("camera"), k.pop("bounce")
        rows.append({
            "name": name, "route": "cuda",
            "source": "cudaraytracer_tpu_torch/csrc/sweeps.cu",
            "replaces": f"cudaraytracer_tpu/ops/pallas_intersect.py:{line}",
            "launches": launches[name], "max_abs_err": k.pop("max_abs_err"),
            "ms": cam.pop("ms"), "plain_ms": cam.pop("plain_ms"),
            "bound_ms": cam.pop("bound_ms"), "bound_by": cam.pop("bound_by"),
            "library_ms": None, "bounce_ms": bnc["ms"],
            "bounce_bound_ms": bnc["bound_ms"],
            "bound_one_level_ms": cam["bound_one_level_ms"],
            "bounce_bound_one_level_ms": bnc["bound_one_level_ms"],
            "lane_use": bnc["lane_use"],
            "registers": cam["registers"], "spill_bytes": cam["spill_bytes"],
            "launch_kinds": {p: KINDS[p][name] for p in KINDS},
            "camera": cam, "bounce": bnc, **k})
    xh, xs, xi = (xparity[f.name] for f in xframes)
    rows.append({
        "name": "mega_winners", "route": "cuda",
        "source": "cudaraytracer_tpu_torch/csrc/megakernel.cuh",
        "replaces": "cudaraytracer_tpu/ops/megakernel.py:1445",
        "launches": launches["mega_winners"],
        "max_abs_err": wparity.pop("max_abs_err"), "ms": wparity.pop("ms"),
        "plain_ms": wparity.pop("plain_ms"),
        "bound_ms": wparity.pop("bound_ms"),
        "bound_by": wparity.pop("bound_by"), "library_ms": None,
        "ms_at": "(g)'s first launch: 262144 rays of random_spheres "
                 "1920x1080x16, path 8, in-kernel draws, recording the "
                 "winners", **wparity})
    rows.append({
        "name": "mega_trace_xform", "route": "cuda",
        "source": "cudaraytracer_tpu_torch/csrc/megakernel.cuh",
        "replaces": "cudaraytracer_tpu/ops/megakernel.py:1186",
        "launches": launches["mega_trace_xform"],
        "max_abs_err": max(xparity["max_abs_err"], xedges["max_abs_err"]),
        "ms": xh["ms"],
        "call_ms": xh["call_ms"],
        "plain_ms": xh["plain_ms"], "bound_ms": xh["bound_ms"],
        "bound_by": xh["bound_by"], "library_ms": None,
        "ms_at": "(h)'s first launch: 262144 rays of light_box 1280x720x16, "
                 "path 8, in-kernel draws",
        **{k: xh[k] for k in INSTANCE_KEYS},
        "tests": xh["tests"], "trs_showcase": xs, "trs_field_2_16": xi,
        "trs_field_2_18": xparity["trs_field_2_18"],
        "h_frame_s": ms_h / 1e3, "i_frame_s": ms_i / 1e3})
    tj = tparity.pop(f"tex_spheres fixed launch {middle_chunk(fj)}")
    rows.append({
        "name": "mega_trace_tex", "route": "cuda",
        "source": "cudaraytracer_tpu_torch/csrc/megakernel.cuh",
        "replaces": "cudaraytracer_tpu/ops/megakernel.py:1574",
        "launches": launches["mega_trace_tex"],
        "max_abs_err": tparity.pop("max_abs_err"),
        "texel_flips": tparity.pop("flips"), "ms": tj["ms"],
        "call_ms": tj["call_ms"],
        "plain_ms": tj["plain_ms"], "bound_ms": tj["bound_ms"],
        "bound_by": tj["bound_by"], "library_ms": None,
        "ms_at": f"(j)'s launch {middle_chunk(fj)}: 262144 rays of "
                 "random_spheres with images 1920x1080x16, path 8, fixed "
                 "quirks, in-kernel draws",
        "lane_use": tj["lane_use"],
        "bound_no_draws_ms": tj["bound_no_draws_ms"],
        **{k: tj[k] for k in INSTANCE_KEYS},
        "const_tex_ms": tj["const_tex_ms"], "texels": tj["texels"],
        "tests": tj["tests"], "other_launches": tparity,
        "j_frame_s": ms_j / 1e3, "k_frame_s": ms_k / 1e3,
        "l_frame_s": ms_l / 1e3})
    for key, line, what in (
            ("mega_stream", 919, "(m)'s first launch: 262144 rays of the "
             "128,000-triangle field 1280x720x8, path 8, fixed quirks, "
             "in-kernel draws, 63 segments, table order"),
            ("mega_window", 1607, "(m)'s first 262144 rays, the window [2, 4) "
             "resumed in place from the planes of [0, 2), in the order their "
             "octant keys sort to (the default route's), in-kernel draws; "
             "ray_id_order_ms: in ray-id order, as earlier PRs timed it"),
            ("mega_f2b", 795, "(m)'s first launch with 8 front-to-back "
             "shells over its 63 segments, in-kernel draws")):
        k = sparity.pop(key)
        k.pop("rays")
        rows.append({
            "name": key, "route": "cuda",
            "source": "cudaraytracer_tpu_torch/csrc/megakernel.cuh",
            "replaces": f"cudaraytracer_tpu/ops/megakernel.py:{line}",
            "launches": launches[key], "max_abs_err": k.pop("max_abs_err"),
            "ms": k.pop("ms"), "plain_ms": k.pop("plain_ms"),
            "bound_ms": k.pop("bound_ms"), "bound_by": k.pop("bound_by"),
            "library_ms": None, "ms_at": what, **k})
    rows[-3]["other_launches"] = sparity
    k12 = mparity["big_field"]
    k12.pop("rays")
    rows.append({
        "name": "mega_mxu", "route": "cuda",
        "source": "cudaraytracer_tpu_torch/csrc/megakernel.cuh",
        "replaces": "cudaraytracer_tpu/ops/megakernel.py:974",
        "launches": launches["mega_mxu"],
        "max_abs_err": mparity["max_abs_err"], "ms": k12.pop("ms"),
        "plain_ms": k12.pop("plain_ms"), "bound_ms": k12.pop("bound_ms"),
        "bound_by": k12.pop("bound_by"), "library_ms": None,
        "ms_at": "(m)'s first launch under mega_mxu: 262144 rays of the "
                 "128,000-triangle field 1280x720x8, path 8, fixed quirks, "
                 "in-kernel draws, 63 segments",
        **k12, "big1m_2_16": mparity["big1m"],
        "terrain_2_18": mparity["terrain"]})
    tm = bvh_res["timing"]["m"]
    rows.append({
        "name": "bvh_traverse", "route": "cuda",
        "source": "cudaraytracer_tpu_torch/csrc/bvh.cu",
        "replaces": "cudaraytracer_tpu/ops/bvh.py:296",
        "replaces_note": "no pallas_call: traverse_bvh's lax.while_loop",
        "launches": launches["bvh_traverse"],
        "max_abs_err": bvh_res["max_abs_err"], "ms": tm["ms"],
        "call_ms": tm["call_ms"], "plain_ms": tm["plain_ms"],
        "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
        "library_ms": None,
        "ms_at": "(m)'s first 262144 rays, the 128,000-triangle field, "
                 "fixed quirks (shrink), the native builder's tree",
        **{k: v for k, v in bvh_res.items() if k != "max_abs_err"}})
    paths = {"c_wavefront_frame_s": ms_c / 1e3, "c_peak_gib": peak_c / 2 ** 30,
             "d_wavefront_frame_s": ms_d / 1e3, "d_peak_gib": peak_d / 2 ** 30,
             "e_fit": fit, "fit_grad_rel_card_vs_cpu": grad_rel,
             "f_mega_diff_fit": fit_f,
             "f_grad_rel_card_vs_cpu": grad_rel_m,
             "f_grad_rel_mega_diff_vs_wavefront": cross_rel,
             "g_mega_diff_forward": mdiff,
             "h_fused_frame_s": ms_h / 1e3, "h_fused_peak_gib": peak_h / 2 ** 30,
             "h_wavefront_frame_s": ms_hw / 1e3,
             "h_wavefront_peak_gib": peak_hw / 2 ** 30,
             "i_fused_frame_s": ms_i / 1e3, "i_peak_gib": peak_i / 2 ** 30,
             "j_fused_frame_s": ms_j / 1e3, "j_peak_gib": peak_j / 2 ** 30,
             "k_fused_frame_s": ms_k / 1e3, "k_peak_gib": peak_k / 2 ** 30,
             "k_wavefront_frame_s": ms_kw / 1e3,
             "k_wavefront_peak_gib": peak_kw / 2 ** 30,
             "l_fused_frame_s": ms_l / 1e3, "l_peak_gib": peak_l / 2 ** 30,
             "l_mega_diff_forward": mdiff_l, "l_mega_diff_fit": fit_l,
             "l_grad_rel_card_vs_cpu": grad_rel_l,
             "replay_divergence": {"g": replay_g, "l": replay_l},
             "m_big_field": routes_m,
             "n_big1m": {"frame_s": ms_n / 1e3, "peak_gib": peak_n / 2 ** 30,
                         "frame_launch": kn},
             "frame_sized_coop_against_per_thread": frames_pt,
             "o_skinned_capsule": cell_o, "p_skinned_field": cell_p,
             "s_skinned_capsule_bvh": cell_s,
             "s_skinned_capsule_fused_3": cell_sf,
             "t_skinned_field": cell_t, "accel_bvh": accel_bvh,
             "q_big_field_mxu": {k: v for k, v in mxu_cells.items()
                                 if k != "r_big1m"},
             "r_big1m_mxu": mxu_cells["r_big1m"],
             "parallel": parallel,
             "launches_per_path": per_path}
    print(f"[paths] {json.dumps(paths)}")
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def ab_main(root: str, only: str = "") -> int:
    """``--ab``: the timings that compare two commits on one card, for the
    package of the checkout at ``root``: ``ab_fused`` (K1, K7, K8, K9 and
    (a)'s frame), then (l)'s mega_diff fit step (min and median of 5), K12,
    K6 and K11 (8 shells) on (m)'s first 2^18 rays, the frame-sized
    launches of K6 on (m) and (n) and of K11 on (m), K10's window [2, 4) on
    (m)'s first 2^18 rays in ray-id order (min of 5 each), (m)'s default
    route and monolithic with 8 shells over the frame's rays (min of 3)
    and per frame (min of 5), (p)'s median rendering over 31 frames, and
    the winners the margins' stress rays lose (``ab_margins``).
    ``ab_sweeps`` (K3, K4, K5, K2 and the wavefront cells) comes first;
    ``only`` (``--only``) runs one part: "sweeps", "kernels" (``ab_sweeps``
    without the wavefront cells), "fused", "xform" (``ab_xform``),
    "margins" or "xcull" (``ab_xcull``).  Run the parent's
    checkout (an unpacked ``git archive``, whose kernels build there) and
    this one in turns, in one call each way (parent, change, change,
    parent).  Prints one JSON line, checks nothing else."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(root))
    import cudaraytracer_tpu_torch as pkg
    from cudaraytracer_tpu_torch.ops import _cuda
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    out = {"package": os.path.dirname(os.path.abspath(pkg.__file__)),
           "card": smi}
    reports = _cuda.build()
    PTXAS["text"] = "\n".join(r.ptxas for r in reports.values())
    PTXAS["built"] = reports["megakernel"].ptxas != "(reused)"
    LIBRARY.update((k, r.library) for k, r in reports.items())
    device_facts()
    if only in ("", "sweeps", "kernels"):
        out.update(ab_sweeps(dev, cells=only != "kernels"))
    if only in ("", "fused"):
        out.update(ab_fused(dev))
    if only == "xform":
        out.update(ab_xform(dev))
    if only == "":
        out["l_fit"] = tex_fit_step(dev)
        out.update(ab_streamed(dev))
    if only in ("", "margins"):
        out.update(ab_margins(dev))
    if only == "xcull":
        out.update(ab_xcull(dev))
    print(json.dumps(out))
    return 0


def ab_sweeps(dev, cells: bool = True) -> dict:
    """``ab_main``'s sweep timings (min of 10 on the card, ``device_ms``):
    K3 on (c)'s first 2^18 camera rays and the same rays after one bounce,
    K4 on (d)'s middle launch and its bounce, K5 on (e)'s first launch and
    its bounce (each bounce with the wavefront's alive mask, and with that
    mask thinned, ``..._bounce_thinned_...``), each through
    the public ``_raw`` entry (``..._raw_ms``: the commit's own table
    build included) and through ``launch_*_sweep`` over tables built
    before (``..._ms``); where the package has them, the same launch with
    the other cooperation choice (``..._flip_ms``) and, for K4, with one
    box level (``..._one_level_ms``), and the counting instance's box and
    prim tests per ray and lanes' use; K2 as a trace launches it
    (``ab_draws``); then, with ``cells``, (c), (d) and (k) on the wavefront
    (s/frame, min of 5) and (e)'s s/step (min of 5)."""
    from cudaraytracer_tpu_torch.config import Quirks
    from cudaraytracer_tpu_torch.ops import intersect as isect
    from cudaraytracer_tpu_torch.ops import sweeps as sw
    from cudaraytracer_tpu_torch.ops.render import (render_image,
                                                    sweep_intersector)
    new = hasattr(sw, "SweepTables")
    frames = main_frames(dev)
    gen = torch.Generator(device=dev).manual_seed(31)
    scenes = sweep_scenes(dev, frames, gen)
    fa = frames[0]
    t_min, t_max = fa.cfg.t_min, fa.cfg.t_max
    fixed = Quirks.fixed()
    out = {}
    for key, kname in (("c", "k3"), ("d", "k4"), ("e", "k5")):
        scene, cam, bounce, alive, thin, _ = scenes[key]
        if key == "d":
            tr = scene.triangles
            tabs = sw.triangle_table(tr.v0, tr.v1, tr.v2, tr.normal)
            sup = tabs[2] if len(tabs) > 2 else None
        else:
            sp = scene.spheres
            attr = isect.sphere_attr_table(scene)
            tabs = sw.sphere_table(sp.center, sp.radius)
            sup = None
            rows = (sw.pad_rows(attr.t(), sw.PRIM_CHUNK).contiguous()
                    if key == "e" else None)
        for kind, o, d, al in (("camera", cam.origin, cam.direction, None),
                               ("bounce", bounce.origin, bounce.direction,
                                alive),
                               ("bounce_thinned", bounce.origin,
                                bounce.direction, thin)):
            if key == "d":
                def raw(o=o, d=d, al=al):
                    return sw.triangle_best_hit_raw(
                        o, d, tr.v0, tr.v1, tr.v2, tr.normal, t_min, t_max,
                        fixed, alive=al)

                def launch(o=o, d=d, al=al, **kw):
                    return sw.launch_triangle_sweep(
                        o, d, tabs[0], tabs[1], al, t_min, t_max, fixed,
                        **kw)
            else:
                def raw(o=o, d=d, al=al):
                    if rows is None:
                        return sw.sphere_best_hit_raw(
                            o, d, sp.center, sp.radius, t_min, t_max, True,
                            al)
                    return sw.sphere_best_hit_attrs_raw(
                        o, d, sp.center, sp.radius, attr, t_min, t_max, True,
                        al)

                def launch(o=o, d=d, al=al, **kw):
                    return sw.launch_sphere_sweep(o, d, tabs[0], tabs[1], al,
                                                  rows, t_min, t_max, **kw)
            kw = {"sup": sup} if sup is not None else {}
            tag = f"{kname}_{key}_{kind}"
            out[f"{tag}_raw_ms"] = device_ms(raw, reps=10)[0]
            out[f"{tag}_ms"] = device_ms(lambda: launch(**kw), reps=10)[0]
            n = o.shape[0]
            if not new:
                c = torch.zeros(2, dtype=torch.int64, device=dev)
                launch(counts=c)
                out[f"{tag}_tests_per_ray"] = [x / n for x in c.tolist()]
                continue
            flip = not (key == "d" or al is not None)
            out[f"{tag}_flip_ms"] = device_ms(
                lambda: launch(coop=flip, **kw), reps=10)[0]
            c = sweep_counts(launch, dev, **kw)
            out[f"{tag}_tests_per_ray"] = [x / n for x in c[:2]]
            out[f"{tag}_lane_use"] = c[1] / (32.0 * max(c[3], 1))
            out[f"{tag}_box_lane_use"] = c[0] / (32.0 * max(c[2], 1))
            c = sweep_counts(launch, dev, coop=flip, **kw)
            out[f"{tag}_flip_lane_use"] = c[1] / (32.0 * max(c[3], 1))
            if sup is not None:
                out[f"{tag}_one_level_ms"] = device_ms(
                    lambda: launch(sup=None), reps=10)[0]
                c = sweep_counts(launch, dev, sup=None, coop=not flip)
                out[f"{tag}_one_level_tests_per_ray"] = [x / n
                                                         for x in c[:2]]
    if new:
        out["sweep_instances"] = {
            name: ptxas_usage(name) for name in (
                sweep_instance(p, True, coop, attrs)
                for p, attrs in (("sph", False), ("sph", True), ("tri", False))
                for coop in (False, True))}
    out.update(ab_draws(dev, fa.cfg.ray_chunk))
    if not cells:
        return out
    for key, f in (("c", fa), ("d", frames[1]), ("k", tex_frames(dev)[1])):
        cfg = dataclasses.replace(f.cfg, engine="wavefront")
        isect_fn = sweep_intersector(cfg)
        with torch.no_grad():
            out[f"{key}_wavefront_frame_s"] = cuda_ms(
                lambda: render_image(f.scene, f.camera, cfg, generator=gen,
                                     intersect_fn=isect_fn), reps=5)[0] / 1e3
    with contextlib.redirect_stdout(sys.stderr):     # one JSON line out
        out["e_s_per_step"] = run_fit(dev)["s_per_step"]
    return out


def ab_draws(dev, n: int) -> dict:
    """K2 as a depth-DEPTH trace of n rays draws (min of 20): every bounce
    in one launch, or, in a checkout from before the step range, one launch
    a bounce; on the card (``k2_trace_ms``) and as the call
    (``k2_trace_call_ms``); torch.rand's Philox over n x 4 floats for
    scale (not the same function)."""
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    steps = DEPTH + 1
    if "steps" in inspect.signature(mk.scatter_draws_plain).parameters:
        buf = torch.empty(steps, n, 4, device=dev)

        def trace_draws():
            mk.scatter_draws(buf, 7)
    else:
        buf = torch.empty(n, 4, device=dev)

        def trace_draws():
            for step in range(steps):
                mk.scatter_draws(buf, 7, step)
    return {"k2_trace_ms": device_ms(trace_draws, reps=20)[0],
            "k2_trace_call_ms": cuda_ms(trace_draws, reps=20)[0],
            "k2_torch_rand_ms": device_ms(
                lambda: torch.rand(n, 4, device=dev), reps=20)[0]}


# The parent commit's K1 and K9 path instances, for --ab on a checkout
# from before mega_path
PARENT_K1 = ("_ZN3crt11mega_kernelILi0ELb0ELb0ELb0ELb0ELb0ELb0ELb0EEEv"
             "NS_6ParamsE")
PARENT_K9 = ("_ZN3crt11mega_kernelILi0ELb0ELb0ELb0ELb1ELb0ELb0ELb0EEEv"
             "NS_6ParamsE")
PARENT_K8 = ("_ZN3crt11mega_kernelILi0ELb0ELb1ELb0ELb0ELb0ELb0ELb0EEEv"
             "NS_6ParamsE")
# K8's cull against its flat walk, ``ab_xcull``: rows a class
XCULL_ROWS = (4, 8, 16, 32, 64, 128, 256, 1100)


def ab_xcull(dev) -> dict:
    """K8 on the first 2^18 rays of a 640x360x4 TRS field of k rows a
    class (``fill_trs_field``, (i)'s camera and config), for each k of
    XCULL_ROWS, with every class walked in chunks (``..._cull_ms``) and in
    table order (``..._flat_ms``), min of 5 on the card each: what sets
    XFORM_CULL_MIN.  Needs a package with K8's chunks."""
    from cudaraytracer_tpu_torch.config import Quirks, RenderConfig
    from cudaraytracer_tpu_torch.models import check_scenes as cs
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    if not hasattr(mk, "XFORM_CULL_MIN"):
        return {}
    gen = torch.Generator(device=dev).manual_seed(29)
    cfg = RenderConfig(width=640, height=360, samples=4, max_depth=4,
                       quirks=Quirks.fixed(), engine="mega")
    keep = mk.XFORM_CULL_MIN
    out = {}
    try:
        for k in XCULL_ROWS:
            scene, cam = cs.trs_field_scene(k, 640 / 360, device=dev)
            f = Frame(f"trs_field_{k}", scene, cam, cfg, None)
            rays = first_chunk(f, gen)
            for mode, least in (("cull", 0), ("flat", 1 << 30)):
                mk.XFORM_CULL_MIN = least
                tables = mk.morton_tables(scene)
                out[f"xcull_{k}_{mode}_ms"] = device_ms(
                    lambda: mk.trace_path_mega(scene, rays, cfg,
                                               tables=tables, seed=3), 5)[0]
    finally:
        mk.XFORM_CULL_MIN = keep
    return out


def ab_margins(dev) -> dict:
    """``phase_margins`` counting only: the winners the fused kernels and
    K3 lose on the stress rays, for the checkout before the margins and
    after them."""
    with contextlib.redirect_stdout(sys.stderr):     # one JSON line out
        return {"margins": phase_margins(dev, strict=False)}


def ab_timed(out: dict, key: str, f: Frame, rays, seed: int, tables=None,
             **kw) -> None:
    """One fused launch timed on the card (``key``, ``device_ms``), as a
    call (``..._call_ms``) and on the host (``..._host_ms``), min of 5."""
    from cudaraytracer_tpu_torch.ops import megakernel as mk

    def call():
        return mk.trace_path_mega(f.scene, rays, f.cfg,
                                  tables=tables or f.tables, seed=seed, **kw)

    out[key] = device_ms(call, 5)[0]
    out[key.replace("_ms", "_call_ms")] = cuda_ms(call, 5)[0]
    out[key.replace("_ms", "_host_ms")] = host_ms(call)


def ab_usage(out: dict, key: str, f: Frame, parent_name: str,
             want_winners: bool = False) -> None:
    """The registers and spill of the path instance f's launches take, from
    this run's ptxas report (None where this run reused a build)."""
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    name = (path_mangled(**path_flags(f.tables, f.cfg, want_winners))
            if hasattr(mk, "path_instance") else parent_name)
    out[key] = dict(zip(("name", "registers", "spill_bytes"),
                        (name, *ptxas_usage(name))))


def ab_xform_launches(xf, gen, seed: int) -> dict:
    """K8 on (h)'s and (i)'s first 2^18 rays (``ab_timed``), (i)'s counted
    tests a bounce and lanes' use where the package counts them, and the
    K8 path instance's registers and spill."""
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    fh, fi = xf[0], xf[2]
    out = {}
    ab_timed(out, "k8_h_2_18_ms", fh, first_chunk(fh, gen), seed)
    ri = first_chunk(fi, gen)
    ab_timed(out, "k8_i_2_18_ms", fi, ri, seed)
    if hasattr(mk, "N_WORK"):
        tests = count_tests(fi.tables, ri, fi.cfg, seed)
        out["k8_i_2_18_tests_per_bounce"] = {
            k: tests[k] / tests["bounce"]
            for k in ("xbox", "rect", "tsph", "ttri") if k in tests}
        out["k8_i_2_18_lane_use"] = lane_use(tests)
    ab_usage(out, "k8_instance", fi, PARENT_K8)
    return out


def ab_xform(dev) -> dict:
    """``--only xform``: K1 and K7 on (a)'s first 2^18 rays (the K7 launch
    records the winners), ``ab_xform_launches``, and the seconds per frame
    of (g), (h) and (i) through render_image (min of 5): the launches the
    K7 and K8 parts move, without the rest of ``ab_fused``."""
    from cudaraytracer_tpu_torch.ops.render import render_image
    gen = torch.Generator(device=dev).manual_seed(7)
    fa, _ = main_frames(dev)
    seed = 4242
    out = {}
    rays = first_chunk(fa, gen)
    ab_timed(out, "k1_a_2_18_ms", fa, rays, seed)
    ab_timed(out, "k7_g_2_18_ms", fa, rays, seed, want_winners=True)
    ab_usage(out, "k7_instance", fa, PARENT_K1, want_winners=True)
    xf = xform_frames(dev)
    out.update(ab_xform_launches(xf, gen, seed))
    for key, f in (("g", fa._replace(cfg=dataclasses.replace(
            fa.cfg, engine="mega_diff"))), ("h", xf[0]), ("i", xf[2])):
        out[f"{key}_frame_s"] = cuda_ms(lambda f=f: render_image(
            f.scene, f.camera, f.cfg, generator=gen, tables=f.tables),
            reps=5)[0] / 1e3
    return out


def ab_fused(dev) -> dict:
    """``ab_main``'s fused timings, min of 5 each: K1's frame-sized
    launches of (a) and (b) and its launch on (a)'s first 2^18 rays (each
    2^18-ray launch by ``device_ms``, and as ``..._call_ms`` by
    ``cuda_ms``, the wrapper's host time included), K7 on
    (g)'s first launch (those rays, recording), K8 on (h)'s first launch,
    K9 on (j)'s middle launch with its images and with constant textures,
    and the seconds per frame through render_image of (a) and of the other
    fused frames on mega_path ((b), (g), (h)-(l)); with the registers
    and spill of the K1 and K9 path instances when this run built them,
    and the lanes' use on (a)'s 2^18 rays where the package counts it."""
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    from cudaraytracer_tpu_torch.ops.render import render_image
    gen = torch.Generator(device=dev).manual_seed(7)
    fa, fb = main_frames(dev)
    out = {}
    for f in (fa, fb):
        out[f"{f.name}_frame_launch_ms"] = frame_launch(dev, f, gen, 5)[0]
    seed = 4242

    def timed(key, f, rays, tables=None, **kw):
        ab_timed(out, key, f, rays, seed, tables, **kw)

    def usage(key, f, parent_name):
        ab_usage(out, key, f, parent_name)

    rays = first_chunk(fa, gen)
    timed("k1_a_2_18_ms", fa, rays)
    usage("k1_instance", fa, PARENT_K1)
    if hasattr(mk, "N_WORK"):
        out["k1_a_2_18_lane_use"] = lane_use(
            count_tests(fa.tables, rays, fa.cfg, seed))
    timed("k7_g_2_18_ms", fa, rays, want_winners=True)
    timed("k1_b_mid_2_18_ms", fb, first_chunk(fb, gen, middle_chunk(fb)))
    xf, tf = xform_frames(dev), tex_frames(dev)
    fj = tf[0]
    out.update(ab_xform_launches(xf, gen, seed))
    rj = first_chunk(fj, gen, middle_chunk(fj))
    timed("k9_j_mid_ms", fj, rj)
    usage("k9_instance", fj, PARENT_K9)
    timed("k9_j_mid_const_tex_ms", fj, rj, constant_textures(fj.tables))
    out["a_frame_s"] = cuda_ms(lambda: render_image(
        fa.scene, fa.camera, fa.cfg, generator=gen, tables=fa.tables),
        reps=5)[0] / 1e3
    # the other fused frames whose launches run mega_path: (b), (g)'s
    # forward without a gradient, (h), (i), (j), (k), (l)
    for key, f in (("b", fb), ("g", fa._replace(cfg=dataclasses.replace(
            fa.cfg, engine="mega_diff"))), ("h", xf[0]), ("i", xf[2]),
            ("j", tf[0]), ("k", tf[1]), ("l", tf[2])):
        out[f"{key}_frame_s"] = cuda_ms(lambda f=f: render_image(
            f.scene, f.camera, f.cfg, generator=gen, tables=f.tables),
            reps=5)[0] / 1e3
    return out


def ab_window_2_4(fm, rays, seed, card: bool = False) -> tuple:
    """K10's window [2, 4) resumed from the state of [0, 2) (min of 5), in
    ray-id order (the figure earlier PRs compared) and in the order its
    octant keys sort to (the order the default route serves it in): in
    place over the planes, or, in a checkout from before the planes, from
    the dumped rows, gathered (untimed) in that checkout's own octant order
    as its driver gathered them.  card: the card's time alone (queued
    behind a spin), else the call's."""
    from cudaraytracer_tpu_torch.core.rays import Rays
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    times = []
    if "planes" in mk.Window._fields:
        n = rays.origin.shape[0]
        planes = torch.empty(mk.N_PLANES, n, device=rays.origin.device)
        key = torch.empty(n, dtype=torch.int32, device=rays.origin.device)
        mk.trace_path_mega(fm.scene, rays, fm.cfg, tables=fm.tables,
                           seed=seed, window=mk.Window(
                               0, 2, planes, None, key, mk.KEY_OCTANT))
        start_from = planes.clone()
        for order in (None, mk._next_order(key)):
            w1 = mk.Window(2, 2, planes, order)
            times.append(inplace_ms(lambda w1=w1: mk.trace_path_mega(
                fm.scene, rays, fm.cfg, tables=fm.tables, seed=seed,
                window=w1), planes, start_from, 5, card))
        return tuple(times)
    a = mk.trace_path_mega(fm.scene, rays, fm.cfg, tables=fm.tables,
                           seed=seed, window=mk.Window(0, 2, None, None,
                                                       True))
    for order in (None, mk._octant_order(a)):
        s = a if order is None else a[order]
        r2 = Rays(s[:, 3:6].contiguous(), s[:, 6:9].contiguous(), rays.time)
        w1 = mk.Window(2, 2, s[:, 9:13].contiguous(),
                       None if order is None else order.to(torch.int32))
        times.append((device_ms if card else cuda_ms)(
            lambda r2=r2, w1=w1: mk.trace_path_mega(
                fm.scene, r2, fm.cfg, tables=fm.tables, seed=seed,
                window=w1), 5)[0])
    return tuple(times)


def ab_routes(dev, fm) -> dict:
    """(m)'s default route (phased every 2 bounces, octants, 8 shells) and
    monolithic with 8 shells: over the whole frame's rays in one call (min
    of 3) and per frame through render_image (min of 5)."""
    from cudaraytracer_tpu_torch.core.camera import generate_pixel_rays
    from cudaraytracer_tpu_torch.ops import integrators as integ
    from cudaraytracer_tpu_torch.ops.render import (render_image,
                                                    swizzled_pixels)
    out = {}
    c = fm.cfg
    gen = torch.Generator(device=dev).manual_seed(32)
    rays = generate_pixel_rays(
        fm.camera, c.width, c.height, c.samples,
        swizzled_pixels(c.width, c.height, device=dev), generator=gen)
    for name, cfg in (("default", c), ("monolithic_f2b8", dataclasses.replace(
            c, compact_auto=False, mega_f2b_shells=8))):
        out[f"m_{name}_frame_launch_ms"] = cuda_ms(lambda: integ.integrate(
            fm.scene, rays, cfg, tables=fm.tables, seed=11), reps=3)[0]
        out[f"m_{name}_frame_s"] = cuda_ms(lambda: render_image(
            fm.scene, fm.camera, cfg, generator=gen, tables=fm.tables),
            reps=5)[0] / 1e3
    return out


def ab_streamed(dev) -> dict:
    """``ab_main``'s K6, K10, K11, K12, (m)'s routes and (p) timings."""
    from cudaraytracer_tpu_torch.models import check_scenes as cs
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    fm, fn = stream_frames(dev)
    gen = torch.Generator(device=dev).manual_seed(23)
    out = {}
    rays = first_chunk(fm, gen)
    seed = 12345
    def timed(key, f, cfg):
        def fn():
            return mk.trace_path_mega(f.scene, rays, cfg, tables=f.tables,
                                      seed=seed)
        out[f"{key}_ms"] = cuda_ms(fn, 5)[0]
        out[f"{key}_card_ms"] = device_ms(fn, 5)[0]

    fq = mxu_frame(fm)
    timed("k12_m_2_18", fq, fq.cfg)
    del fq
    timed("k6_m_2_18", fm, fm.cfg)
    cfg8 = dataclasses.replace(fm.cfg, mega_f2b_shells=8)
    timed("k11_m_2_18", fm, cfg8)
    for card, tag in ((False, ""), (True, "_card")):
        (out[f"k10_m_window_2_4{tag}_ms"],
         out[f"k10_m_window_2_4_octant{tag}_ms"]) = ab_window_2_4(
            fm, rays, seed, card)
    out["k6_m_frame_launch_ms"] = frame_launch(dev, fm, gen, 5)[0]
    out["k11_m_f2b8_frame_launch_ms"] = frame_launch(
        dev, fm._replace(cfg=cfg8), gen, 5)[0]
    out.update(ab_routes(dev, fm))
    out["k6_n_frame_launch_ms"] = frame_launch(dev, fn, gen, 5)[0]
    del fm, fn
    with contextlib.redirect_stdout(sys.stderr):     # one JSON line out
        out["p_skinned_field"] = animate_cell(
            dev, "skinned_field", cs.skinned_field(),
            cs.field_camera(2.0, device=dev))
    return out


if __name__ == "__main__":
    if len(sys.argv) > 1:
        import argparse
        ap = argparse.ArgumentParser(description=ab_main.__doc__)
        ap.add_argument("--ab", action="store_true", required=True)
        ap.add_argument("--root", default=ROOT,
                        help="import cudaraytracer_tpu_torch from this "
                             "checkout")
        ap.add_argument("--only", choices=("sweeps", "kernels", "fused",
                                           "margins", "xform", "xcull"),
                        default="",
                        help="run only ab_sweeps (kernels: without its "
                             "wavefront cells), ab_fused, ab_margins, "
                             "ab_xform or ab_xcull")
        args = ap.parse_args()
        sys.exit(ab_main(args.root, args.only))
    sys.exit(main())
