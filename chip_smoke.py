#!/usr/bin/env python3
"""Drive the PyTorch port's main path (the fused render, engine='mega') on
one CUDA card, and hold every kernel of that path against its plain PyTorch
version.

    python3 chip_smoke.py

Phases (each prints lines; any failure raises and exits nonzero):
  1. environment: the card's name and power limit;
  2. build: the CUDA sources under cudaraytracer_tpu_torch/csrc, with the
     ptxas register and spill report;
  3. kernel against plain: mega_trace and trace_path_mega_plain on the same
     rays, and either the same injected stream or the same in-kernel draws:
       * one full main-path launch of each phase-5 frame: its first
         2^18-ray chunk in swizzled order, three integrators with an
         injected stream plus the path with in-kernel draws;
       * four scenes at 128x64x4, three integrators, injected stream;
       * a scene of duplicated prims, which must render as if the copies
         were absent, and a scene of exact t ties;
     the kernel is built without FMA contraction, so every ray must match
     to PARITY_ATOL;
  4. draws: the scatter_draws kernel over 2^22 samples against its plain
     version and against the unit-ball and uniform distributions;
  5. main path at full size through render_image: (a) random_spheres
     1920x1080x16, path depth 8, reference quirks, Morton tables, in-kernel
     draws; (b) a 5,120-triangle icosphere 1280x720x8, depth 8, fixed
     quirks.  Warm-up, then the min of 3 frames timed with CUDA events;
  6. one JSON line of kernels: launches on the main path, times, bounds;
  7. the last line: {"ok": true, "device": {...}}.

Writes its PNGs and the build log under chip_smoke_out/.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from typing import NamedTuple

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
OPS_DRAW = 240     # 2 Philox4x32-10 (~200 integer ops) + the transform

DEPTH = 8
PHASE3 = (128, 64, 4)
# Kernel and plain version round alike (no contraction), so every ray must
# agree to this.
PARITY_ATOL = 1e-5
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


def launch_bound(tables, n: int, tests) -> tuple:
    """(bound ms, bound_by) of one launch over n rays that made ``tests``
    (box, sphere, triangle): their FLOPs over the FP32 peak against the
    rays, radiance and tables over the memory rate."""
    n_box, n_sph, n_tri = tests
    flops = n_box * FLOP_BOX + n_sph * FLOP_SPHERE + n_tri * FLOP_TRI
    bytes_ = n * (24 + 12) + sum(t.numel() * 4 for t in tables)
    t_ops, t_bytes = flops / PEAK_FP32, bytes_ / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def count_tests(tables, rays, cfg, seed) -> list:
    """Box, sphere and triangle tests of one path launch (the kernel's
    counting variant)."""
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    counts = torch.zeros(3, dtype=torch.int64, device=rays.origin.device)
    mk._launch_mega(tables, rays.origin.contiguous(),
                    rays.direction.contiguous(), cfg, None, seed,
                    counts=counts)
    return counts.tolist()


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_build():
    from cudaraytracer_tpu_torch.ops import _cuda
    t0 = time.perf_counter()
    reports = _cuda.build()
    wall = time.perf_counter() - t0
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "build.log"), "w") as f:
        for r in reports.values():
            f.write(f"== {r.name} ({r.seconds:.1f} s)\n{r.ptxas}\n")
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


def first_chunk(f: Frame, gen):
    """The rays of the frame's first kernel launch, as render_pixels makes
    them: the first ray_chunk // samples pixels in swizzled order."""
    from cudaraytracer_tpu_torch.core.camera import generate_pixel_rays
    from cudaraytracer_tpu_torch.ops.render import swizzled_pixels
    c = f.cfg
    pix = swizzled_pixels(c.width, c.height, device=f.scene.device)
    return generate_pixel_rays(f.camera, c.width, c.height, c.samples,
                               pix[:c.ray_chunk // c.samples], generator=gen)


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
        ms, got = cuda_ms(lambda: mk.trace_path_mega(
            f.scene, rays, f.cfg, tables=f.tables, seed=seed))
        plain_ms, ref = cuda_ms(lambda: mk.trace_path_mega_plain(
            f.tables, rays, f.cfg, None, seed), reps=1, warmup=0)
        err = compare(f"{f.name} chunk path in-kernel draws", got, ref)
        out["max_abs_err"] = max(out["max_abs_err"], err)
        tests = count_tests(f.tables, rays, f.cfg, seed)
        bound, bound_by = launch_bound(f.tables, n, tests)
        print(f"[parity] {f.name} chunk path: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.3f} ms, bound {bound:.4f} ms ({bound_by}), "
              f"tests {tests}")
        out[f.name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                       "bound_by": bound_by, "tests": tests, "rays": n}
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


def phase_draws(dev):
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    n = 1 << 22
    out = torch.empty(n, 4, device=dev)
    ms, _ = cuda_ms(lambda: mk.scatter_draws(out, 0xD1CE, 3))
    plain_ms, ref = cuda_ms(lambda: mk.scatter_draws_plain(n, 0xD1CE, 3, dev))
    err = float((out - ref).abs().max())
    ball, prob = out[:, :3].double(), out[:, 3]
    r = ball.norm(dim=1)
    mean = ball.mean(dim=0).abs().max()
    ks_r, ks_p = ks_uniform(r ** 3), ks_uniform(prob)
    print(f"[draws] {n} samples: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
          f"max_abs_err vs plain {err:.3g}")
    print(f"[draws] max|ball| {float(r.max()):.7f} "
          f"max|mean| {float(mean):.2e} KS(r^3) {ks_r:.5f} "
          f"KS(prob) {ks_p:.5f}")
    check(float(r.max()) <= 1.0 + 1e-6, "ball sample outside the unit ball")
    check(float(mean) < 5e-3, "ball mean off 0")
    check(ks_r < 0.01 and ks_p < 0.01, "draws fail the KS checks")
    check(err <= 1e-5, "scatter_draws disagrees with its plain version")
    bytes_ = n * 16
    bound = max(bytes_ / PEAK_BYTES, n * OPS_DRAW / PEAK_FP32) * 1e3
    return {"name": "scatter_draws", "route": "cuda",
            "source": "cudaraytracer_tpu_torch/csrc/megakernel.cu",
            "replaces": "cudaraytracer_tpu/ops/pallas_intersect.py:1122",
            "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": ("bytes" if bytes_ / PEAK_BYTES
                         >= n * OPS_DRAW / PEAK_FP32 else "operations"),
            "library_ms": None, "on_main_path": False, "samples": n}


def render_frame(dev, f: Frame, gen):
    """Warm-up + min of 3 frames through render_image; checks the image."""
    from cudaraytracer_tpu_torch.ops.render import render_image
    from cudaraytracer_tpu_torch.utils.image import write_png
    cfg = f.cfg
    torch.cuda.reset_peak_memory_stats(dev)
    ms, img = cuda_ms(lambda: render_image(f.scene, f.camera, cfg,
                                           generator=gen, tables=f.tables))
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


def kernel_at_frame_shape(dev, f: Frame, gen):
    """The kernel alone over a whole frame's rays in one launch, and the
    tests these rays need (one extra counting launch)."""
    from cudaraytracer_tpu_torch.core.camera import generate_pixel_rays
    from cudaraytracer_tpu_torch.ops import megakernel as mk
    from cudaraytracer_tpu_torch.ops.render import swizzled_pixels
    c = f.cfg
    pix = swizzled_pixels(c.width, c.height, device=dev)
    rays = generate_pixel_rays(f.camera, c.width, c.height, c.samples, pix,
                               generator=gen)
    ms, _ = cuda_ms(lambda: mk.trace_path_mega(f.scene, rays, c,
                                               tables=f.tables, seed=11))
    tests = count_tests(f.tables, rays, c, 11)
    n = rays.origin.shape[0]
    bound, bound_by = launch_bound(f.tables, n, tests)
    return {"ms": ms, "bound_ms": bound, "bound_by": bound_by,
            "tests": tests, "rays": n}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
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
    parity = phase_parity(dev, frames)
    draws = phase_draws(dev)

    # ---- phase 5: the main path, counted from zero ----
    gen = torch.Generator(device=dev).manual_seed(2024)
    mk.reset_launch_counts()
    ms_a, img_a, peak_a = render_frame(dev, fa, gen)
    launches_a = mk.LAUNCHES["mega_trace"]
    ms_b, _, peak_b = render_frame(dev, fb, gen)
    n_a = fa.cfg.width * fa.cfg.height * fa.cfg.samples
    stream = stream_from_generator(gen, n_a, DEPTH, dev)
    img_inj = render_image(fa.scene, fa.camera, fa.cfg, generator=gen,
                           tables=fa.tables, samples=stream)
    del stream
    launches = dict(mk.LAUNCHES)
    print(f"[main] launches on the main path: {launches} "
          f"({launches_a // 4} mega_trace per 1920x1080x16 frame)")
    check(launches["mega_trace"] > 0, "the main path never launched "
          "mega_trace")
    mean_a = img_a.reshape(-1, 3).mean(0)
    mean_inj = img_inj.reshape(-1, 3).mean(0)
    rel = ((mean_a - mean_inj).abs() / mean_inj).max()
    print(f"[main] random_spheres in-kernel Philox vs injected torch stream: "
          f"channel means {mean_a.tolist()} vs {mean_inj.tolist()} "
          f"(max rel {float(rel):.4%})")
    check(float(rel) <= 0.02, "in-kernel draws bias the image")

    # ---- the kernel alone over a whole frame's rays ----
    ka = kernel_at_frame_shape(dev, fa, gen)
    kb = kernel_at_frame_shape(dev, fb, gen)
    for f, k in ((fa, ka), (fb, kb)):
        print(f"[kernel] {f.name}: one launch over {k['rays']} rays "
              f"{k['ms']:.3f} ms, bound {k['bound_ms']:.3f} ms "
              f"({k['bound_by']}), tests {k['tests']}")
    ca, cb = parity["random_spheres"], parity["icosphere"]
    mega = {"name": "mega_trace", "route": "cuda",
            "source": "cudaraytracer_tpu_torch/csrc/megakernel.cu",
            "replaces": "cudaraytracer_tpu/ops/megakernel.py:476",
            "launches": launches["mega_trace"],
            "max_abs_err": parity["max_abs_err"],
            "ms": ca["ms"], "plain_ms": ca["plain_ms"],
            "bound_ms": ca["bound_ms"], "bound_by": ca["bound_by"],
            "library_ms": None,
            "ms_at": "one main-path launch: the first 262144-ray chunk of "
                     "random_spheres 1920x1080x16, path 8, in-kernel draws",
            "tests": ca["tests"],
            "icosphere_chunk": cb,
            "frame_launch": {"random_spheres": ka, "icosphere": kb},
            "frame_s": ms_a / 1e3, "icosphere_frame_s": ms_b / 1e3,
            "peak_gib": peak_a / 2 ** 30,
            "icosphere_peak_gib": peak_b / 2 ** 30}
    draws["launches"] = launches["scatter_draws"]
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [mega, draws]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
