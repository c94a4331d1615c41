"""Animated-mesh rendering driver on the port: the reference's ``main()``
pipeline (kernel.cu:41-110, render.h:191-237) end to end.

  load the FBX (a skinned character) -> build the scene (timed as 'build')
  -> per frame: skin (timed as 'update') -> render (timed as 'rendering')
  -> PNG <out>/picture_<frame>.png -> <csv> with header
  ``frame,rendering,update,build``.

Pipelines (the reference's menu, kernel.cu:93-97, as a flag; every one
renders the same quirk-gated images):
  mega   -- the fused CUDA kernel (engine='mega'): the tables rebuilt from the
            skinned scene every frame (the per-frame refit) in the Morton
            order of the bind pose; the resident kernel K1 up to 8,192
            triangles, the segment level K6 above (the default);
  pallas -- the wavefront on the sweep kernels K3 / K4
            (``render.sweep_intersector``, the JAX package's Pallas sweeps);
  list   -- the wavefront on brute-force tensor ops (renderListAnimation);
  bvh    -- the reference's ACTIVE pipeline (kernel.cu:97): one BVH over the
            mesh (``ops/bvh.py``), built from the begin frame's pose (timed
            as 'build'), refit every frame, the wavefront through
            ``render.bvh_intersector`` (the traversal kernel);
  bonebvh -- one BVH per skeleton bone (renderBoneBVHAnimation,
            kernel.cu:5-21; ``ops/bone_bvh.py``), the whole forest refit
            every frame; triangles no bone claims are dropped, as the
            reference drops them (a mesh with no skin has none to keep, and
            raises the empty-forest error);
  fused  -- bvh with skin, refit and render timed as one 'rendering'.
On mega and pallas 'update' is the skinning alone; on bvh and bonebvh the
skinning and the refit, ended by a device sync; on list and fused it is 0,
as in the JAX package's apps/animate.py.

The per-frame draws come from a generator seeded by Philox4x32-10 of the
frame under the run's seed (``frame_seed``): equal in distribution to the JAX
driver's ``fold_in(key, frame)``, not equal in value.  Sticky CUDA errors
re-raise at once; transient ones retry the frame (``utils/recovery.py``).

Usage: python -m cudaraytracer_tpu_torch.apps.animate --fbx PATH [--frames N]
           [--width W --height H --samples S]
           [--pipeline mega|pallas|list|bvh|bonebvh|fused] [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Optional

import numpy as np

PIPELINES = ("bvh", "list", "fused", "pallas", "bonebvh", "mega")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--fbx", default="CudaTest/objects/low_walking.fbx",
                    help="the skinned FBX (binary or ASCII); the default is "
                         "the reference checkout's walking character")
    ap.add_argument("--out", default="images/moveTest")
    ap.add_argument("--csv", default="output.csv")
    ap.add_argument("--width", type=int, default=1024)      # kernel.cu:44
    ap.add_argument("--height", type=int, default=512)      # kernel.cu:45
    ap.add_argument("--samples", type=int, default=4)       # kernel.cu:49
    ap.add_argument("--max-depth", type=int, default=8)     # kernel.cu:48
    ap.add_argument("--integrator", default="lambert",      # render.h:120
                    choices=["path", "lambert", "normal"])
    ap.add_argument("--pipeline", default="mega", choices=PIPELINES)
    ap.add_argument("--begin-frame", type=int, default=0)   # kernel.cu:50
    ap.add_argument("--frames", type=int, default=None,
                    help="limit frame count (default: animation length)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the CPU")
    ap.add_argument("--no-png", action="store_true")
    ap.add_argument("--resume", action="store_true",
                    help="skip frames whose PNG already exists in --out")
    ap.add_argument("--retries", type=int, default=2,
                    help="per-frame retries on transient device failures; "
                         "0 disables them")
    ap.add_argument("--retry-backoff", type=float, default=20.0,
                    help="seconds before the first retry (doubles each)")
    return ap.parse_args(argv)


def load_mesh(path: str):
    """The skinned mesh of an FBX file (``utils.fbx_loader``)."""
    from ..utils.fbx_loader import load_skinned_mesh
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"no FBX file at {path!r}: pass --fbx with the path of a skinned "
            "FBX (binary or ASCII)")
    return load_skinned_mesh(path)


def frame_seed(frame: int, seed: int = 0) -> int:
    """A 62-bit generator seed for one frame: the first two words of
    Philox4x32-10 at counter (frame, 0, 0, 0) under the key (seed low word,
    seed high word)."""
    import torch

    from ..core.rng import philox4x32
    z = torch.zeros(1, dtype=torch.int64)
    c0, c1, _, _ = philox4x32((z + (frame & 0xFFFFFFFF), z, z, z), seed,
                              seed >> 32)
    return ((int(c1) << 32) | int(c0)) >> 2


@dataclasses.dataclass
class AnimationRun:
    """What ``animate`` measured: the CSV's log, per frame its update,
    table build (mega only; part of the rendering) and rendering seconds,
    the last frame's image float32[H, W, 3] (row 0 = bottom), and the
    triangles bonebvh dropped (no bone claims them)."""
    log: object
    frames: list
    update: list
    tables: list
    rendering: list
    image: Optional[np.ndarray]
    dropped: int = 0


def animate(mesh, args: argparse.Namespace, camera=None) -> AnimationRun:
    """Render the animation of ``mesh`` (a ``SkinnedMesh``) as ``args``
    (``parse_args``) asks, under ``camera`` (default: the FBX pipeline's,
    ``presets.fbx_walk_camera``)."""
    import torch

    from ..config import RenderConfig
    from ..core.device import resolve_device
    from ..models import presets
    from ..models.mesh import device_mesh, scene_with_frame
    from ..models.scene import SceneBuilder
    from ..ops import megakernel as mk
    from ..ops.bone_bvh import build_bone_forest
    from ..ops.bvh import build_triangle_bvh, refit_bvh
    from ..ops.render import bvh_intersector, render_image, sweep_intersector
    from ..utils.checkpoint import next_frame
    from ..utils.csvlog import MetricsLog
    from ..utils.image import write_png
    from ..utils.recovery import retry_transient
    from ..utils.stopwatch import StopWatch, sync

    device = resolve_device("cpu" if args.cpu else None)
    end_frame = mesh.frame_count - 1   # FbxLoader.h:114
    if args.frames is not None:
        end_frame = min(end_frame, args.begin_frame + args.frames - 1)
    cfg = RenderConfig(width=args.width, height=args.height,
                       samples=args.samples, max_depth=args.max_depth,
                       integrator=args.integrator)
    cfg_mega = dataclasses.replace(cfg, engine="mega")
    if camera is None:
        camera = presets.fbx_walk_camera(aspect=cfg.aspect, device=device)

    # one Triangle per face on one shared red lambertian
    # (add_mesh_withNormal, createScene.h:175-190)
    builder = SceneBuilder()
    mat = builder.materials.lambertian(color=(0.65, 0.05, 0.05))
    builder.add_mesh(mesh.points, mesh.faces, mat, normals=mesh.normals,
                     reverse_winding=True)

    def upload():
        return builder.build(device), device_mesh(mesh, device)

    scene0, dm = upload()
    # the Morton order of the bind pose, taken once: the chunk and segment
    # boxes stay compact while the mesh moves
    tri = scene0.triangles
    mega_order = (mk.morton_order(*(x.cpu().numpy()
                                    for x in (tri.v0, tri.v1, tri.v2)))
                  if scene0.n_triangles else None)
    isect = sweep_intersector(cfg) if args.pipeline == "pallas" else None
    bvh = None
    dropped = 0

    def build_accel(scene_f):
        """The BVH (or bone forest) of the pose scene_f (kernel.cu:29-38,
        createScene.h:253-306 for the forest)."""
        nonlocal dropped
        tri = scene_f.triangles
        if args.pipeline != "bonebvh":
            return build_triangle_bvh(tri.v0, tri.v1, tri.v2, device=device)
        forest = build_bone_forest(*(x.cpu().numpy() for x in (
            tri.v0, tri.v1, tri.v2)), mesh.weights, mesh.faces,
            device=device)
        dropped = forest.n_dropped
        if forest.n_dropped:
            print(f"bonebvh: {forest.n_dropped} orphan triangles dropped "
                  "(the reference drops them)")
        return forest.bvh

    log = MetricsLog(config_note=(
        f"{args.width}x{args.height}x{args.samples}spp depth{args.max_depth} "
        f"integrator={args.integrator} pipeline={args.pipeline} "
        f"asset={os.path.basename(args.fbx)} device={device}"))
    sw = StopWatch()
    with torch.no_grad():
        sw.Reset()
        sw.Start()
        scene_b = scene_with_frame(scene0, dm, args.begin_frame)
        if args.pipeline in ("bvh", "bonebvh", "fused"):
            bvh = build_accel(scene_b)
            sync(bvh.bbox_min)
        sync(scene_b.triangles.v0)
        sw.Stop()
    log.log_build(sw.GetTime())
    print(f"build: {sw.GetTime():.4f}s")

    def restore(attempt, err):
        nonlocal scene0, dm, bvh
        print(f"transient device failure (retry {attempt}/{args.retries}): "
              f"{err}\nre-uploading the mesh...", flush=True)
        scene0, dm = upload()
        if bvh is not None:
            bvh = build_accel(scene_with_frame(scene0, dm, args.begin_frame))

    def skin_refit(frame):
        scene_f = scene_with_frame(scene0, dm, frame)
        tri = scene_f.triangles
        return scene_f, refit_bvh(bvh, tri.v0, tri.v1, tri.v2)

    @torch.no_grad()
    def do_frame(frame):
        nonlocal bvh
        gen = torch.Generator(device=device).manual_seed(
            frame_seed(frame, args.seed))
        tables_t = update_t = 0.0
        if args.pipeline in ("mega", "pallas"):
            sw.Reset()
            sw.Start()
            scene_f = scene_with_frame(scene0, dm, frame)
            sync(scene_f.triangles.v0)
            sw.Stop()
            update_t = sw.GetTime()
            sw.Reset()
            sw.Start()
            if args.pipeline == "mega":
                tables = mk.build_mega_tables(scene_f, tri_order=mega_order)
                sync(tables.tri)
                sw.Stop()            # the watch accumulates: rendering
                tables_t = sw.GetTime()   # includes the tables, as in JAX
                sw.Start()
                img = render_image(scene_f, camera, cfg_mega, generator=gen,
                                   tables=tables)
            else:
                img = render_image(scene_f, camera, cfg, generator=gen,
                                   intersect_fn=isect)
            img = img.cpu().numpy()           # waits for the device
            sw.Stop()
        elif args.pipeline in ("bvh", "bonebvh"):
            # update: skin + refit, the reference's Update_BVH
            sw.Reset()
            sw.Start()
            scene_f, bvh = skin_refit(frame)
            sync(bvh.bbox_min)
            sw.Stop()
            update_t = sw.GetTime()
            sw.Reset()
            sw.Start()
            img = render_image(scene_f, camera, cfg, generator=gen,
                               intersect_fn=bvh_intersector(cfg, bvh))
            img = img.cpu().numpy()           # waits for the device
            sw.Stop()
        elif args.pipeline == "fused":
            sw.Reset()
            sw.Start()
            scene_f, bvh_f = skin_refit(frame)
            img = render_image(scene_f, camera, cfg, generator=gen,
                               intersect_fn=bvh_intersector(cfg, bvh_f))
            img = img.cpu().numpy()
            sw.Stop()
        else:  # list
            scene_f = scene_with_frame(scene0, dm, frame)
            sw.Reset()
            sw.Start()
            img = render_image(scene_f, camera, cfg,
                               generator=gen).cpu().numpy()
            sw.Stop()
        return img, sw.GetTime(), update_t, tables_t

    os.makedirs(args.out, exist_ok=True)
    begin = args.begin_frame
    if args.resume:
        begin = next_frame(args.out, args.begin_frame)
        if begin > args.begin_frame:
            print(f"resuming at frame {begin}")
            if os.path.exists(args.csv):
                # keep the earlier run's rows (its build row too): write_csv
                # rewrites the file
                prior = MetricsLog.read_csv(args.csv)
                keep = [r for r in prior.rows[1:]
                        if not r[0] or int(r[0]) < begin]
                log.rows = [list(log.rows[0])] + keep
    run = AnimationRun(log, [], [], [], [], None, dropped)
    for frame in range(begin, end_frame + 1):
        img, render_t, update_t, tables_t = retry_transient(
            lambda: do_frame(frame), retries=args.retries,
            backoff_s=args.retry_backoff, on_retry=restore)
        log.log_frame(frame, render_t, update_t)
        if not args.no_png:
            write_png(os.path.join(args.out, f"picture_{frame}.png"), img)
        print(f"frame {frame}: render {render_t:.4f}s update {update_t:.4f}s")
        run.frames.append(frame)
        run.update.append(update_t)
        run.tables.append(tables_t)
        run.rendering.append(render_t)
        run.image = img
    log.write_csv(args.csv)
    print(f"wrote {args.csv}")
    return run


def main(argv=None) -> int:
    args = parse_args(argv)
    mesh = load_mesh(args.fbx)
    print(f"loaded {args.fbx}: {mesh.n_points} points, {mesh.n_triangles} "
          f"tris, {mesh.n_bones} bones, {mesh.frame_count} frames")
    animate(mesh, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
