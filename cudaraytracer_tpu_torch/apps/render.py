"""Still-image rendering CLI on the port: a preset scene or an OBJ mesh to
PNG, through the fused CUDA kernel (--accel mega, and auto where the
kernel takes the scene) or the wavefront engine (--accel sweeps, bvh or
bruteforce).

Examples:
  python -m cudaraytracer_tpu_torch.apps.render --scene random_spheres \
      --width 1920 --height 1080 --spp 16 --out out.png
  python -m cudaraytracer_tpu_torch.apps.render --obj mesh.obj --scale 10 \
      --integrator lambert --quirks fixed
  python -m cudaraytracer_tpu_torch.apps.render --scene icosphere \
      --accel bvh --quirks fixed   # the wavefront, triangles through a BVH
  python -m cudaraytracer_tpu_torch.apps.render --cpu --width 64 \
      --height 32 --spp 2      # the plain PyTorch path on the CPU
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scene", default="three_spheres",
                    choices=["three_spheres", "random_spheres", "light_box",
                             "textured_globe", "icosphere", "tex_icosphere",
                             "big_field", "big1m"],
                    help="icosphere: a 5,120-triangle icosphere on a "
                         "ground sphere; tex_icosphere: the same on "
                         "bench.py's 128x128 procedural image; big_field, "
                         "big1m: 5 x 5 and 12 x 17 copies of the "
                         "icosphere, 128,000 and 1,044,480 triangles")
    ap.add_argument("--textured", action="store_true",
                    help="random_spheres: about 1 in 5 small lambertians "
                         "on a procedural image")
    ap.add_argument("--obj", default=None, help="render an OBJ mesh instead")
    ap.add_argument("--scale", type=float, default=1.0, help="OBJ scale")
    ap.add_argument("--width", type=int, default=480)
    ap.add_argument("--height", type=int, default=270)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--max-depth", type=int, default=8)
    ap.add_argument("--integrator", default="path",
                    choices=["path", "lambert", "normal"])
    ap.add_argument("--accel", default="auto",
                    choices=["auto", "bruteforce", "sweeps", "bvh", "mega"],
                    help="mega: the fused kernel; sweeps: the wavefront "
                         "engine on the sweep kernels (the JAX CLI's "
                         "'pallas'); bvh: the wavefront engine with the "
                         "triangles through a BVH (the traversal kernel; "
                         "a scene without triangles renders by brute "
                         "force, labelled bvh->bruteforce); bruteforce: "
                         "the wavefront engine on brute-force tensor ops; "
                         "auto: mega where the kernel takes the scene (up "
                         "to 2^20 spheres or triangles, above 8,192 "
                         "through its segment level), else sweeps")
    ap.add_argument("--compact-after", type=int, default=0,
                    help="mega engine, path integrator: sort the wavefront "
                         "after N bounces (kernel mode K10); a scene of "
                         "2^16 prims or more takes the phased octant route "
                         "on its own (cfg.compact_auto)")
    ap.add_argument("--quirks", default="reference",
                    choices=["reference", "fixed"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="out.png")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the CPU")
    args = ap.parse_args(argv)
    if args.textured and args.scene != "random_spheres":
        ap.error("--textured applies to --scene random_spheres")

    import numpy as np
    import torch

    from ..config import Quirks, RenderConfig
    from ..core.camera import make_camera
    from ..core.device import resolve_device
    from ..models import check_scenes, presets
    from ..models.scene import SceneBuilder
    from ..ops.bvh import build_triangle_bvh
    from ..ops.megakernel import megakernel_supported, morton_tables
    from ..ops.render import bvh_intersector, render_image, sweep_intersector
    from ..utils.image import write_png
    from ..utils.obj_loader import face_normals, load_obj

    device = resolve_device("cpu" if args.cpu else None)
    aspect = args.width / args.height
    if args.obj:
        pts, faces = load_obj(args.obj)
        pts *= args.scale
        b = SceneBuilder()
        mat = b.materials.lambertian(color=(0.65, 0.05, 0.05))
        b.add_mesh(pts, faces, mat, normals=face_normals(pts, faces),
                   reverse_winding=True)
        scene = b.build(device)
        ext = pts.max(0) - pts.min(0)
        c = pts.mean(0)
        cam = make_camera(c + [0, 0.1 * ext[1], 2.2 * ext.max()], c,
                          (0, 1, 0), 40.0, aspect, 0.0, 10.0, device=device)
    elif args.scene in ("icosphere", "tex_icosphere", "big_field", "big1m"):
        scene, cam = getattr(check_scenes, args.scene + "_scene")(
            aspect, device=device)
    else:
        kw = {"textured": True} if args.textured else {}
        scene, cam = getattr(presets, args.scene)(aspect=aspect,
                                                  device=device, **kw)

    quirks = Quirks.reference() if args.quirks == "reference" \
        else Quirks.fixed()
    accel = args.accel
    if accel == "auto":
        accel = "mega" if megakernel_supported(scene) else "sweeps"
    cfg = RenderConfig(width=args.width, height=args.height,
                       samples=args.spp, max_depth=args.max_depth,
                       integrator=args.integrator, quirks=quirks,
                       engine="mega" if accel == "mega" else "wavefront",
                       compact_after=args.compact_after)
    tables = morton_tables(scene) if accel == "mega" else None
    isect = sweep_intersector(cfg) if accel == "sweeps" else None
    if accel == "bvh" and scene.n_triangles:
        tri = scene.triangles
        isect = bvh_intersector(cfg, build_triangle_bvh(
            tri.v0, tri.v1, tri.v2, device=device))
    # label what ran: --accel bvh on a scene without triangles renders by
    # brute force
    accel_used = ("bvh->bruteforce" if accel == "bvh" and isect is None
                  else accel)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.perf_counter()
    with torch.no_grad():
        img = render_image(scene, cam, cfg, generator=gen, tables=tables,
                           intersect_fn=isect)
    img = img.cpu().numpy()       # waits for the device
    dt = time.perf_counter() - t0
    write_png(args.out, np.asarray(img))
    rays = args.width * args.height * args.spp
    print(f"rendered {args.width}x{args.height}x{args.spp}spp "
          f"({args.integrator}, {accel_used} on {device}) in {dt:.2f}s "
          f"[{rays / dt / 1e6:.2f} Mrays/s] -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
