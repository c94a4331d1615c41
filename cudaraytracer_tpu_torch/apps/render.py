"""Still-image rendering CLI on the port: a preset scene or an OBJ mesh to
PNG through the fused CUDA kernel.

Examples:
  python -m cudaraytracer_tpu_torch.apps.render --scene random_spheres \
      --width 1920 --height 1080 --spp 16 --out out.png
  python -m cudaraytracer_tpu_torch.apps.render --obj mesh.obj --scale 10 \
      --integrator lambert --quirks fixed
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
                             "textured_globe"])
    ap.add_argument("--obj", default=None, help="render an OBJ mesh instead")
    ap.add_argument("--scale", type=float, default=1.0, help="OBJ scale")
    ap.add_argument("--width", type=int, default=480)
    ap.add_argument("--height", type=int, default=270)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--max-depth", type=int, default=8)
    ap.add_argument("--integrator", default="path",
                    choices=["path", "lambert", "normal"])
    # the fused kernel is this slice's only engine (bruteforce, bvh and
    # pallas come with later slices)
    ap.add_argument("--accel", default="auto", choices=["auto", "mega"])
    ap.add_argument("--compact-after", type=int, default=0,
                    help="mega engine: sort the wavefront after N bounces "
                         "(not ported yet: rejected when > 0)")
    ap.add_argument("--quirks", default="reference",
                    choices=["reference", "fixed"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="out.png")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the CPU")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..config import Quirks, RenderConfig
    from ..core.camera import make_camera
    from ..core.device import resolve_device
    from ..models import presets
    from ..models.scene import SceneBuilder
    from ..ops.megakernel import morton_tables
    from ..ops.render import render_image
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
    else:
        scene, cam = getattr(presets, args.scene)(aspect=aspect,
                                                  device=device)

    quirks = Quirks.reference() if args.quirks == "reference" \
        else Quirks.fixed()
    cfg = RenderConfig(width=args.width, height=args.height,
                       samples=args.spp, max_depth=args.max_depth,
                       integrator=args.integrator, quirks=quirks,
                       engine="mega", compact_after=args.compact_after)
    tables = morton_tables(scene)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    t0 = time.perf_counter()
    img = render_image(scene, cam, cfg, generator=gen, tables=tables)
    img = img.cpu().numpy()       # waits for the device
    dt = time.perf_counter() - t0
    write_png(args.out, np.asarray(img))
    rays = args.width * args.height * args.spp
    print(f"rendered {args.width}x{args.height}x{args.spp}spp "
          f"({args.integrator}, mega on {device}) in {dt:.2f}s "
          f"[{rays / dt / 1e6:.2f} Mrays/s] -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
