"""What the drivers share: the program's scene and camera built from the
benchmark's input arrays, the pixels a check reads, and the comparison of
finished pixels."""

from __future__ import annotations

import numpy as np
import torch

from .. import seeds

LAMBERTIAN, METAL, DIELECTRIC = 0, 1, 2
CONSTANT, CHECKER = 0, 1


def program_scene(a: dict, device):
    """The program's Scene of the sphere scene arrays ``a``
    (``inputs/one_weekend.scene_arrays``), through its SceneBuilder, every
    texture, material and sphere in the arrays' order."""
    from cudaraytracer_tpu_torch.models.scene import SceneBuilder
    b = SceneBuilder()
    m, tx = b.materials, b.materials.textures
    for k, c0, c1 in zip(a["tex_kind"], a["tex_c0"], a["tex_c1"]):
        if k == CHECKER:
            tx.checker(c0, c1)
        else:
            tx.constant(c0)
    for k, t, alb, fz, ri in zip(a["mat_kind"], a["mat_tex"], a["mat_albedo"],
                                 a["mat_fuzz"], a["mat_ref_idx"]):
        if k == LAMBERTIAN:
            m.lambertian(tex_id=int(t))
        elif k == METAL:
            m.metal(alb, float(fz))
        else:
            m.dielectric(float(ri))
    for c, r, mi in zip(a["center"], a["radius"], a["sph_mat"]):
        b.add_sphere(c, float(r), int(mi))
    return b.build(device)


def program_camera(p: dict, device):
    from cudaraytracer_tpu_torch.core.camera import make_camera
    return make_camera(p["lookfrom"], p["lookat"], p["vup"], p["vfov"],
                       p["aspect"], p["aperture"], p["focus_dist"],
                       device=device)


def render_config(s: dict):
    """The program's RenderConfig of the cell's render settings."""
    from cudaraytracer_tpu_torch.config import Quirks, RenderConfig
    if s.get("quirks", "reference") != "reference":
        raise ValueError("the benchmark's configurations run the reference "
                         "quirks")
    return RenderConfig(width=s["width"], height=s["height"],
                        samples=s["samples"], max_depth=s["max_depth"],
                        integrator=s["integrator"], t_min=s["t_min"],
                        t_max=s["t_max"], gamma=s["gamma"], clip=s["clip"],
                        quirks=Quirks.reference(),
                        ray_chunk=s["ray_chunk"], engine=s["engine"])


def picks(seed: int, tag: int, width: int, height: int, n: int) -> np.ndarray:
    """``n`` distinct flat pixel indices drawn from the seed (sorted)."""
    n = min(n, width * height)
    return np.sort(seeds.rng(seed, tag).choice(width * height, n,
                                               replace=False))


def swizzle_positions(width: int, height: int, pixels: np.ndarray, device):
    """(the renderer's pixel order, the positions of ``pixels`` in it,
    sorted, and the index that puts values in that sorted order back in
    ``pixels``' order)."""
    from ..reference.camera import swizzled_pixels
    order = swizzled_pixels(width, height, device)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=device)
    pos, perm = torch.sort(inv[torch.as_tensor(pixels, device=device)])
    return order, pos, torch.argsort(perm)


def pixel_gaps(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """The comparison of finished pixels [n, 3] (values in [0, 1]): the
    mean and the largest absolute difference over every channel of every
    pixel, and the share of pixels with a channel more than 1/255 off."""
    diff = (got.double() - ref.double()).abs()
    if not torch.isfinite(got).all():
        return {"px_mean_abs": float("inf"), "px_max_abs": float("inf"),
                "px_share_off": 1.0}
    return {"px_mean_abs": float(diff.mean()),
            "px_max_abs": float(diff.max()),
            "px_share_off": float((diff.amax(1) > 1.0 / 255.0)
                                  .double().mean())}
