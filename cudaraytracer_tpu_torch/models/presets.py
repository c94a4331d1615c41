"""Canonical scenes (the JAX package's presets; the same numpy seed gives the
same scene).

  three_spheres  - lambertian / metal / dielectric trio on a ground sphere.
  random_spheres - the "One Weekend" final scene (484 spheres at n = 22).
  fbx_walk_camera - the FBX pipeline's camera (createScene.h:160).

``light_box`` (a rect) and ``textured_globe`` (a rect and image textures)
need kernel modes K8 and K9, which come with slice 5.
"""

from __future__ import annotations

import numpy as np

from ..core.camera import Camera, make_camera
from ..core.device import resolve_device
from .scene import SceneBuilder


def three_spheres(aspect: float = 16 / 9, device=None):
    """Lambertian center, metal right, dielectric left, big ground sphere."""
    device = resolve_device(device)
    b = SceneBuilder()
    m = b.materials
    ground = m.lambertian(color=(0.8, 0.8, 0.0))
    center = m.lambertian(color=(0.1, 0.2, 0.5))
    left = m.dielectric(1.5)
    right = m.metal((0.8, 0.6, 0.2), fuzz=0.0)
    b.add_sphere((0, -100.5, -1), 100.0, ground)
    b.add_sphere((0, 0, -1), 0.5, center)
    b.add_sphere((-1, 0, -1), 0.5, left)
    b.add_sphere((1, 0, -1), 0.5, right)
    cam = make_camera((0, 0.35, 1.2), (0, 0, -1), (0, 1, 0), 45.0, aspect,
                      0.0, 10.0, device=device)
    return b.build(device), cam


def random_spheres(aspect: float = 16 / 9, seed: int = 7, n: int = 22,
                   textured: bool = False, device=None):
    """'One Weekend' final scene: n x n grid of small random spheres + 3 big.

    textured=True swaps ~1 in 5 small lambertians (and the big left sphere)
    to a procedural image texture; the fused engine raises on it until
    slice 5."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    m = b.materials
    ground = m.lambertian(
        tex_id=m.textures.checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9)))
    img_mat = None
    if textured:
        jj, ii = np.meshgrid(np.arange(64), np.arange(128), indexing="ij")
        tex_img = np.stack([(ii * 5 + jj * 3) % 256,
                            (ii * 11) % 256,
                            (jj * 7) % 256], -1).astype(np.uint8)
        img_mat = m.lambertian(tex_id=m.textures.image(tex_img))
    b.add_sphere((0, -1000, 0), 1000.0, ground)
    half = n // 2
    k = 0
    for a in range(-half, half):
        for c in range(-half, half):
            choose = rng.uniform()
            cen = np.array([a + 0.9 * rng.uniform(), 0.2,
                            c + 0.9 * rng.uniform()])
            if np.linalg.norm(cen - np.array([4, 0.2, 0])) <= 0.9:
                continue
            if choose < 0.8:
                albedo = rng.uniform(size=3) * rng.uniform(size=3)
                k += 1
                mat = (img_mat if textured and k % 5 == 0
                       else m.lambertian(color=albedo))
                b.add_sphere(cen, 0.2, mat)
            elif choose < 0.95:
                albedo = 0.5 * (1 + rng.uniform(size=3))
                b.add_sphere(cen, 0.2, m.metal(albedo, 0.5 * rng.uniform()))
            else:
                b.add_sphere(cen, 0.2, m.dielectric(1.5))
    b.add_sphere((0, 1, 0), 1.0, m.dielectric(1.5))
    b.add_sphere((-4, 1, 0), 1.0,
                 img_mat if textured else m.lambertian(color=(0.4, 0.2, 0.1)))
    b.add_sphere((4, 1, 0), 1.0, m.metal((0.7, 0.6, 0.5), 0.0))
    cam = make_camera((13, 2, 3), (0, 0, 0), (0, 1, 0), 20.0, aspect, 0.0,
                      10.0, device=device)
    return b.build(device), cam


def light_box(aspect: float = 1.0, device=None):
    raise NotImplementedError(
        "light_box holds a rect (kernel mode K8): ROADMAP Queue 1 item 16 "
        "(slice 5)")


def textured_globe(aspect: float = 16 / 9, device=None):
    raise NotImplementedError(
        "textured_globe holds a rect and image textures (kernel modes K8, "
        "K9): ROADMAP Queue 1 items 16-17 (slice 5)")


def fbx_walk_camera(aspect: float = 2.0, device=None) -> Camera:
    """The active camera config of the FBX pipeline (createScene.h:160)."""
    return make_camera((0, 100, 1000), (0, 150, 0), (0, 1, 0), 40.0, aspect,
                       0.0, 10.0, device=device)
