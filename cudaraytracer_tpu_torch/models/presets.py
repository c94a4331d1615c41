"""Canonical scenes (the JAX package's presets; the same numpy seed gives the
same scene).

  three_spheres  - lambertian / metal / dielectric trio on a ground sphere.
  random_spheres - the "One Weekend" final scene (484 spheres at n = 22).
  light_box      - an emissive rect over a checker floor and a metal sphere.
  textured_globe - an image-textured globe under an image-textured rect
                   light (kernel modes K8 and K9 in the fused engine).
  fbx_walk_camera - the FBX pipeline's camera (createScene.h:160).
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
    to a shared procedural 128x64 image texture, the headline frame with
    images (kernel mode K9 in the fused engine)."""
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
    """Emissive rect + checker floor + metal sphere: textures, lights and a
    rect (kernel mode K8 in the fused engine)."""
    device = resolve_device(device)
    b = SceneBuilder()
    m = b.materials
    floor = m.lambertian(tex_id=m.textures.checker((0.1, 0.1, 0.1),
                                                   (0.9, 0.9, 0.9)))
    light = m.diffuse_light(color=(4.0, 4.0, 4.0))
    shiny = m.metal((0.9, 0.9, 0.9), 0.05)
    b.add_sphere((0, -1000, 0), 1000.0, floor)
    b.add_sphere((0, 1, 0), 1.0, shiny)
    b.add_rect(light, flip=True, position=(0, 2, 3), rotation=(0, 0, 0),
               scale=(3, 3, 1))
    cam = make_camera((0, 2, 8), (0, 1, 0), (0, 1, 0), 35.0, aspect, 0.0,
                      10.0, device=device)
    return b.build(device), cam


def textured_globe(aspect: float = 16 / 9, device=None):
    """Image-textured lambertian globe (a procedural lat/long swirl) and an
    image-textured overhead rect light over a checker floor, beside a glass
    and a metal sphere: the ImageTexture showcase (texture.h:54-76).  The
    globe's image is texture 0, so the glass and the metal sphere's default
    tex_id points at it: a metal ignores it."""
    device = resolve_device(device)
    b = SceneBuilder()
    m = b.materials
    # procedural "earth-like" texture: latitude bands + longitudinal swirl
    h, w = 128, 256
    jj, ii = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    lat = jj / (h - 1.0)
    lon = ii / (w - 1.0)
    swirl = 0.5 + 0.5 * np.sin(12.0 * np.pi * lon + 6.0 * np.sin(
        4.0 * np.pi * lat))
    land = (swirl * (1.0 - lat) > 0.35)
    img = np.where(land[..., None],
                   np.stack([0.25 + 0.5 * lat] * 3, -1) * [0.9, 0.7, 0.3],
                   np.stack([0.1 + 0.2 * lat, 0.3 + 0.3 * lat,
                             0.7 + 0.25 * lat], -1))
    globe_tex = m.textures.image((img * 255).astype(np.uint8))
    glow = (np.full((16, 16, 3), 255) * np.linspace(
        0.6, 1.0, 16)[:, None, None]).astype(np.uint8)
    light_tex = m.textures.image(glow)
    b.add_sphere((0, -100.5, -3), 100.0, m.lambertian(
        m.textures.checker((.8, .8, .8), (.25, .3, .25))))
    b.add_sphere((0, 0.05, -3), 0.6, m.lambertian(tex_id=globe_tex))
    b.add_sphere((-1.3, 0, -3), 0.5, m.dielectric(1.5))
    b.add_sphere((1.3, 0, -3), 0.5, m.metal((0.85, 0.8, 0.75), fuzz=0.03))
    b.add_rect(m.diffuse_light(tex_id=light_tex), position=(0, 2.0, -3),
               rotation=(90, 0, 0), scale=(2.5, 2.5, 1))
    cam = make_camera((0, 0.5, 1.4), (0, 0.15, -3), (0, 1, 0), 50.0,
                      aspect, 0.0, 4.5, device=device)
    return b.build(device), cam


def fbx_walk_camera(aspect: float = 2.0, device=None) -> Camera:
    """The active camera config of the FBX pipeline (createScene.h:160)."""
    return make_camera((0, 100, 1000), (0, 150, 0), (0, 1, 0), 40.0, aspect,
                       0.0, 10.0, device=device)
