"""Scenes that hold the kernel to its semantics, shared by the tests and
``chip_smoke.py``:

  * ``mixed_scene``: spheres and triangles, all four materials and a checker
    texture (the mixed scene of tests/test_megakernel.py);
  * ``fill_duplicate_scene``: prims each followed by an exact copy in
    another colour, so the first prim must win every tie;
  * ``fill_tie_scene``: exact t ties across chunks and between a sphere and
    a triangle, with the colours the winners must give;
  * ``fill_icosphere_scene``: a 5,120-triangle subdivided icosahedron on a
    checker ground sphere, the triangle frame of the main-path check (it
    fills 20 super boxes and 320 chunk boxes, so the two-level triangle
    cull runs).

The ``fill_*`` functions take a SceneBuilder and return it, so the same
scene can be built by any builder with this package's interface.
"""

from __future__ import annotations

import numpy as np

from ..core.camera import make_camera
from .scene import SceneBuilder


def mixed_scene(device=None):
    """(Scene, Camera): spheres + triangles, all four materials, a checker
    texture."""
    b = SceneBuilder()
    m = b.materials
    chk = m.lambertian(m.textures.checker((0.9, 0.9, 0.9), (0.1, 0.2, 0.1)))
    red = m.lambertian(color=(0.9, 0.2, 0.2))
    met = m.metal((0.8, 0.7, 0.3), fuzz=0.2)
    glass = m.dielectric(1.5)
    light = m.diffuse_light(color=(4.0, 4.0, 4.0))
    b.add_sphere((0, -100.5, -3), 100.0, chk)
    b.add_sphere((-1.1, 0, -3), 0.5, glass)
    b.add_sphere((1.1, 0, -3), 0.5, met)
    pts = np.array([[0, 0, -3], [0.5, 0, -2.6], [-0.5, 0, -2.6],
                    [0, 0.8, -2.8]], np.float32)
    for tri in [(0, 1, 3), (1, 2, 3), (2, 0, 3), (0, 2, 1)]:
        v = pts[list(tri)]
        b.add_triangle(v[0], v[1], v[2], red)
    b.add_triangle((-1, 2.0, -2.5), (1, 2.0, -2.5), (0, 2.0, -4), light,
                   normal=(0, -1, 0))
    cam = make_camera((0, 0.4, 2), (0, 0.2, -3), vfov=45, aspect=2.0,
                      focus_dist=5.0, device=device)
    return b.build(device), cam


def fill_duplicate_scene(b, duplicates: bool = True):
    """Two spheres and a triangle on a ground sphere, each optionally
    followed by an exact copy in another colour: the first prim must win
    every tie, so the copies change nothing."""
    m = b.materials
    colours = [m.lambertian(color=c) for c in
               ((0.9, 0.0, 0.0), (0.0, 0.9, 0.0), (0.0, 0.0, 0.9),
                (0.9, 0.9, 0.0))]
    b.add_sphere((0, -100.5, -3), 100.0, colours[3])
    for k, centre in enumerate(((-0.6, 0.0, -3.0), (0.6, 0.1, -3.2))):
        b.add_sphere(centre, 0.4, colours[k])
        if duplicates:
            b.add_sphere(centre, 0.4, colours[k + 1])
    tri = ((-0.3, 0.5, -2.5), (0.3, 0.5, -2.5), (0.0, 0.9, -2.6))
    b.add_triangle(*tri, colours[2])
    if duplicates:
        b.add_triangle(*tri, colours[0])
    return b


def duplicate_scene(device=None, duplicates: bool = True):
    """(Scene, Camera) of ``fill_duplicate_scene``."""
    cam = make_camera((0, 0.35, 1.2), (0, 0, -1), (0, 1, 0), 45.0, 2.0, 0.0,
                      10.0, device=device)
    return fill_duplicate_scene(SceneBuilder(), duplicates).build(device), cam


# Two rays that meet exact ties: (0, 0, 5) -> (0, 0, -1) hits sphere B and
# the triangle both at t = 4 exactly; (3, 0, 5) -> (0, 0, -1) hits sphere A
# and its copy A', 21 prims later (another chunk), both at t = 4.5.
TIE_ORIGINS = np.array([[0, 0, 5], [3, 0, 5]], np.float32)
TIE_DIRECTIONS = np.array([[0, 0, -1], [0, 0, -1]], np.float32)
TIE_EXPECTED = np.array([[0.0, 0.0, 0.9], [0.9, 0.0, 0.0]], np.float32)


def fill_tie_scene(b):
    """The tie scene: every prim is a light of its own colour, so a path of
    depth 0 under fixed quirks returns the winner's colour (TIE_EXPECTED:
    sphere B over the triangle, A over A')."""
    m = b.materials
    red, green, blue, yellow, grey = (
        m.diffuse_light(color=c) for c in
        ((0.9, 0, 0), (0, 0.9, 0), (0, 0, 0.9), (0.9, 0.9, 0),
         (0.2, 0.2, 0.2)))
    b.add_sphere((3, 0, 0), 0.5, red)
    for i in range(20):
        b.add_sphere((10 + i, 10, -50), 0.1, grey)
    b.add_sphere((3, 0, 0), 0.5, green)
    b.add_sphere((0, 0, 0), 1.0, blue)
    b.add_triangle((-1, -1, 1), (1, -1, 1), (0, 1, 1), yellow)
    return b


def icosphere(subdivisions: int):
    """Unit icosphere: (points float32[P, 3], faces int32[20 * 4^s, 3]),
    faces counter-clockwise seen from outside."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    verts = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t),
             (0, 1, t), (0, -1, -t), (0, 1, -t), (t, 0, -1), (t, 0, 1),
             (-t, 0, -1), (-t, 0, 1)]
    verts = [np.array(v, np.float64) / np.linalg.norm(v) for v in verts]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    for _ in range(subdivisions):
        mid = {}

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                v = verts[a] + verts[b]
                verts.append(v / np.linalg.norm(v))
                mid[key] = len(verts) - 1
            return mid[key]

        new = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new
    return np.array(verts, np.float32), np.array(faces, np.int32)


def fill_icosphere_scene(b):
    """A 5,120-triangle icosphere on a checker ground sphere."""
    pts, faces = icosphere(4)
    m = b.materials
    b.add_sphere((0, -1000, 0), 1000.0, m.lambertian(
        tex_id=m.textures.checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))))
    b.add_mesh(pts, faces, m.lambertian(color=(0.8, 0.3, 0.2)),
               reverse_winding=False, position=(0, 1, 0))
    return b


def icosphere_scene(aspect: float, device=None):
    """(Scene, Camera) of ``fill_icosphere_scene``."""
    cam = make_camera((0, 1.6, 4.5), (0, 0.9, 0), (0, 1, 0), 40.0, aspect,
                      0.0, 10.0, device=device)
    return fill_icosphere_scene(SceneBuilder()).build(device), cam
