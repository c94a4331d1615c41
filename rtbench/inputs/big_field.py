"""The big field (the JAX package's ``bench.py:93-114`` ``big_field``: 5 x 5
copies of the Stanford bunny, 124k triangles), with the 5,120-triangle
unit icosphere standing in for the bunny, as plain numpy arrays that both
the program and the reference build their scenes from.

A frozen copy of ``models/check_scenes.py``'s ``icosphere``,
``icosphere_field_mesh`` and ``field_camera``: copy ``i * nz + j`` of the
icosphere offset by x = (i - nx // 2) * 1.15 * extent, z = -j * 1.3 *
extent, as ``bench.py`` offsets its bunnies; each face's outward normal
from its own winding, and the triangles added in the reversed winding of
``bench.py``'s ``add_mesh`` calls (createScene.h:185), normals kept.  The
layout is the same for every benchmark seed, so every seed has the same
work; ``seed`` draws each copy's lambertian albedo.
"""

from __future__ import annotations

import numpy as np


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


def face_normals(points: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Unit normals of the faces' own winding (triangle.h:14-17)."""
    tri = points[faces]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    return (n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
            ).astype(np.float32)


def field_mesh(nx: int, nz: int, subdivisions: int = 4):
    """nx x nz copies of the icosphere -> (points float32[P, 3], faces
    int32[T, 3], outward face normals float32[T, 3], extent float32[3])."""
    pts, faces = icosphere(subdivisions)
    ext = pts.max(0) - pts.min(0)
    copies, offsets = [], []
    for i in range(nx):
        for j in range(nz):
            copies.append(faces + len(pts) * len(copies))
            offsets.append(pts + np.array([(i - nx // 2) * 1.15 * ext[0],
                                           0.0, -j * 1.3 * ext[2]],
                                          np.float32))
    return (np.concatenate(offsets), np.concatenate(copies),
            np.tile(face_normals(pts, faces), (nx * nz, 1)), ext)


def scene_arrays(seed: int, copies=(5, 5), subdivisions: int = 4) -> dict:
    """The scene as flat arrays:

    - ``points`` float32[P, 3], ``faces`` int32[T, 3] (each face's
      vertices in the icosphere's own winding; the scene adds them
      reversed), ``normals`` float32[T, 3] (outward, of the unreversed
      faces);
    - ``copy`` int32[T]: each face's copy, the faces of a copy contiguous;
    - ``albedo`` float32[C, 3]: each copy's lambertian albedo (a constant
      texture), drawn from ``seed``.
    """
    nx, nz = copies
    points, faces, normals, _ = field_mesh(nx, nz, subdivisions)
    colours = np.random.default_rng(np.random.SeedSequence(
        [int(seed) & 0xFFFFFFFF, int(seed) >> 32, 0xB1F]))
    albedo = np.stack([colours.uniform(size=3) * colours.uniform(size=3)
                       for _ in range(nx * nz)]).astype(np.float32)
    per_copy = faces.shape[0] // (nx * nz)
    return {"points": points, "faces": faces, "normals": normals,
            "copy": np.repeat(np.arange(nx * nz, dtype=np.int32), per_copy),
            "albedo": albedo}


def triangles(a: dict) -> np.ndarray:
    """float32[T, 3, 3]: each triangle's vertices as the scene holds them,
    points[face[2]], points[face[1]], points[face[0]] (the reversed
    winding, createScene.h:185)."""
    return a["points"][a["faces"][:, ::-1]]


def camera_params(aspect: float, nz: int = 5, subdivisions: int = 4) -> dict:
    """``bench.py``'s field camera over nz rows of icospheres (``make_camera``
    arguments): from (0, 2.2, 3.2) toward (0, 0.35, -(nz // 2) * 1.3 *
    extent), vfov 50, focus 10, no aperture."""
    pts, _ = icosphere(subdivisions)
    ext = pts.max(0) - pts.min(0)
    return {"lookfrom": (0.0, 2.2, 3.2),
            "lookat": (0.0, 0.35, float(-(nz // 2) * 1.3 * ext[2])),
            "vup": (0.0, 1.0, 0.0), "vfov": 50.0, "aspect": aspect,
            "aperture": 0.0, "focus_dist": 10.0}
