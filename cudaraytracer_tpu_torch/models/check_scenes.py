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
    cull runs); ``fill_tex_icosphere_scene`` puts bench.py's 128x128
    procedural image on it (a stand-in for bench.py's textured bunny,
    whose asset the repository does not hold);
  * ``fill_trs_showcase``: runtime-TRS spheres (one checker), a runtime-TRS
    metal triangle, a ground sphere and a rect light (the showcase of
    tests/test_transform_prims.py), every rect / TRS path of kernel mode
    K8;
  * ``fill_trs_field``: ``k`` each of TRS spheres, TRS triangles and rects
    scattered in front of the camera (the generator of
    tests/test_transform_prims.py:168-207), above the JAX engine's
    1024-per-class cap when k > 1024;
  * scenes above the table-resident size (8,192 prims of a type), which
    take the segment level (kernel mode K6): ``fill_icosphere_field``, a
    grid of the 5,120-triangle icosphere laid out as bench.py lays out its
    bunnies (``big_field_scene``: 5 x 5 copies, 128,000 triangles, in place
    of bench.py's 124k-triangle big_field; ``big1m_scene``: 12 x 17 copies,
    1,044,480 triangles, under the 2^20 ceiling, in place of its big1m,
    whose 14 x 15 grid would exceed it); ``fill_terrain``, a 10,368-triangle
    height field with a metal sphere (tests/test_megakernel.py:202-230);
    ``fill_sphere_field``, 96 x 96 = 9,216 small spheres
    (tests/test_megakernel.py:790-806); with ``terrain_rays`` and
    ``sphere_field_rays``, the rays those tests cast;
  * ``plane_rays``: axis-parallel rays whose origins lie on the planes of
    given boxes, where the negated slab test reads NaN (which keeps the
    box reachable) and a two-level cull must not lose a hit;
  * ``tangent_rays``: rays tangent to spheres where the spheres touch
    their boxes' faces, grazing or just missing (the sphere boxes'
    margin, ops/sweeps.py SPH_MARGIN);
  * ``xform_edge_rays``: rays through rect edges, tangent to TRS spheres,
    through TRS triangle vertices and axis-parallel through all of them
    (K8's chunk cull); ``trs_duplicates_scene`` with ``duplicate_orders``:
    a TRS field whose rows each have an exact copy, walked copies first;
  * ``sliver_cylinder`` with ``grazing_rays``: a cylinder of 4,096 long
    thin triangles (sides 4 and 0.003) and rays that graze it, where
    Moller-Trumbore's rounding is largest (the triangle cull's margin,
    ops/sweeps.py TRI_MARGIN);
  * skinned stand-ins for the reference's animated FBX character
    (low_walking.fbx, which the repository does not hold), 31 frames each,
    the reference's frames 0-30 (kernel.cu:50-51), as loader-shaped
    ``SkinnedMesh`` records for ``apps/animate.py``: ``skinned_capsule``,
    the 5,120-triangle icosphere stretched into a capsule in
    ``presets.fbx_walk_camera``'s view, its upper bone bending to 60
    degrees (the resident tables, kernel mode K1), and ``skinned_field``,
    big_field's 128,000 triangles as one mesh whose two halves sway on two
    bones under ``field_camera`` (the segment level, K6, with the tables
    rebuilt every frame); ``write_ascii_fbx`` writes a mesh's bind pose as
    an ASCII FBX for the driver's loader.

The ``fill_*`` functions take a SceneBuilder and return it, so the same
scene can be built by any builder with this package's interface.
"""

from __future__ import annotations

import numpy as np

from ..core.camera import make_camera
from ..utils.fbx_loader import SkinnedMesh
from .scene import SceneBuilder

ANIM_FRAMES = 31            # the reference animates frames 0-30


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
    return fill_icosphere_scene(SceneBuilder()).build(device), \
        _icosphere_camera(aspect, device)


def _icosphere_camera(aspect: float, device=None):
    return make_camera((0, 1.6, 4.5), (0, 0.9, 0), (0, 1, 0), 40.0, aspect,
                       0.0, 10.0, device=device)


def _bench_texture() -> np.ndarray:
    """bench.py's 128x128 procedural image (bench.py:131-134),
    uint8[128, 128, 3]."""
    jj, ii = np.meshgrid(np.arange(128), np.arange(128), indexing="ij")
    return np.stack([(ii * 5 + jj * 3) % 256, (ii * 11) % 256,
                     (jj * 7) % 256], -1).astype(np.uint8)


def fill_tex_icosphere_scene(b):
    """``fill_icosphere_scene`` with the mesh on a lambertian textured by
    ``_bench_texture``: its Moller-Trumbore (u, v) picks the texel."""
    pts, faces = icosphere(4)
    m = b.materials
    b.add_sphere((0, -1000, 0), 1000.0, m.lambertian(
        tex_id=m.textures.checker((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))))
    b.add_mesh(pts, faces,
               m.lambertian(tex_id=m.textures.image(_bench_texture())),
               reverse_winding=False, position=(0, 1, 0))
    return b


def tex_icosphere_scene(aspect: float, device=None):
    """(Scene, Camera) of ``fill_tex_icosphere_scene``, the icosphere's
    camera."""
    return fill_tex_icosphere_scene(SceneBuilder()).build(device), \
        _icosphere_camera(aspect, device)


def fill_trs_showcase(b):
    """Two runtime-TRS spheres (one checker-textured), a runtime-TRS metal
    triangle, a plain ground sphere and a rect light."""
    m = b.materials
    ground = m.lambertian(color=(0.5, 0.7, 0.3))
    red = m.lambertian(color=(0.9, 0.2, 0.2))
    chk = m.lambertian(m.textures.checker((0.9, 0.9, 0.1), (0.1, 0.1, 0.1)))
    met = m.metal((0.8, 0.6, 0.2), 0.1)
    light = m.diffuse_light(color=(2.0, 2.0, 2.0))
    b.add_sphere((0, -100.5, -3), 100.0, ground)
    b.add_sphere((0, 0, -3), 0.8, red, rotation=(0, 30, 0), scale=(1, 2, 1))
    b.add_sphere((-1.8, 0, -3), 0.6, chk, rotation=(20, 0, 45))
    b.add_triangle((-0.8, -0.4, 0), (0.8, -0.4, 0), (0, 0.9, 0), met,
                   position=(1.9, 0, -2.5), rotation=(0, -25, 0),
                   scale=(1, 1.3, 1))
    b.add_rect(light, position=(0, 2.5, -3), rotation=(90, 0, 0),
               scale=(3, 3, 1))
    return b


def trs_showcase_scene(aspect: float, device=None):
    """(Scene, Camera) of ``fill_trs_showcase``."""
    cam = make_camera((0, 0.3, 1), (0, 0, -3), vfov=55, aspect=aspect,
                      focus_dist=4.0, device=device)
    return fill_trs_showcase(SceneBuilder()).build(device), cam


def _trs_field_rows(k: int, seed: int) -> tuple:
    """The random rows of ``fill_trs_field``: (spheres, triangles, rects),
    each a list of (position, rotation, scale, extra, kind) with kind 0
    red, 1 metal, 2 light."""
    rng = np.random.default_rng(seed)
    sph, tri, rect = [], [], []
    for i in range(k):
        p = rng.uniform([-3, -0.3, -6], [3, 1.2, -2])
        r = rng.uniform(0.08, 0.2)
        sph.append((p, tuple(rng.uniform(-90, 90, 3)),
                    tuple(rng.uniform(0.6, 1.6, 3)), r, 0 if i % 3 else 1))
    for i in range(k):
        p = rng.uniform([-3, -0.3, -6], [3, 1.2, -2])
        tri.append((tuple(p), tuple(rng.uniform(-90, 90, 3)),
                    tuple(rng.uniform(0.7, 1.4, 3)), None, 0))
    for i in range(k):
        p = rng.uniform([-3, 1.4, -6], [3, 2.2, -2])
        rect.append((tuple(p), tuple(rng.uniform(-90, 90, 3)),
                     (0.3, 0.3, 1.0), None, 2 if i % 9 == 0 else 0))
    return sph, tri, rect


def fill_trs_field(b, k: int, seed: int = 3, copies: int = 1):
    """``k`` each of runtime-TRS spheres, runtime-TRS triangles and rects
    (one in nine a light) over a ground sphere.  copies: each class's k rows
    repeated that many times (rows k to 2k - 1 exact copies of rows 0 to k
    - 1, ...), each copy after the first in blue, so that the first copy
    must win every tie."""
    m = b.materials
    ground = m.lambertian(color=(0.5, 0.7, 0.3))
    red = m.lambertian(color=(0.9, 0.2, 0.2))
    met = m.metal((0.8, 0.6, 0.2), 0.1)
    light = m.diffuse_light(color=(2.0, 2.0, 2.0))
    blue = m.lambertian(color=(0.1, 0.2, 0.9)) if copies > 1 else None
    b.add_sphere((0, -100.5, -3), 100.0, ground)
    sph, tri, rect = _trs_field_rows(k, seed)
    kinds = (red, met, light)
    for c in range(copies):
        for p, rot, scl, r, kind in sph:
            b.add_sphere(p, r, kinds[kind] if c == 0 else blue,
                         rotation=rot, scale=scl)
    for c in range(copies):
        for p, rot, scl, _, kind in tri:
            b.add_triangle((-0.15, -0.1, 0), (0.15, -0.1, 0), (0, 0.2, 0),
                           kinds[kind] if c == 0 else blue, position=p,
                           rotation=rot, scale=scl)
    for c in range(copies):
        for p, rot, scl, _, kind in rect:
            b.add_rect(kinds[kind] if c == 0 else blue, position=p,
                       rotation=rot, scale=scl)
    return b


def trs_field_scene(k: int, aspect: float, device=None):
    """(Scene, Camera) of ``fill_trs_field``."""
    cam = make_camera((0, 0.3, 1), (0, 0.3, -3), vfov=60, aspect=aspect,
                      focus_dist=4.0, device=device)
    return fill_trs_field(SceneBuilder(), k).build(device), cam


def icosphere_field_mesh(nx: int, nz: int):
    """nx x nz copies of the 5,120-triangle unit icosphere, offset as
    bench.py:93-114 offsets its bunnies: x = (i - nx // 2) * 1.15 * extent,
    z = -j * 1.3 * extent, copy i * nz + j -> (points float32[P, 3], faces
    int32[T, 3], outward face normals float32[T, 3], extent float32[3])."""
    from ..utils.obj_loader import face_normals
    pts, faces = icosphere(4)
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


def fill_icosphere_field(b, nx: int, nz: int):
    """``icosphere_field_mesh`` on one lambertian (0.65, 0.05, 0.05), with
    the reversed winding of bench.py's add_mesh calls.  Returns (builder,
    extent float32[3])."""
    pts, faces, nrm, ext = icosphere_field_mesh(nx, nz)
    mat = b.materials.lambertian(color=(0.65, 0.05, 0.05))
    b.add_mesh(pts, faces, mat, normals=nrm, reverse_winding=True)
    return b, ext


def field_camera(aspect: float, nz: int = 5, device=None):
    """bench.py's field camera over nz rows of icospheres: from (0, 2.2,
    3.2) toward (0, 0.35, -(nz // 2) * 1.3 * extent), vfov 50, focus 10, no
    aperture."""
    pts, _ = icosphere(4)
    ext = pts.max(0) - pts.min(0)
    return make_camera((0, 2.2, 3.2),
                       (0.0, 0.35, float(-(nz // 2) * 1.3 * ext[2])),
                       (0, 1, 0), 50.0, aspect, 0.0, 10.0, device=device)


def field_scene(nx: int, nz: int, aspect: float, device=None):
    """(Scene, Camera) of ``fill_icosphere_field`` under ``field_camera``."""
    b, _ = fill_icosphere_field(SceneBuilder(), nx, nz)
    return b.build(device), field_camera(aspect, nz, device)


def big_field_scene(aspect: float, device=None):
    """5 x 5 icospheres, 128,000 triangles: the phased octant route."""
    return field_scene(5, 5, aspect, device)


def big1m_scene(aspect: float, device=None):
    """12 x 17 icospheres, 1,044,480 triangles."""
    return field_scene(12, 17, aspect, device)


def _terrain_triangles(n: int):
    """(float32[2 n^2, 3, 3] vertices, their unit normals facing down) of
    the terrain's height field."""
    xs = np.linspace(-5, 5, n + 1)
    zs = np.linspace(-10, 0, n + 1)
    X, Z = np.meshgrid(xs, zs)
    Y = 0.3 * np.sin(X * 1.3) * np.cos(Z * 1.1)
    P = np.stack([X, Y, Z], axis=-1).astype(np.float32)
    v0 = P[:-1, :-1].reshape(-1, 3)
    v1 = P[:-1, 1:].reshape(-1, 3)
    v2 = P[1:, :-1].reshape(-1, 3)
    v3 = P[1:, 1:].reshape(-1, 3)
    tris = np.concatenate([np.stack([v0, v1, v3], 1),
                           np.stack([v0, v3, v2], 1)])
    nrm = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-20)
    nrm[nrm[:, 1] > 0] *= -1.0
    return tris, nrm


def fill_terrain(b, n: int = 72):
    """A 2 n^2-triangle height field facing down (visible under the
    backface quirk) and a metal sphere above it."""
    mat = b.materials.lambertian(color=(0.7, 0.5, 0.3))
    tris, nrm = _terrain_triangles(n)
    for t, nn in zip(tris, nrm):
        b.add_triangle(t[0], t[1], t[2], mat, normal=nn)
    b.add_sphere((0, 2.0, -5), 0.8, b.materials.metal((0.9, 0.9, 0.9), 0.1))
    return b


# The tied terrain: every TIE_EVERY-th terrain triangle has an exact copy
# in another colour, after the terrain's triangles in the scene.
TIE_EVERY = 5


def fill_tied_terrain(b, n: int = 72):
    """``fill_terrain`` plus an exact copy of every TIE_EVERY-th triangle
    in a blue lambertian: a ray that reaches either meets an exact tie,
    which the original (the lower scene id and, in ``tied_terrain_order``,
    the lower table row) must win, so the copies change no pixel."""
    fill_terrain(b, n)
    blue = b.materials.lambertian(color=(0.1, 0.3, 0.9))
    tris, nrm = _terrain_triangles(n)
    for t, nn in zip(tris[::TIE_EVERY], nrm[::TIE_EVERY]):
        b.add_triangle(t[0], t[1], t[2], blue, normal=nn)
    return b


def tied_terrain_order(n: int = 72) -> np.ndarray:
    """A triangle order of ``fill_tied_terrain`` that puts each copy after
    its original: the Morton order (the copy right behind its original, in
    one chunk and one 32-triangle batch as a rule), then, by the copy's
    index mod 4, kept there, or moved 16 rows on (another chunk of the same
    batch where the original lies in a batch's first half), 300 rows on
    (another super) or 2,100 rows on (another segment), onto the next row
    that holds no tied triangle."""
    from ..ops.megakernel import morton_order
    tris, _ = _terrain_triangles(n)
    t = np.concatenate([tris, tris[::TIE_EVERY]])
    order = morton_order(t[:, 0], t[:, 1], t[:, 2])
    n_base = len(tris)
    row = np.empty(len(t), np.int64)
    row[order] = np.arange(len(t))
    copies = np.arange(n_base, len(t))
    originals = (copies - n_base) * TIE_EVERY
    tied = np.zeros(len(t), bool)
    tied[row[copies]] = tied[row[originals]] = True
    for j, (c, o) in enumerate(zip(copies, originals)):
        offset = (0, 16, 300, 2100)[j % 4]
        q = row[o] + offset
        while offset and q < len(t) and tied[q]:
            q += 1
        if not offset or q >= len(t):
            continue
        tied[row[c]], tied[q] = False, True
        other = order[q]
        order[row[c]], order[q] = other, c
        row[other], row[c] = row[c], q
    return order.astype(np.int32)


def terrain_rays(n: int, seed: int = 0):
    """(origins, directions) float32[n, 3] from (0, 4, 2) down onto the
    terrain."""
    rng = np.random.default_rng(seed)
    o = np.tile(np.array([[0, 4.0, 2.0]], np.float32), (n, 1))
    d = np.stack([rng.uniform(-0.6, 0.6, n), -np.ones(n),
                  rng.uniform(-1.6, -0.4, n)], 1).astype(np.float32)
    return o, d


def plane_rays(boxes: np.ndarray, target, n: int, seed: int = 0):
    """(origins, directions) float32[n, 3]: each ray starts on a plane of a
    random box of ``boxes`` (float32[k, 8]: lo.xyz, hi.xyz), its direction
    0 along that plane's axis and aimed at ``target`` in the other two, so
    that its slab test of the box reads 0 * inf = NaN."""
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, boxes.shape[0], n)
    axis = rng.integers(0, 3, n)
    side = rng.integers(0, 2, n)
    rows = np.arange(n)
    o = (np.asarray(target, np.float32)
         + rng.uniform(-4.0, 4.0, (n, 3))).astype(np.float32)
    o[rows, axis] = boxes[pick, 3 * side + axis]
    d = (np.asarray(target, np.float32) + rng.uniform(-0.5, 0.5, (n, 3))
         - o).astype(np.float32)
    d[rows, axis] = 0.0
    return o, d


def sliver_cylinder(nseg: int = 2048, height: float = 4.0):
    """(v0, v1, v2) float32[2 nseg, 3]: the side of a unit cylinder on
    y in [0, height], each of nseg strips split into two triangles, one
    with sides 0.003 and 4 and one whose two long edges lie 7.7e-4 rad
    apart."""
    a = np.linspace(0.0, 2.0 * np.pi, nseg + 1)[:-1]
    b = np.roll(a, -1)
    p0 = np.stack([np.cos(a), np.zeros_like(a), np.sin(a)], 1)
    p1 = np.stack([np.cos(b), np.zeros_like(b), np.sin(b)], 1)
    up = np.array([0.0, height, 0.0])
    v0 = np.concatenate([p0, p1])
    v1 = np.concatenate([p1, p1 + up])
    v2 = np.concatenate([p0 + up, p0 + up])
    return tuple(x.astype(np.float32) for x in (v0, v1, v2))


def grazing_rays(n: int, lo: float, hi: float, seed: int = 0,
                 height: float = 4.0):
    """(origins, directions) float32[n, 3] at sliver_cylinder: from 6
    units out, at an impact parameter b with 1 - |b| log-uniform in
    [lo, hi] (the angle to the surface about sqrt(2 (1 - |b|)) rad), a
    slight slope in y."""
    rng = np.random.default_rng(seed)
    g = np.exp(rng.uniform(np.log(lo), np.log(hi), n))
    b = (1.0 - g) * rng.choice([-1.0, 1.0], n)
    phi = rng.uniform(0.0, 2.0 * np.pi, n)
    along = np.stack([np.cos(phi), np.zeros(n), np.sin(phi)], 1)
    across = np.stack([-np.sin(phi), np.zeros(n), np.cos(phi)], 1)
    y = rng.uniform(0.025, 0.975, n) * height
    o = -6.0 * along + b[:, None] * across
    o[:, 1] = y
    d = along.copy()
    d[:, 1] = rng.uniform(-0.05, 0.05, n)
    return o.astype(np.float32), d.astype(np.float32)


def tangent_rays(center: np.ndarray, radius: np.ndarray, n: int,
                 seed: int = 0):
    """(origins, directions) float32[n, 3]: rays tangent to spheres
    (centres float32[k, 3], radii float32[k]) where a sphere touches a
    face of its box: at a random sphere, axis and side, the point c + r e
    (e = +-the axis), moved along e by up to 2^-20 (|c| + |r|) either way
    (a line that grazes the sphere or just misses it, where the computed
    discriminant's sign is a rounding), a direction in the face's plane
    (half the rays) or tilted out of it by up to 2^-12 rad, the origin 2 to
    6 radii before the point.  The exact box's face is the plane the ray
    runs in or crosses there."""
    rng = np.random.default_rng(seed)
    center = np.asarray(center, np.float64)
    radius = np.abs(np.asarray(radius, np.float64))
    pick = rng.integers(0, center.shape[0], n)
    axis = rng.integers(0, 3, n)
    sign = rng.choice([-1.0, 1.0], n)
    rows = np.arange(n)
    c, r = center[pick], radius[pick]
    e = np.zeros((n, 3))
    e[rows, axis] = sign
    scale = np.abs(c).max(1) + r
    off = rng.uniform(-1.0, 1.0, n) * 2.0 ** -20 * scale
    touch = c + (r + off)[:, None] * e
    u = rng.normal(size=(n, 3))
    u[rows, axis] = 0.0
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    tilt = np.where(rng.random(n) < 0.5, 0.0,
                    rng.uniform(-1.0, 1.0, n) * 2.0 ** -12)
    u = u + tilt[:, None] * e
    o = touch - rng.uniform(2.0, 6.0, n)[:, None] * r[:, None] * u
    return o.astype(np.float32), u.astype(np.float32)


def xform_edge_rays(scene, n: int, seed: int = 0) -> dict:
    """Rays at the rect / TRS rows of ``scene`` (a Scene) where K8's chunk
    cull is tightest, name -> (origins, directions) float32[n, 3], each
    aimed through a point w of a row's world object M^T (q + p) (M its
    rotation, p its position; q a point of its object space) along a unit
    u, the direction u * s (so that ScaleRay's normalize(d / s) is u):
      * ``rect_edges``: w on a rect's edge, x or y at +-0.5 (inclusive);
      * ``tsph_tangent``: w on a TRS sphere, u tangent to it there;
      * ``ttri_vertices``: w a TRS triangle's vertex, where the planes of
        the triangles' boxes pass;
      * ``axis_parallel``: w any of those points, u a signed axis, so the
        direction has two zero components (the slab's infinities, and NaN
        where an origin lies on a box plane).
    The origins lie 1 to 4 units before w."""
    import torch
    from ..core import vec as v3
    rng = np.random.default_rng(seed)
    pts, scl = [], []

    def rows(trs):
        R = v3.rotation_matrix_euler_deg(trs.rotation.detach().cpu()).numpy()
        return (R.astype(np.float64),
                trs.position.detach().cpu().numpy().astype(np.float64),
                trs.scale.detach().cpu().numpy().astype(np.float64))

    def world(R, p, q):          # M^T (q + p), as row vectors
        return np.einsum("kij,ki->kj", R, q + p)

    def unit(x):
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    out = {}
    if scene.n_rects:
        R, p, s = rows(scene.rects.trs)
        k = rng.integers(0, len(R), n)
        q = rng.uniform(-0.5, 0.5, (n, 3))
        q[:, 2] = 0.0
        ax = rng.integers(0, 2, n)
        q[np.arange(n), ax] = rng.choice([-0.5, 0.5], n)
        w = world(R[k], p[k], q)
        pts.append(w)
        scl.append(s[k])
        out["rect_edges"] = (w, unit(rng.normal(size=(n, 3))), s[k])
    if scene.n_t_spheres:
        R, p, s = rows(scene.t_spheres.trs)
        rad = np.abs(scene.t_spheres.radius.detach().cpu().numpy())
        k = rng.integers(0, len(R), n)
        nrm = unit(rng.normal(size=(n, 3)))
        w = world(R[k], p[k], np.zeros((n, 3))) + rad[k, None] * nrm
        u = rng.normal(size=(n, 3))
        u = unit(u - (u * nrm).sum(1, keepdims=True) * nrm)
        pts.append(w)
        scl.append(s[k])
        out["tsph_tangent"] = (w, u, s[k])
    if scene.n_t_triangles:
        tt = scene.t_triangles
        R, p, s = rows(tt.trs)
        v = np.stack([x.detach().cpu().numpy() for x in (tt.v0, tt.v1,
                                                         tt.v2)], 1)
        k = rng.integers(0, len(R), n)
        w = world(R[k], p[k], v[k, rng.integers(0, 3, n)])
        pts.append(w)
        scl.append(s[k])
        out["ttri_vertices"] = (w, unit(rng.normal(size=(n, 3))), s[k])
    if pts:
        every, sc = np.concatenate(pts), np.concatenate(scl)
        k = rng.integers(0, len(every), n)
        u = np.zeros((n, 3))
        u[np.arange(n), rng.integers(0, 3, n)] = rng.choice([-1.0, 1.0], n)
        out["axis_parallel"] = (every[k], u, sc[k])
    rays = {}
    for name, (w, u, s) in out.items():
        o = w - rng.uniform(1.0, 4.0, (n, 1)) * u
        rays[name] = (o.astype(np.float32), (u * s).astype(np.float32))
    return rays


def trs_duplicates_scene(k: int, aspect: float, device=None):
    """(Scene, Camera): ``fill_trs_field`` with two copies of every row,
    through ``trs_field_scene``'s camera."""
    cam = make_camera((0, 0.3, 1), (0, 0.3, -3), vfov=60, aspect=aspect,
                      focus_dist=4.0, device=device)
    return fill_trs_field(SceneBuilder(), k, copies=2).build(device), cam


def duplicate_orders(k: int) -> dict:
    """K8 row orders for a TRS field of 2k rows a class whose rows k to 2k
    - 1 copy rows 0 to k - 1 (``fill_trs_field(..., copies=2)``): the
    copies (rows k to 2k - 1) first, then the originals, so that a tie is
    met first at a higher row and in another chunk."""
    order = np.concatenate([np.arange(k, 2 * k), np.arange(k)])
    return {c: order.astype(np.int32) for c in ("rect", "tsph", "ttri")}


def fill_sphere_field(b, nx: int = 96, nz: int = 96):
    """nx x nz spheres of radius 0.11 on a gentle height field, lambertian,
    metal and checker in turn."""
    xs = np.linspace(-12, 12, nx)
    zs = np.linspace(-24, -2, nz)
    X, Z = np.meshgrid(xs, zs)
    Y = 0.25 * np.sin(X * 0.9) * np.cos(Z * 0.7)
    centers = np.stack([X.ravel(), Y.ravel(), Z.ravel()], 1).astype(
        np.float32)
    m = b.materials
    mats = [m.lambertian(color=(0.7, 0.3, 0.3)),
            m.metal((0.9, 0.9, 0.9), 0.05),
            m.lambertian(m.textures.checker((0.9, 0.9, 0.9),
                                            (0.1, 0.1, 0.1)))]
    for i, c in enumerate(centers):
        b.add_sphere(c, 0.11, mats[i % 3])
    return b


def sphere_field_rays(n: int, seed: int = 3):
    """(origins, directions) float32[n, 3] from (0, 3, 2) down onto the
    sphere field."""
    rng = np.random.default_rng(seed)
    o = np.tile(np.array([[0, 3.0, 2.0]], np.float32), (n, 1))
    d = np.stack([rng.uniform(-0.8, 0.8, n), -np.ones(n),
                  rng.uniform(-2.0, -0.5, n)], 1).astype(np.float32)
    return o, d


def _rotation_about(axis: int, degrees, pivot) -> np.ndarray:
    """float64[F, 4, 4] rotations by ``degrees`` float[F] about the x, y or
    z axis through ``pivot`` (column convention, p' = M [p; 1])."""
    a = np.radians(np.asarray(degrees, np.float64))
    c, s = np.cos(a), np.sin(a)
    i, j = [(1, 2), (2, 0), (0, 1)][axis]
    m = np.tile(np.eye(4), (a.shape[0], 1, 1))
    m[:, i, i], m[:, j, j], m[:, i, j], m[:, j, i] = c, c, -s, s
    p = np.asarray(pivot, np.float64)
    m[:, :3, 3] = p - np.einsum("fij,j->fi", m[:, :3, :3], p)
    return m


def _skinned(points, faces, normals, weights, mats, joints,
             degrees) -> SkinnedMesh:
    """A loader-shaped record of two bones about z: bind pose, weights
    float[P, 2], the per-frame vertex transforms float[F, 2, 4, 4], each
    bone at its joint with its z rotation float[F, 2] in degrees."""
    f = mats.shape[0]
    joints = np.asarray(joints, np.float32)
    rot = np.zeros((f, 2, 3), np.float32)
    rot[:, :, 2] = degrees
    return SkinnedMesh(
        points=np.asarray(points, np.float32),
        faces=np.asarray(faces, np.int32),
        normals=np.asarray(normals, np.float32), bone_names=["lower", "upper"],
        weights=np.asarray(weights, np.float32), bone_default_t=joints,
        bone_default_r=np.zeros((2, 3), np.float32), frame_count=f,
        vertex_transforms=mats.astype(np.float32),
        bone_now_t=np.tile(joints, (f, 1, 1)), bone_now_r=rot)


def skinned_capsule(frames: int = ANIM_FRAMES) -> SkinnedMesh:
    """The 5,120-triangle icosphere stretched into a capsule 660 units tall
    and 360 wide, standing at the origin of fbx_walk_camera's view (about a
    fifth of the frame), on two bones: the lower holds still, the upper
    bends about z through the waist (y = 150) from 0 to 60 degrees over the
    frames.  A vertex's weight passes from the lower to the upper bone over
    the middle fifth of the height."""
    from ..utils.obj_loader import face_normals
    pts, faces = icosphere(4)
    pts = (pts * np.array([180.0, 330.0, 180.0], np.float32)
           + np.array([0.0, 150.0, 0.0], np.float32))
    s = (pts[:, 1] - pts[:, 1].min()) / np.ptp(pts[:, 1])
    up = np.clip((s - 0.4) / 0.2, 0.0, 1.0)
    bend = np.linspace(0.0, 60.0, frames)
    mats = np.stack([np.tile(np.eye(4), (frames, 1, 1)),
                     _rotation_about(2, bend, (0.0, 150.0, 0.0))], 1)
    return _skinned(pts, faces, face_normals(pts, faces),
                    np.stack([1.0 - up, up], 1), mats,
                    [(0.0, -180.0, 0.0), (0.0, 150.0, 0.0)],
                    np.stack([np.zeros(frames), bend], 1))


def skinned_field(frames: int = ANIM_FRAMES) -> SkinnedMesh:
    """big_field's 5 x 5 icospheres (128,000 triangles) as one mesh: the
    two columns left of x = 0 on one bone, the other three on the other,
    each half swaying about z through a pivot under its middle (y = -1),
    +-8 degrees in opposite phase, one period over the frames.  Render
    under ``field_camera``."""
    pts, faces, nrm, _ = icosphere_field_mesh(5, 5)
    per_copy = len(pts) // 25
    left = np.repeat(np.arange(25) // 5 < 2, per_copy)
    sway = 8.0 * np.sin(np.linspace(0.0, 2.0 * np.pi, frames))
    joints = [(-3.45, -1.0, -5.2), (2.3, -1.0, -5.2)]
    mats = np.stack([_rotation_about(2, sway, joints[0]),
                     _rotation_about(2, -sway, joints[1])], 1)
    return _skinned(pts, faces, nrm, np.stack([left, ~left], 1), mats,
                    joints, np.stack([sway, -sway], 1))


def write_ascii_fbx(path: str, points, faces, frames: int = 3) -> None:
    """Write a mesh's bind pose as an ASCII FBX 7.4 file (one Geometry and
    its Model, no skin, a take of ``frames`` frames at 60 fps), the way
    tests/test_fbx.py:175-216 writes one: ``utils.fbx_loader`` reads back
    the same points and faces, normals from the winding and ``frames``
    frames of the bind pose."""
    from ..utils.fbx_parser import KTIME_PER_SECOND
    pts = np.asarray(points, np.float32).reshape(-1)
    f = np.asarray(faces, np.int64).copy()
    f[:, 2] = ~f[:, 2]                    # a polygon's last index, negated
    stop = frames * (KTIME_PER_SECOND // 60)
    with open(path, "w") as out:
        out.write("; FBX 7.4.0 project file\n"
                  "FBXHeaderExtension:  {\n    FBXHeaderVersion: 1003\n"
                  "    FBXVersion: 7400\n}\nObjects:  {\n"
                  '    Geometry: 1000, "Geometry::mesh", "Mesh" {\n'
                  f"        Vertices: *{pts.size} {{\n            a: "
                  + ",".join(repr(float(v)) for v in pts) + "\n        }\n"
                  f"        PolygonVertexIndex: *{f.size} {{\n            a: "
                  + ",".join(str(int(v)) for v in f.reshape(-1))
                  + "\n        }\n    }\n"
                  '    Model: 2000, "Model::mesh", "Mesh" {\n'
                  "        Version: 232\n    }\n}\n"
                  'Connections:  {\n    C: "OO",1000,2000\n'
                  '    C: "OO",2000,0\n}\n'
                  f'Takes:  {{\n    Take: "bind" {{\n'
                  f"        LocalTime: 0,{stop}\n    }}\n}}\n")
