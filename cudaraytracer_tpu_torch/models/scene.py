"""SoA scene representation + host-side SceneBuilder.

The reference's scene graph is a device-heap web of polymorphic
``Hitable*`` (hitable.h, hitable_list.h) built by ``<<<1,1>>>`` kernels
(createScene.h).  Here, as in the JAX package, the scene is a set of flat
tensors:

  spheres    : center float32[S, 3], radius float32[S], mat int32[S]
  triangles  : v0/v1/v2 float32[T, 3], normal float32[T, 3], mat int32[T]
  rectangles : TRS + flip + mat (rectangle.h)
  t_spheres / t_triangles : prims with a runtime TRS

plus the material and texture tables.  Rects and runtime-TRS prims are
built here; the fused engine raises on them until slice 5.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from .materials import MaterialBuilder, MaterialTable
from .textures import TextureTable
from .transform import TRS, bake_points

Tensor = torch.Tensor


class Spheres(NamedTuple):
    center: Tensor  # float32[S, 3]
    radius: Tensor  # float32[S]
    mat: Tensor     # int32[S]


class Triangles(NamedTuple):
    v0: Tensor      # float32[T, 3]
    v1: Tensor
    v2: Tensor
    normal: Tensor  # float32[T, 3] stored face normal (triangle.h:21-29)
    mat: Tensor     # int32[T]


class Rectangles(NamedTuple):
    trs: TRS
    flip: Tensor    # bool[R] flipNormal (rectangle.h:23)
    mat: Tensor     # int32[R]


class TSpheres(NamedTuple):
    """Spheres with a runtime TRS (sphere.h through TransformRay)."""
    trs: TRS
    radius: Tensor
    mat: Tensor


class TTriangles(NamedTuple):
    """Triangles with a runtime TRS (object-space vertices)."""
    trs: TRS
    v0: Tensor
    v1: Tensor
    v2: Tensor
    normal: Tensor
    mat: Tensor


class Scene(NamedTuple):
    spheres: Spheres
    triangles: Triangles
    rects: Rectangles
    materials: MaterialTable
    textures: TextureTable
    t_spheres: TSpheres
    t_triangles: TTriangles

    @property
    def device(self) -> torch.device:
        return self.materials.kind.device

    @property
    def n_spheres(self) -> int:
        return self.spheres.radius.shape[0]

    @property
    def n_triangles(self) -> int:
        return self.triangles.v0.shape[0]

    @property
    def n_rects(self) -> int:
        return self.rects.flip.shape[0]

    @property
    def n_t_spheres(self) -> int:
        return self.t_spheres.radius.shape[0]

    @property
    def n_t_triangles(self) -> int:
        return self.t_triangles.mat.shape[0]

    def with_triangle_vertices(self, v0: Tensor, v1: Tensor, v2: Tensor,
                               normal: Optional[Tensor] = None) -> "Scene":
        """New vertices for the mesh (update_pose, createScene.h:99-109).
        Face normals stay as stored unless given (the reference quirk,
        Quirks.fixed_face_normals)."""
        tri = self.triangles
        normal = tri.normal if normal is None else normal
        return self._replace(triangles=Triangles(v0, v1, v2, normal, tri.mat))


def _f32(rows, shape):
    return np.stack(rows).astype(np.float32) if rows else np.zeros(
        shape, np.float32)


class SceneBuilder:
    """Host-side scene assembly; the analog of createScene.h."""

    def __init__(self, materials: Optional[MaterialBuilder] = None):
        self.materials = materials if materials is not None \
            else MaterialBuilder()
        self._sph_center: list = []
        self._sph_radius: list = []
        self._sph_mat: list = []
        self._tri_v: list = []       # (3, 3) world-space vertices
        self._tri_n: list = []
        self._tri_mat: list = []
        self._rect_trs: list = []
        self._rect_flip: list = []
        self._rect_mat: list = []
        self._tsph: list = []        # (trs, radius, mat)
        self._ttri: list = []        # (trs, (3, 3) verts, normal, mat)

    @staticmethod
    def _is_identity_rs(rotation, scale) -> bool:
        return (np.allclose(np.asarray(rotation, np.float32), 0.0)
                and np.allclose(np.asarray(scale, np.float32), 1.0))

    def add_sphere(self, center, radius: float, mat_id: int,
                   rotation=(0, 0, 0), scale=(1, 1, 1)) -> int:
        """sphere.h: translations bake into the sphere table; a non-identity
        rotation or scale makes a runtime-TRS sphere (negative handle)."""
        if not self._is_identity_rs(rotation, scale):
            trs = (np.asarray(center, np.float32),
                   np.asarray(rotation, np.float32),
                   np.asarray(scale, np.float32))
            self._tsph.append((trs, float(radius), int(mat_id)))
            return -len(self._tsph)
        self._sph_center.append(np.asarray(center, np.float32))
        self._sph_radius.append(float(radius))
        self._sph_mat.append(int(mat_id))
        return len(self._sph_radius) - 1

    def add_triangle(self, v0, v1, v2, mat_id: int, normal=None,
                     position=(0, 0, 0), rotation=(0, 0, 0),
                     scale=(1, 1, 1)) -> int:
        """Triangle ctor (triangle.h:14-17): normal from the edges unless
        given.  A non-identity transform makes a runtime-TRS triangle."""
        v0 = np.asarray(v0, np.float32)
        v1 = np.asarray(v1, np.float32)
        v2 = np.asarray(v2, np.float32)
        if normal is None:
            n = np.cross(v1 - v0, v2 - v0)
            normal = n / max(np.linalg.norm(n), 1e-20)
        if not (self._is_identity_rs(rotation, scale)
                and np.allclose(np.asarray(position, np.float32), 0.0)):
            trs = (np.asarray(position, np.float32),
                   np.asarray(rotation, np.float32),
                   np.asarray(scale, np.float32))
            self._ttri.append((trs, np.stack([v0, v1, v2]),
                               np.asarray(normal, np.float32), int(mat_id)))
            return -len(self._ttri)
        self._tri_v.append(np.stack([v0, v1, v2]))
        self._tri_n.append(np.asarray(normal, np.float32))
        self._tri_mat.append(int(mat_id))
        return len(self._tri_mat) - 1

    def add_mesh(self, points: np.ndarray, idx: np.ndarray, mat_id: int,
                 normals: Optional[np.ndarray] = None,
                 reverse_winding: bool = True,
                 position=(0, 0, 0), rotation=(0, 0, 0),
                 scale=(1, 1, 1)) -> None:
        """add_mesh_withNormal (createScene.h:175-190): triangles from
        points[idx[2]], points[idx[1]], points[idx[0]] (reversed order,
        createScene.h:185) with the given per-face normals.  The transform
        is baked here."""
        pts = bake_points(position, rotation, scale, points)
        idx = np.asarray(idx, np.int64)
        order = idx[:, ::-1] if reverse_winding else idx
        tri = pts[order]  # (T, 3, 3)
        if normals is None:
            n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
            normals = n / np.maximum(
                np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
        for k in range(tri.shape[0]):
            self._tri_v.append(tri[k])
            self._tri_n.append(np.asarray(normals[k], np.float32))
            self._tri_mat.append(int(mat_id))

    def add_rect(self, mat_id: int, flip: bool = False,
                 position=(0, 0, 0), rotation=(0, 0, 0),
                 scale=(1, 1, 1)) -> int:
        self._rect_trs.append((np.asarray(position, np.float32),
                               np.asarray(rotation, np.float32),
                               np.asarray(scale, np.float32)))
        self._rect_flip.append(bool(flip))
        self._rect_mat.append(int(mat_id))
        return len(self._rect_mat) - 1

    def build(self, device=None) -> Scene:
        device = resolve_device(device)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        def trs_of(entries):
            if entries:
                p, r, s = (np.stack([e[k] for e in entries])
                           for k in range(3))
            else:
                p = r = np.zeros((0, 3), np.float32)
                s = np.ones((0, 3), np.float32)
            return TRS(t(p), t(r), t(s))

        sph = Spheres(t(_f32(self._sph_center, (0, 3))),
                      t(np.asarray(self._sph_radius, np.float32)),
                      t(np.asarray(self._sph_mat, np.int32)))
        tv = _f32(self._tri_v, (0, 3, 3))
        tri = Triangles(t(tv[:, 0]), t(tv[:, 1]), t(tv[:, 2]),
                        t(_f32(self._tri_n, (0, 3))),
                        t(np.asarray(self._tri_mat, np.int32)))
        rects = Rectangles(trs_of(self._rect_trs),
                           t(np.asarray(self._rect_flip, bool)),
                           t(np.asarray(self._rect_mat, np.int32)))
        tsph = TSpheres(trs_of([e[0] for e in self._tsph]),
                        t(np.asarray([e[1] for e in self._tsph], np.float32)),
                        t(np.asarray([e[2] for e in self._tsph], np.int32)))
        ttv = _f32([e[1] for e in self._ttri], (0, 3, 3))
        ttri = TTriangles(trs_of([e[0] for e in self._ttri]),
                          t(ttv[:, 0]), t(ttv[:, 1]), t(ttv[:, 2]),
                          t(_f32([e[2] for e in self._ttri], (0, 3))),
                          t(np.asarray([e[3] for e in self._ttri], np.int32)))
        return Scene(sph, tri, rects, self.materials.build(device),
                     self.materials.textures.build(device), tsph, ttri)
