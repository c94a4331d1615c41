"""Skinned meshes: linear-blend skinning on the device and the per-frame
scene update (the port of the JAX package's ``models/mesh.py``).

The reference skins on the host, one FbxMatrix-vector multiply per vertex
per frame (calcPose, createScene.h:111-123), then copies the positions to
the device and rewrites the Triangle objects serially (update_pose,
createScene.h:99-109).  Here the per-frame bone matrices live on the device
as one (frames, bones, 4, 4) tensor; skinning one frame is

    M_points = weights @ bone_mats          (one matmul, (P, B) x (B, 16))
    p'       = homogeneous(p) . M_points    (MultNormalize, vectorized)

and the triangle-vertex rewrite is a gather, with no host round trip.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..utils.fbx_loader import SkinnedMesh
from .scene import Scene

Tensor = torch.Tensor


class SkinnedMeshArrays(NamedTuple):
    """The skinning data on the device (the FBXObject analog)."""

    points: Tensor             # float32[P, 3] bind-pose control points
    faces: Tensor              # int64[T, 3]
    normals: Tensor            # float32[T, 3] loaded per-face normals
    weights: Tensor            # float32[P, B]
    vertex_transforms: Tensor  # float32[F, B, 4, 4]
    bone_now_t: Tensor         # float32[F, B, 3]
    bone_default_t: Tensor     # float32[B, 3]

    @property
    def frame_count(self) -> int:
        return self.vertex_transforms.shape[0]


def device_mesh(mesh: SkinnedMesh, device=None) -> SkinnedMeshArrays:
    """The loader's numpy arrays as tensors on ``device`` (default: the
    card, ``core.device.resolve_device``)."""
    device = resolve_device(device)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return SkinnedMeshArrays(
        f32(mesh.points),
        torch.as_tensor(np.asarray(mesh.faces, np.int64), device=device),
        f32(mesh.normals), f32(mesh.weights), f32(mesh.vertex_transforms),
        f32(mesh.bone_now_t), f32(mesh.bone_default_t))


def skin_points(points: Tensor, weights: Tensor, bone_mats: Tensor) -> Tensor:
    """LBS: blend the per-bone matrices, then apply them with the
    w-divide.  Mirrors the reference's sum over bones of w times the
    vertexTransformMatrix (FbxLoader.h:166-172) and FbxMatrix::MultNormalize
    (createScene.h:115).  points float32[P, 3], weights float32[P, B],
    bone_mats float32[B, 4, 4] -> float32[P, 3]."""
    p = points.shape[0]
    b = bone_mats.shape[0]
    blended = (weights @ bone_mats.reshape(b, 16)).reshape(p, 4, 4)
    ph = torch.cat([points, points.new_ones(p, 1)], dim=-1)
    out = (blended * ph[:, None, :]).sum(-1)
    # the w-divide, guarded twice: a vertex no cluster claims blends to the
    # zero matrix, and 0 / 0 would NaN the mesh; it stays at bind pose
    w = out[:, 3:4]
    ok = w.abs() > 1e-12
    return torch.where(ok, out[:, :3] / torch.where(ok, w, 1.0), points)


def skin_frame(mesh: SkinnedMeshArrays, frame: int
               ) -> Tuple[Tensor, Tensor, Tensor]:
    """The skinned triangle vertices of one frame, gathered in update_pose's
    REVERSED face-index order {idx[2], idx[1], idx[0]}
    (createScene.h:104-106) -> (v0, v1, v2) float32[T, 3] each."""
    skinned = skin_points(mesh.points, mesh.weights,
                          mesh.vertex_transforms[frame])
    faces = mesh.faces
    return skinned[faces[:, 2]], skinned[faces[:, 1]], skinned[faces[:, 0]]


def recompute_face_normals(v0: Tensor, v1: Tensor, v2: Tensor,
                           align_to: Optional[Tensor] = None) -> Tensor:
    """Fresh normals from the current winding (the
    Quirks.fixed_face_normals=False path; the reference keeps the bind-pose
    normals, createScene.h:99-109).

    align_to: optional per-face normals (the loaded bind-pose ones) to
    sign-align against: the skinned gather reverses the winding, so the
    raw cross product is the negation of the FBX outward normal."""
    n = torch.linalg.cross(v1 - v0, v2 - v0)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True),
                        min=1e-20)
    if align_to is not None:
        s = torch.sign((n * align_to).sum(-1, keepdim=True))
        n = n * torch.where(s == 0.0, 1.0, s)
    return n


def scene_with_frame(scene: Scene, mesh: SkinnedMeshArrays, frame: int,
                     fixed_normals: bool = True) -> Scene:
    """The scene at one animation frame: its triangles replaced by the
    skinned ones (the loaded normals kept unless ``fixed_normals`` is
    False)."""
    v0, v1, v2 = skin_frame(mesh, frame)
    normal = None if fixed_normals else recompute_face_normals(
        v0, v1, v2, align_to=mesh.normals)
    return scene.with_triangle_vertices(v0, v1, v2, normal)
