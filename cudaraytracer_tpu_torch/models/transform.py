"""TRS transforms (CudaTest/src/hitable/transform.h): the ``TRS`` record,
the host-side baking that ``SceneBuilder`` uses, and the reference's ray
transform that rects and runtime-TRS prims are tested through.

``TransformRay = Translate(Rotate(Scale(ray)))`` (transform.h:11-14):

  ScaleRay     (transform.h:50-54): dir' = unit(dir / scale).  The origin
               is NOT scaled (a reference quirk, kept).  Its time' = time *
               |dir / scale| reaches no hit test and is not computed.
  RotateRay    (transform.h:45-49): origin and direction times the Euler
               rotation of vec3.h:200-217 as a row-major matrix (negated-Z
               quirk kept), rotating about the world origin.
  TranslateRay (transform.h:40-43): origin' = origin - position.

The fused kernel K8 and its plain version evaluate the same chain with the
same operations in the same order (``transform_arrays``), so the two round
alike.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import vec as v3

Tensor = torch.Tensor


class TRS(NamedTuple):
    position: Tensor  # float32[..., 3]
    rotation: Tensor  # float32[..., 3] Euler degrees
    scale: Tensor     # float32[..., 3]


def rotate_rows(m, x, y, z):
    """(m[0] x + m[1] y + m[2] z, m[3] x + ..., m[6] x + ...): a row-major
    3x3 matrix ``m`` (a sequence of 9 broadcastable components) times the
    vector (x, y, z), summed left to right as the kernel does."""
    return (m[0] * x + m[1] * y + m[2] * z,
            m[3] * x + m[4] * y + m[5] * z,
            m[6] * x + m[7] * y + m[8] * z)


def transform_arrays(o, d, position, scale, m):
    """TransformRay on components: o, d, position, scale are 3-sequences
    and m a 9-sequence of broadcastable tensors (one ray per row against
    one prim per column, or one gathered prim per ray) ->
    ((ox, oy, oz), (dx, dy, dz)) in object space, the direction of unit
    length."""
    dsx, dsy, dsz = d[0] / scale[0], d[1] / scale[1], d[2] / scale[2]
    inv_dl = 1.0 / torch.sqrt(dsx * dsx + dsy * dsy + dsz * dsz)
    dsx, dsy, dsz = dsx * inv_dl, dsy * inv_dl, dsz * inv_dl
    dr = rotate_rows(m, dsx, dsy, dsz)
    orx, ory, orz = rotate_rows(m, o[0], o[1], o[2])
    return ((orx - position[0], ory - position[1], orz - position[2]), dr)


def bake_points(t_position, t_rotation, t_scale,
                points: np.ndarray) -> np.ndarray:
    """Host-side forward TRS on points: scale, rotate^-1, translate.

    Standard TRS semantics (x = R^T (s * y) + pos), as a SceneBuilder
    user expects; the runtime-TRS prims instead follow the reference
    TransformRay chain above.  The two agree for rotation-only or
    translation-only transforms."""
    pts = np.asarray(points, np.float32) * np.asarray(t_scale, np.float32)
    R = v3.rotation_matrix_euler_deg(
        torch.as_tensor(np.asarray(t_rotation, np.float32))).numpy()
    pts = pts @ R  # x_world = R^T @ x_obj == x_obj @ R (row-vector form)
    return pts + np.asarray(t_position, np.float32)
