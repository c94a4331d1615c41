"""TRS transforms (CudaTest/src/hitable/transform.h): the ``TRS`` record
and the host-side baking that ``SceneBuilder`` uses.  The runtime ray
transform of rects and TRS prims (kernel mode K8) comes with slice 5."""

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


def bake_points(t_position, t_rotation, t_scale,
                points: np.ndarray) -> np.ndarray:
    """Host-side forward TRS on points: scale, rotate^-1, translate.

    Standard TRS semantics (x = R^T (s * y) + pos), as a SceneBuilder
    user expects; the runtime-TRS prims instead follow the reference
    TransformRay chain (transform.h quirks).  The two agree for
    rotation-only or translation-only transforms."""
    pts = np.asarray(points, np.float32) * np.asarray(t_scale, np.float32)
    R = v3.rotation_matrix_euler_deg(
        torch.as_tensor(np.asarray(t_rotation, np.float32))).numpy()
    pts = pts @ R  # x_world = R^T @ x_obj == x_obj @ R (row-vector form)
    return pts + np.asarray(t_position, np.float32)
