"""OBJ mesh loader (the port's own copy; parity with
CudaTest/src/Loader/obj_loader.h).

Parses ``v`` and ``f`` lines (``vn`` is skipped, like the reference), plain
``f 1 2 3`` and ``f v//vn`` faces, fan-triangulates n-gons, converts to
0-based indices, then CENTERS the mesh on its vertex mean
(obj_loader.h:93-95).  The max-distance scaling (:139-146) is off by
default, as in the reference.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def load_obj(path: str, center: bool = True, scale_to_unit: bool = False
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Parse an OBJ file -> (points float32[P, 3], faces int32[T, 3])."""
    points = []
    faces = []
    with open(path, "r") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                points.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                # "3", "3/1", "3//7", "3/1/7"; negative indices are relative
                # to the vertices seen so far (-1 = most recent)
                raw = [int(tok.split("/")[0]) for tok in parts[1:]]
                idx = [i - 1 if i > 0 else len(points) + i for i in raw]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    pts = np.asarray(points, np.float32)
    fcs = np.asarray(faces, np.int32).reshape(-1, 3)
    if center and len(pts):
        pts = pts - pts.mean(axis=0, keepdims=True)   # obj_loader.h:93-95
    if scale_to_unit and len(pts):
        d = np.linalg.norm(pts, axis=-1).max()         # obj_loader.h:139-146
        if d > 0:
            pts = pts / d
    return pts, fcs


def face_normals(points: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Per-face normals from winding (Triangle ctor, triangle.h:14-17)."""
    tri = points[faces]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    return (n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
            ).astype(np.float32)
