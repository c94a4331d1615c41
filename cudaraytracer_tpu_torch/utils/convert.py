"""Carry scene and camera state across from the JAX package.

The JAX package's parameters, given as numpy arrays (for example
``jax.tree.map(np.asarray, jax_scene)``), become the port's tensors, so that
both packages compute on the same numbers.  Only field names are read: any
nested object with the JAX ``Scene`` / ``Camera`` field names will do.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.camera import Camera
from ..core.device import resolve_device
from ..models.materials import MaterialTable
from ..models.scene import (Rectangles, Scene, Spheres, Triangles, TSpheres,
                            TTriangles)
from ..models.textures import TextureTable
from ..models.transform import TRS

# NamedTuple fields that hold another record
_NESTED = {
    Scene: {"spheres": Spheres, "triangles": Triangles, "rects": Rectangles,
            "materials": MaterialTable, "textures": TextureTable,
            "t_spheres": TSpheres, "t_triangles": TTriangles},
    Rectangles: {"trs": TRS},
    TSpheres: {"trs": TRS},
    TTriangles: {"trs": TRS},
}


def _record(cls, obj, device):
    nested = _NESTED.get(cls, {})
    fields = []
    for name in cls._fields:
        value = getattr(obj, name)
        if name in nested:
            fields.append(_record(nested[name], value, device))
        else:
            fields.append(torch.from_numpy(
                np.array(value, copy=True)).to(device))
    return cls(*fields)


def scene_from_numpy(tree, device=None) -> Scene:
    """A JAX ``Scene`` of numpy arrays -> the port's ``Scene``."""
    return _record(Scene, tree, resolve_device(device))


def camera_from_numpy(tree, device=None) -> Camera:
    """A JAX ``Camera`` of numpy arrays -> the port's ``Camera``."""
    return _record(Camera, tree, resolve_device(device))


def to_numpy(record):
    """The port's record (Scene, Camera, ...) -> the same record of numpy
    arrays."""
    if isinstance(record, torch.Tensor):
        return record.detach().cpu().numpy()
    return type(record)(*(to_numpy(v) for v in record))
