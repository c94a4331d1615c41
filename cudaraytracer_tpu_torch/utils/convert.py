"""Carry scene, camera and fit state across from the JAX package.

The JAX package's parameters, given as numpy arrays (for example
``jax.tree.map(np.asarray, jax_scene)``), become the port's tensors, so that
both packages compute on the same numbers.  Only field names are read: any
nested object with the JAX ``Scene`` / ``Camera`` field names will do.
Fit parameters (a dict of arrays, ``parallel/train.py``) go across with
``params_from_numpy`` and back with ``params_to_numpy``; a JAX
``SkinnedMesh`` (the FBX loader's numpy arrays) with
``skinned_mesh_from_numpy``; a JAX ``FlatBVH`` with
``flat_bvh_from_numpy``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.camera import Camera
from ..core.device import resolve_device
from ..models.materials import MaterialTable
from ..models.scene import (Rectangles, Scene, Spheres, Triangles, TSpheres,
                            TTriangles)
from ..models.textures import TextureTable
from ..models.transform import TRS
from ..ops.bvh import FlatBVH, flat_bvh
from .fbx_loader import SkinnedMesh

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
    if isinstance(record, tuple):
        return type(record)(*(to_numpy(v) for v in record))
    return record


def params_from_numpy(params, device=None) -> dict:
    """A dict of numpy arrays (tuples of them allowed, as 'tri_v') -> the
    same dict of float32 leaf tensors that require grad, on ``device``."""
    device = resolve_device(device)

    def leaf(a):
        return torch.tensor(np.asarray(a, np.float32), device=device,
                            requires_grad=True)

    return {k: tuple(leaf(x) for x in v) if isinstance(v, tuple) else leaf(v)
            for k, v in params.items()}


def params_to_numpy(params) -> dict:
    """The inverse of params_from_numpy: a dict of numpy arrays."""
    return {k: tuple(to_numpy(x) for x in v) if isinstance(v, tuple)
            else to_numpy(v) for k, v in params.items()}


def skinned_mesh_from_numpy(mesh) -> SkinnedMesh:
    """A JAX ``SkinnedMesh`` (or any object with its field names) -> the
    port's ``SkinnedMesh``, its arrays copied as numpy arrays of the same
    dtypes; ``models.mesh.device_mesh`` takes it to the card."""
    def copy(v):
        return np.array(v) if isinstance(v, np.ndarray) else (
            list(v) if isinstance(v, list) else v)

    return SkinnedMesh(**{f.name: copy(getattr(mesh, f.name))
                          for f in dataclasses.fields(SkinnedMesh)})


def flat_bvh_from_numpy(tree, device=None) -> FlatBVH:
    """A JAX ``FlatBVH`` of numpy arrays (its ``levels`` a tuple of them)
    -> the port's ``FlatBVH`` on ``device``, the same nodes and ids."""
    return flat_bvh(*(np.asarray(getattr(tree, k)) for k in (
        "bbox_min", "bbox_max", "is_leaf", "skip", "prim0", "prim1")),
        [np.asarray(ids) for ids in tree.levels], np.asarray(tree.child_l),
        np.asarray(tree.child_r), resolve_device(device))
