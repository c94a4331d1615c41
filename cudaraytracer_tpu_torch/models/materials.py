"""Material table (replaces the virtual Material hierarchy of
CudaTest/src/material/material.h).

The four kinds and their rules (the fused kernel and its plain version in
``ops/megakernel.py`` evaluate them):
  LAMBERTIAN (material.h:55-72): dir = n + unit_ball; attenuation = the
      texture at the hit point (u = v = 0 under the reference quirk).
  METAL (material.h:75-96): dir = reflect(unit(d), n) + fuzz * unit_ball;
      attenuation = albedo; scatters iff dot(dir, n) > 0.  fuzz <= 1.
  DIELECTRIC (material.h:99-143): attenuation 1; Schlick choice between
      reflection and refraction.
  DIFFUSE_LIGHT (material.h:146-161): never scatters; emits its texture.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core import rng as _rng
from ..core.device import resolve_device
from .textures import TextureBuilder

Tensor = torch.Tensor

LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2
DIFFUSE_LIGHT = 3


class MaterialTable(NamedTuple):
    kind: Tensor     # int32[M]
    tex_id: Tensor   # int32[M] albedo (lambertian) / emit (light) texture
    albedo: Tensor   # float32[M, 3] metal albedo
    fuzz: Tensor     # float32[M]
    ref_idx: Tensor  # float32[M]


def scatter_draws(n: int, generator: torch.Generator,
                  device=None):
    """One scatter step's draws: a unit-ball sample float32[n, 3] and a
    uniform float32[n] per ray (materials.py:188 of the JAX package), drawn
    on the generator."""
    return _rng.unit_ball(n, generator, device)


class MaterialBuilder:
    """Host-side accumulation mirroring the reference constructors."""

    def __init__(self, textures: Optional[TextureBuilder] = None):
        self.textures = textures if textures is not None else TextureBuilder()
        self._kind = []
        self._tex = []
        self._albedo = []
        self._fuzz = []
        self._ref_idx = []

    def _add(self, kind, tex=0, albedo=(0, 0, 0), fuzz=0.0,
             ref_idx=1.0) -> int:
        self._kind.append(kind)
        self._tex.append(tex)
        self._albedo.append(np.asarray(albedo, np.float32))
        self._fuzz.append(float(fuzz))
        self._ref_idx.append(float(ref_idx))
        return len(self._kind) - 1

    def lambertian(self, tex_id: Optional[int] = None, color=None) -> int:
        if tex_id is None:
            tex_id = self.textures.constant(
                color if color is not None else (0.5, 0.5, 0.5))
        return self._add(LAMBERTIAN, tex=tex_id)

    def metal(self, albedo, fuzz: float = 0.0) -> int:
        return self._add(METAL, albedo=albedo, fuzz=min(float(fuzz), 1.0))

    def dielectric(self, ref_idx: float) -> int:
        return self._add(DIELECTRIC, ref_idx=ref_idx)

    def diffuse_light(self, tex_id: Optional[int] = None, color=None) -> int:
        if tex_id is None:
            tex_id = self.textures.constant(
                color if color is not None else (1.0, 1.0, 1.0))
        return self._add(DIFFUSE_LIGHT, tex=tex_id)

    def build(self, device=None) -> MaterialTable:
        device = resolve_device(device)
        m = max(len(self._kind), 1)
        kind = np.zeros(m, np.int32)
        tex = np.zeros(m, np.int32)
        albedo = np.zeros((m, 3), np.float32)
        fuzz = np.zeros(m, np.float32)
        ref_idx = np.ones(m, np.float32)
        if self._kind:
            kind[:] = self._kind
            tex[:] = self._tex
            albedo[:] = np.stack(self._albedo)
            fuzz[:] = self._fuzz
            ref_idx[:] = self._ref_idx
        return MaterialTable(*(torch.from_numpy(a).to(device)
                               for a in (kind, tex, albedo, fuzz, ref_idx)))
