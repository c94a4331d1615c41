"""Integrator dispatch.

The reference ships three integrators, chosen by (un)commenting
render.h:119-121: ``shade`` (the path tracer, render.h:48-67),
``LambertShade`` (render.h:70-87) and ``shade_normal`` (render.h:90-103).
In this slice all three run in the fused kernel (``engine='mega'``); the
wavefront forms (``trace_path``, ``lambert_shade``, ``shade_normal``) come
with slice 3.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import RenderConfig
from ..core import vec as v3
from ..core.rays import Rays
from ..models import materials as _mat
from ..models.scene import Scene
from . import megakernel as _mk

Tensor = torch.Tensor


class SampleStream(NamedTuple):
    """Injected per-(bounce, ray) scatter draws: every renderer that reads
    them consumes the same sample sequence (the cross-renderer parity
    mode)."""

    ball: Tensor   # float32[max_depth + 1, N, 3] unit-ball sample
    prob: Tensor   # float32[max_depth + 1, N] uniform


def stream_from_generator(generator: torch.Generator, n: int,
                          max_depth: int, device=None) -> SampleStream:
    """A SampleStream drawn on the generator, one scatter_draws per step."""
    draws = [_mat.scatter_draws(n, generator, device)
             for _ in range(max_depth + 1)]
    return SampleStream(torch.stack([b for b, _ in draws]),
                        torch.stack([p for _, p in draws]))


def background_sky(direction: Tensor) -> Tensor:
    """render.h:41-46 - vertical gradient white -> (0.5, 0.7, 1.0)."""
    unit = v3.unit_vector(direction)
    t = 0.5 * (unit[..., 1] + 1.0)
    top = torch.tensor([0.5, 0.7, 1.0], device=direction.device)
    return v3.lerp(t, torch.ones_like(direction), top.expand_as(direction))


def integrate(scene: Scene, rays: Rays, cfg: RenderConfig,
              tables: Optional[_mk.MegaTables] = None,
              samples: Optional[SampleStream] = None,
              generator: Optional[torch.Generator] = None,
              seed: Optional[int] = None) -> Tensor:
    """Radiance float32[N, 3] of the rays under cfg.integrator, through the
    fused kernel (the only engine of this slice)."""
    return _mk.trace_path_mega(scene, rays, cfg, tables=tables,
                               samples=samples, generator=generator,
                               seed=seed)
