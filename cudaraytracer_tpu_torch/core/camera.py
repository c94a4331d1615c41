"""Thin-lens camera (CudaTest/src/core/camera.h).

Basis construction from lookfrom/lookat/vup/vfov/aspect/aperture/focus_dist
(camera.h:18-38) and ``get_ray(s, t)`` with defocus-disk sampling
(camera.h:40-44).  Directions are NOT normalized, as in the reference
(LambertShade's dot at render.h:80 depends on that).

The random draws (pixel jitter, lens disk, shutter time) are optional
tensors, so a test can feed the numbers another renderer drew; left out,
they are drawn on the given ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from . import rng as _rng
from .device import resolve_device
from .rays import Rays

Tensor = torch.Tensor


class Camera(NamedTuple):
    origin: Tensor             # lookfrom
    lower_left_corner: Tensor
    horizontal: Tensor
    vertical: Tensor
    x: Tensor                  # camera basis (camera.h:29-31)
    y: Tensor
    z: Tensor
    lens_radius: Tensor        # aperture / 2
    time0: Tensor              # MotionCamera shutter (camera.h:56-89)
    time1: Tensor


def make_camera(lookfrom, lookat, vup=(0.0, 1.0, 0.0), vfov: float = 40.0,
                aspect: float = 2.0, aperture: float = 0.0,
                focus_dist: float = 10.0, time0: float = 0.0,
                time1: float = 0.0, device=None) -> Camera:
    """camera.h:18-38."""
    device = resolve_device(device)

    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32, device=device)

    lookfrom, lookat, vup = f32(lookfrom), f32(lookat), f32(vup)
    theta = vfov * math.pi / 180.0
    half_height = math.tan(theta / 2.0)
    half_width = half_height * aspect
    z = (lookfrom - lookat) / torch.linalg.norm(lookfrom - lookat)
    x = torch.linalg.cross(vup, z)
    x = x / torch.linalg.norm(x)
    y = torch.linalg.cross(z, x)
    lower_left = (lookfrom - half_width * focus_dist * x
                  - half_height * focus_dist * y - focus_dist * z)
    horizontal = 2.0 * half_width * focus_dist * x
    vertical = 2.0 * half_height * focus_dist * y
    return Camera(lookfrom, lower_left, horizontal, vertical, x, y, z,
                  f32(aperture / 2.0), f32(time0), f32(time1))


def get_rays(camera: Camera, s: Tensor, t: Tensor,
             disk: Optional[Tensor] = None, time_u: Optional[Tensor] = None,
             generator: Optional[torch.Generator] = None) -> Rays:
    """camera.h:40-44 get_ray for batched (s, t) in [0, 1].

    disk: float32[n, 3] unit-disk points; time_u: float32[n] shutter
    uniforms.  The disk is drawn even at aperture 0, as in the JAX camera."""
    n = s.shape[0]
    if disk is None:
        disk = _rng.unit_disk(n, generator, s.device)
    if time_u is None:
        time_u = _rng.uniform((n,), generator, s.device)
    rd = camera.lens_radius * disk
    offset = camera.x * rd[:, 0:1] + camera.y * rd[:, 1:2]
    origin = camera.origin + offset
    direction = (camera.lower_left_corner + s[:, None] * camera.horizontal
                 + t[:, None] * camera.vertical - camera.origin - offset)
    time = camera.time0 + time_u * (camera.time1 - camera.time0)
    return Rays(origin, direction, time)


def generate_pixel_rays(camera: Camera, width: int, height: int,
                        samples: int, pixel_index: Optional[Tensor] = None,
                        jitter: Optional[Tensor] = None,
                        disk: Optional[Tensor] = None,
                        time_u: Optional[Tensor] = None,
                        generator: Optional[torch.Generator] = None) -> Rays:
    """Rays for ``samples`` jittered samples of each requested pixel
    (render.h:115-117): u = (px + U) / nx, v = (py + U) / ny, pixel (px, py)
    counted from the bottom-left.  Flat batch of n_pixels * samples rays,
    the samples of one pixel adjacent (camera.py:102-112 of the JAX
    package).

    jitter: optional float32[n, 2] (u, v) jitter uniforms."""
    device = camera.origin.device
    if pixel_index is None:
        pixel_index = torch.arange(width * height, dtype=torch.int64,
                                   device=device)
    pixel_index = pixel_index.to(torch.int64)
    px = torch.repeat_interleave((pixel_index % width).to(torch.float32),
                                 samples)
    py = torch.repeat_interleave((pixel_index // width).to(torch.float32),
                                 samples)
    n = px.shape[0]
    if jitter is None:
        jitter = _rng.uniform((n, 2), generator, device)
    u = (px + jitter[:, 0]) / float(width)
    v = (py + jitter[:, 1]) / float(height)
    return get_rays(camera, u, v, disk, time_u, generator)
