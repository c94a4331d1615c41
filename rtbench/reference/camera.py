"""The thin-lens camera (camera.h) and the renderer's camera-ray draws,
replayed.

The renderer visits a frame's pixels in 32 x 16 screen blocks (or, for a
fit, row-major), in chunks of ``ray_chunk // spp`` pixels.  On the frame's
``torch.Generator`` it first draws one 62-bit seed per chunk (the path
integrator's in-kernel draws), then for each chunk in turn the pixel
jitter (n x 2 uniforms), the lens disk (n x 2) and the shutter time (n),
n = the chunk's rays.  ``replay_rays`` makes the same generator calls in
the same order and keeps the rays of the pixels asked for, with each ray's
chunk seed and its index inside the chunk (the key of its draws).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

Tensor = torch.Tensor


class Camera(NamedTuple):
    origin: Tensor
    lower_left_corner: Tensor
    horizontal: Tensor
    vertical: Tensor
    x: Tensor
    y: Tensor
    z: Tensor
    lens_radius: Tensor
    time0: Tensor
    time1: Tensor


def make_camera(p: dict, device) -> Camera:
    """camera.h:18-38 from the configuration's camera parameters."""

    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32, device=device)

    lookfrom, lookat, vup = f32(p["lookfrom"]), f32(p["lookat"]), f32(p["vup"])
    theta = p["vfov"] * math.pi / 180.0
    half_height = math.tan(theta / 2.0)
    half_width = half_height * p["aspect"]
    focus = p["focus_dist"]
    z = (lookfrom - lookat) / torch.linalg.norm(lookfrom - lookat)
    x = torch.linalg.cross(vup, z)
    x = x / torch.linalg.norm(x)
    y = torch.linalg.cross(z, x)
    lower_left = (lookfrom - half_width * focus * x
                  - half_height * focus * y - focus * z)
    return Camera(lookfrom, lower_left, 2.0 * half_width * focus * x,
                  2.0 * half_height * focus * y, x, y, z,
                  f32(p["aperture"] / 2.0), f32(0.0), f32(0.0))


def swizzled_pixels(width: int, height: int, device, block_w: int = 32,
                    block_h: int = 16) -> Tensor:
    """Flat pixel indices y * width + x in 16 x 32 screen blocks (blocks
    row-major, pixels row-major inside a block), int64[width * height]."""
    nby, nbx = -(-height // block_h), -(-width // block_w)
    by = torch.arange(nby, device=device).view(nby, 1, 1, 1)
    bx = torch.arange(nbx, device=device).view(1, nbx, 1, 1)
    yy = torch.arange(block_h, device=device).view(1, 1, block_h, 1)
    xx = torch.arange(block_w, device=device).view(1, 1, 1, block_w)
    y = (by * block_h + yy).expand(nby, nbx, block_h, block_w)
    x = (bx * block_w + xx).expand(nby, nbx, block_h, block_w)
    inside = (y < height) & (x < width)
    return (y * width + x)[inside]


class ReplayedRays(NamedTuple):
    origin: Tensor      # float32[n * spp, 3]
    direction: Tensor   # float32[n * spp, 3]
    seed: Tensor        # int64[n * spp] each ray's chunk seed (0: none)
    index: Tensor       # int64[n * spp] each ray's index inside its chunk
    pixel: Tensor       # int64[n] the picked pixels' flat indices


def replay_rays(cam: Camera, width: int, height: int, spp: int,
                ray_chunk: int, generator: torch.Generator,
                pixel_order: Tensor, picks: Tensor,
                chunk_seeds: bool) -> ReplayedRays:
    """The camera rays of the pixels at positions ``picks`` (sorted int64)
    of ``pixel_order`` (the order in which the renderer visits the pixels),
    drawn as the renderer draws them on ``generator``.  chunk_seeds: the
    renderer draws one seed per chunk first (the path integrator)."""
    device = cam.origin.device
    n_pix = pixel_order.shape[0]
    pix_chunk = max(1, min(ray_chunk // spp, n_pix))
    starts = list(range(0, n_pix, pix_chunk))
    seeds = [None] * len(starts)
    if chunk_seeds:
        seeds = torch.randint(0, 2 ** 62, (len(starts),), generator=generator,
                              device=generator.device).tolist()
    picks = picks.to(device)
    origins, directions, index, seed_of = [], [], [], []
    for lo, seed in zip(starts, seeds):
        hi = min(n_pix, lo + pix_chunk)
        n = (hi - lo) * spp
        jitter = torch.rand((n, 2), generator=generator, dtype=torch.float32,
                            device=device)
        disk_u = torch.rand((n, 2), generator=generator, dtype=torch.float32,
                            device=device)
        torch.rand((n,), generator=generator, dtype=torch.float32,
                   device=device)                  # the shutter time
        mine = picks[(picks >= lo) & (picks < hi)]
        if not mine.numel():
            continue
        ray = ((mine - lo)[:, None] * spp
               + torch.arange(spp, device=device)).reshape(-1)
        pix = pixel_order[mine].repeat_interleave(spp)
        px = (pix % width).to(torch.float32)
        py = (pix // width).to(torch.float32)
        u = (px + jitter[ray, 0]) / float(width)
        v = (py + jitter[ray, 1]) / float(height)
        theta = disk_u[ray, 0] * (2.0 * math.pi)
        r = torch.sqrt(disk_u[ray, 1])
        rd = cam.lens_radius * torch.stack(
            [r * torch.cos(theta), r * torch.sin(theta),
             torch.zeros_like(r)], dim=-1)
        offset = cam.x * rd[:, 0:1] + cam.y * rd[:, 1:2]
        origins.append(cam.origin + offset)
        directions.append(cam.lower_left_corner + u[:, None] * cam.horizontal
                          + v[:, None] * cam.vertical - cam.origin - offset)
        index.append(ray)
        seed_of.append(torch.full_like(ray, seed or 0))
    return ReplayedRays(torch.cat(origins), torch.cat(directions),
                        torch.cat(seed_of), torch.cat(index),
                        pixel_order[picks])
