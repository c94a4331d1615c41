"""Render loop (render.h:105-129): camera rays for every pixel and sample,
the fused integrator over chunks of ``cfg.ray_chunk`` rays, then the
post-process of render.h:123-128 (mean over samples, sqrt gamma, clip).

Pixels are visited in 32 x 16 screen blocks, so the 32 rays of a warp
(two pixels at 16 samples) start screen-coherent, and the image is
scattered back to row-major order at the end.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import RenderConfig
from ..core import camera as _cam
from ..core.rays import Rays
from ..models.scene import Scene
from . import megakernel as _mk
from .integrators import SampleStream, integrate

Tensor = torch.Tensor


def swizzled_pixels(width: int, height: int, block_w: int = 32,
                    block_h: int = 16, device=None) -> Tensor:
    """Flat pixel indices (y * width + x) ordered by block_h x block_w
    screen blocks (blocks row-major, pixels row-major inside a block):
    int64[width * height] on ``device`` (default CPU).

    Built by walking the padded block grid in order and dropping the pixels
    past the image edge, so no sort is needed (a numpy lexsort of the
    1920x1080 frame took 0.40 s on the host)."""
    nby, nbx = -(-height // block_h), -(-width // block_w)
    by = torch.arange(nby, device=device).view(nby, 1, 1, 1)
    bx = torch.arange(nbx, device=device).view(1, nbx, 1, 1)
    yy = torch.arange(block_h, device=device).view(1, 1, block_h, 1)
    xx = torch.arange(block_w, device=device).view(1, 1, 1, block_w)
    y = (by * block_h + yy).expand(nby, nbx, block_h, block_w)
    x = (bx * block_w + xx).expand(nby, nbx, block_h, block_w)
    inside = (y < height) & (x < width)
    return (y * width + x)[inside]


def render_image(scene: Scene, camera: _cam.Camera, cfg: RenderConfig,
                 generator: Optional[torch.Generator] = None,
                 tables: Optional[_mk.MegaTables] = None,
                 rays: Optional[Rays] = None,
                 samples: Optional[SampleStream] = None) -> Tensor:
    """Render the full frame -> float32[height, width, 3] on the scene's
    device (row 0 = BOTTOM row; the PNG writer flips, render.h:135-147).

    rays / samples: optional injected camera rays and scatter draws for
    every ray, in swizzled pixel order (render_pixels); otherwise both are
    drawn from ``generator`` (default: seed 0 on the scene's device)."""
    pix = swizzled_pixels(cfg.width, cfg.height, device=scene.device)
    colors = render_pixels(scene, camera, cfg, pix, generator, tables, rays,
                           samples)
    out = torch.zeros((cfg.width * cfg.height, 3), dtype=colors.dtype,
                      device=colors.device)
    out[pix] = colors
    return out.reshape(cfg.height, cfg.width, 3)


def render_pixels(scene: Scene, camera: _cam.Camera, cfg: RenderConfig,
                  pixel_index: Optional[Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  tables: Optional[_mk.MegaTables] = None,
                  rays: Optional[Rays] = None,
                  samples: Optional[SampleStream] = None) -> Tensor:
    """Render a set of pixels (default: all, row-major) -> float32[n, 3].

    rays: optional Rays of n * cfg.samples rays (a pixel's samples
    adjacent); samples: optional SampleStream over the same rays."""
    device = scene.device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    if pixel_index is None:
        pixel_index = torch.arange(cfg.width * cfg.height, device=device)
    if tables is None:
        tables = _mk.build_mega_tables(scene)
    spp = cfg.samples
    n_pix = pixel_index.shape[0]
    pix_chunk = max(1, min(cfg.ray_chunk // spp, n_pix))
    starts = range(0, n_pix, pix_chunk)
    seeds = [None] * len(starts)
    if cfg.integrator == "path" and samples is None:
        # one draw for every chunk's kernel seed, before any work is queued
        seeds = torch.randint(0, 2 ** 62, (len(starts),), generator=generator,
                              device=generator.device).tolist()
    colors = []
    for lo, seed in zip(starts, seeds):
        hi = min(n_pix, lo + pix_chunk)
        ray_lo, ray_hi = lo * spp, hi * spp
        if rays is not None:
            chunk_rays = Rays(*(x[ray_lo:ray_hi] for x in rays))
        else:
            chunk_rays = _cam.generate_pixel_rays(
                camera, cfg.width, cfg.height, spp, pixel_index[lo:hi],
                generator=generator)
        chunk_samples = (SampleStream(samples.ball[:, ray_lo:ray_hi],
                                      samples.prob[:, ray_lo:ray_hi])
                         if samples is not None else None)
        cols = integrate(scene, chunk_rays, cfg, tables=tables,
                         samples=chunk_samples, seed=seed)
        colors.append(cols.reshape(hi - lo, spp, 3).mean(dim=1))
    return finish_pixels(torch.cat(colors), cfg)


def finish_pixels(colors: Tensor, cfg: RenderConfig) -> Tensor:
    """render.h:124-128: sqrt gamma (radiance at or below 0 maps to 0, with
    the double-where that keeps the gradient finite), then clip to [0, 1]."""
    out = colors
    if cfg.gamma:
        pos = out > 0.0
        out = torch.where(pos, torch.sqrt(torch.where(pos, out, 1.0)), 0.0)
    if not cfg.clip:
        return out
    return torch.clamp(out, 0.0, 1.0)
