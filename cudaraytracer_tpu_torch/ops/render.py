"""Render loop (render.h:105-129): camera rays for every pixel and sample,
the integrator (``cfg.engine``) over chunks of ``cfg.ray_chunk`` rays, then
the post-process of render.h:123-128 (mean over samples, sqrt gamma,
clip).  The loop is plain tensor code: when scene tensors require grad, the
returned pixels carry the autograd graph (the fit renders through it).

Pixels are visited in 32 x 16 screen blocks, so the 32 rays of a warp
(two pixels at 16 samples) start screen-coherent, and the image is
scattered back to row-major order at the end.

The wavefront engine intersects by brute force unless given an intersector:
``sweep_intersector`` (the sweep kernels), ``sweep_intersector_pair``
(culled camera sweeps, then the bounce policy) or ``bvh_intersector`` (the
triangles through a FlatBVH).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from ..config import RenderConfig, check_supported
from ..core import camera as _cam
from ..core.rays import Rays
from ..models.scene import Scene
from ..utils import profiling
from . import intersect as _isect
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


def sweep_intersector(cfg: RenderConfig, coherent: bool = False):
    """intersect_fn(scene, rays, alive=None) through the sweep kernels
    (render.py:56 of the JAX package, which calls them Pallas).
    coherent=True marks camera rays in screen blocks: the sphere sweep
    culls by chunk boxes under the 'primary' policy.

    cfg.wavefront_sphere_cull='morton' culls every sphere sweep and sets
    ``fn.morton_spheres``, so trace_path permutes the prims into Morton
    order once per trace, which makes the chunk boxes compact.
    ``fn.build_tables(scene)`` builds the sweep tables that trace_path
    passes to every call of a trace on CUDA rays (``tables=``)."""
    check_supported(cfg)
    mode = cfg.wavefront_sphere_cull
    policy = "all" if mode == "morton" else mode

    def fn(scene, rays, alive=None, tables=None):
        return _isect.intersect_scene_sweeps(
            scene, rays, cfg.t_min, cfg.t_max, cfg.quirks, coherent, alive,
            sphere_cull=policy, kernel_attrs=cfg.wavefront_kernel_attrs,
            tables=tables)

    fn.morton_spheres = mode == "morton"
    fn.build_tables = functools.partial(
        _isect.sweep_tables, attrs=cfg.wavefront_kernel_attrs)
    return fn


def bvh_intersector(cfg: RenderConfig, bvh):
    """intersect_fn(scene, rays, alive=None) through the FlatBVH ``bvh``
    over the scene's triangles (``intersect.intersect_scene_bvh``, the
    traversal kernel on CUDA rays; render.py:44 of the JAX package, which
    passes the BVH as ``aux``).  The closure keeps the scene's prim order:
    the BVH's ids index its triangles."""
    check_supported(cfg)

    def fn(scene, rays, alive=None):
        return _isect.intersect_scene_bvh(scene, rays, bvh, cfg.t_min,
                                          cfg.t_max, cfg.quirks, alive=alive)

    return fn


def sweep_intersector_pair(cfg: RenderConfig):
    """(primary_fn, bounce_fn): the coherent camera pass and the incoherent
    bounces (render.py:91); pass the pair as ``intersect_fn``."""
    return (sweep_intersector(cfg, coherent=True),
            sweep_intersector(cfg, coherent=False))


def render_image(scene: Scene, camera: _cam.Camera, cfg: RenderConfig,
                 generator: Optional[torch.Generator] = None,
                 tables: Optional[_mk.MegaTables] = None,
                 rays: Optional[Rays] = None,
                 samples: Optional[SampleStream] = None,
                 intersect_fn=None) -> Tensor:
    """Render the full frame -> float32[height, width, 3] on the scene's
    device (row 0 = BOTTOM row; the PNG writer flips, render.h:135-147).

    rays / samples: optional injected camera rays and scatter draws for
    every ray, in swizzled pixel order (render_pixels); otherwise both are
    drawn from ``generator`` (default: seed 0 on the scene's device)."""
    with profiling.span("render.frame", width=cfg.width, height=cfg.height,
                        spp=cfg.samples):
        pix = swizzled_pixels(cfg.width, cfg.height, device=scene.device)
        colors = render_pixels(scene, camera, cfg, pix, generator, tables,
                               rays, samples, intersect_fn)
        with profiling.span("render.finish"):
            out = torch.zeros((cfg.width * cfg.height, 3),
                              dtype=colors.dtype, device=colors.device)
            out[pix] = colors
            return out.reshape(cfg.height, cfg.width, 3)


def render_pixels(scene: Scene, camera: _cam.Camera, cfg: RenderConfig,
                  pixel_index: Optional[Tensor] = None,
                  generator: Optional[torch.Generator] = None,
                  tables: Optional[_mk.MegaTables] = None,
                  rays: Optional[Rays] = None,
                  samples: Optional[SampleStream] = None,
                  intersect_fn=None, mesh=None) -> Tensor:
    """Render a set of pixels (default: all, row-major) -> float32[n, 3].

    rays: optional Rays of n * cfg.samples rays (a pixel's samples
    adjacent); samples: optional SampleStream over the same rays.
    tables: the fused engines' tables (built when not given and the fused
    engine serves the scene, ``megakernel_supported``; above that ceiling
    ``integrate`` renders on the wavefront.  The mega_diff backward gives
    them no gradient, so a fit passes tables built from its current
    scene);
    intersect_fn: the wavefront's intersector (brute force when None);
    mesh: the mesh of cfg.grad_sync_axes (``integrate``)."""
    device = scene.device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    if pixel_index is None:
        pixel_index = torch.arange(cfg.width * cfg.height, device=device)
    mega = cfg.engine in ("mega", "mega_diff")
    if mega and tables is None and _mk.megakernel_supported(scene):
        tables = _mk.build_mega_tables(scene, mxu=_mk.mxu_wanted(scene, cfg))
    spp = cfg.samples
    n_pix = pixel_index.shape[0]
    pix_chunk = max(1, min(cfg.ray_chunk // spp, n_pix))
    starts = range(0, n_pix, pix_chunk)
    seeds = [None] * len(starts)
    if (cfg.integrator == "path" and samples is None
            and (mega or cfg.wavefront_tpu_prng)):
        # one draw for every chunk's counter-draw seed, before any work is
        # queued
        seeds = torch.randint(0, 2 ** 62, (len(starts),), generator=generator,
                              device=generator.device).tolist()
    colors = []
    for lo, seed in zip(starts, seeds):
        hi = min(n_pix, lo + pix_chunk)
        ray_lo, ray_hi = lo * spp, hi * spp
        with profiling.span("render.chunk", rays=ray_hi - ray_lo):
            with profiling.span("render.camera_rays", engine=cfg.engine):
                if rays is not None:
                    chunk_rays = Rays(*(x[ray_lo:ray_hi] for x in rays))
                else:
                    chunk_rays = _cam.generate_pixel_rays(
                        camera, cfg.width, cfg.height, spp,
                        pixel_index[lo:hi], generator=generator)
            chunk_samples = (SampleStream(samples.ball[:, ray_lo:ray_hi],
                                          samples.prob[:, ray_lo:ray_hi])
                             if samples is not None else None)
            with profiling.span("render.integrate", engine=cfg.engine):
                cols = integrate(scene, chunk_rays, cfg, tables=tables,
                                 samples=chunk_samples, generator=generator,
                                 seed=seed, intersect_fn=intersect_fn,
                                 mesh=mesh)
            colors.append(cols.reshape(hi - lo, spp, 3).mean(dim=1))
    with profiling.span("render.finish"):
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
