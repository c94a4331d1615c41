"""Rendering over a ('dp', 'tp') mesh of ranks (the JAX package's
``parallel/render.py``).

Every rank calls the same function on the same scene, camera and config.
Pixels are tiled over 'dp' in the render loop's swizzled order, padded to a
dp multiple as JAX pads them and trimmed after; the sphere and triangle
tables are sharded over 'tp' (``shard_scene``, ``local_scene``) and
intersected by ``intersect.tp_intersector_pair``; the frame is assembled by
an all-reduce SUM over the rank's dp group of a zero frame into which each
member has written its tile.  Every rank returns the whole frame.

Draws: each dp member draws from its own generator, seeded from (seed,
member) (``member_generator``; JAX folds the member into its key).  Under
injection each member takes its own pixels' slice of the rays and stream,
so a dp render is bit-equal to the single-process ``render_image`` on the
same stream.

The fused engines ('mega', 'mega_diff') replicate their tables and never
tp-shard (render.py:69-76 of the JAX package): the fused kernel runs its
own closest hit, so a tp shard would render a 1/tp slice of the scene; tp
members render the same tile.

JAX's ``render_image_sharded_jit`` and its cache have no counterpart: there
is nothing to compile.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import RenderConfig
from ..core.camera import Camera
from ..core.rays import Rays
from ..models.scene import Scene, Spheres, Triangles
from ..ops import megakernel as _mk
from ..ops.integrators import SampleStream
from ..ops.render import finish_pixels, render_pixels, swizzled_pixels
from .intersect import Shard, tp_intersector_pair
from .mesh import Mesh, all_reduce, pad_rows

Tensor = torch.Tensor


def member_generator(seed: int, member: int, device) -> torch.Generator:
    """The draws of dp member ``member`` of a render seeded with ``seed``:
    a generator on ``device`` seeded from both through numpy's SeedSequence
    (stands in for JAX's ``fold_in(key, member)``)."""
    s = int(np.random.SeedSequence([seed, member]).generate_state(
        1, np.uint64)[0]) >> 1
    return torch.Generator(device=device).manual_seed(s)


def shard_scene(scene: Scene, tp: int):
    """(scene with its sphere and triangle tables padded to a tp multiple,
    true sphere count, true triangle count) (render.py:39); the padding
    rows duplicate row 0 and are masked by their global index."""
    n_s, n_t = scene.n_spheres, scene.n_triangles
    if tp == 1:
        return scene, n_s, n_t
    sph, tri = scene.spheres, scene.triangles
    if n_s:
        sph = Spheres(*(pad_rows(x, tp) for x in sph))
    if n_t:
        tri = Triangles(*(pad_rows(x, tp) for x in tri))
    return scene._replace(spheres=sph, triangles=tri), n_s, n_t


def local_scene(scene: Scene, mesh: Mesh, tp: int):
    """(this member's scene, its Shard): the scene with only this tp
    member's contiguous shard of the padded sphere and triangle tables
    (the counterpart of ``_strip_big_tables`` and the shard_map's
    in_specs, render.py:54)."""
    padded, n_s, n_t = shard_scene(scene, tp)
    i = mesh.tp_index if tp > 1 else 0
    ks = padded.n_spheres // tp
    kt = padded.n_triangles // tp
    sph = Spheres(*(x[i * ks:(i + 1) * ks] for x in padded.spheres))
    tri = Triangles(*(x[i * kt:(i + 1) * kt] for x in padded.triangles))
    return (padded._replace(spheres=sph, triangles=tri),
            Shard(i * ks, i * kt, n_s, n_t))


def _engine_tp(cfg: RenderConfig, mesh: Mesh) -> int:
    return 1 if cfg.engine in ("mega", "mega_diff") else mesh.tp


def _member_view(scene: Scene, cfg: RenderConfig, mesh: Mesh,
                 intersect_fn):
    """(scene, intersect_fn) of this rank: the tp shard and the tp
    intersector pair when the engine shards prims, else the scene and the
    caller's intersector."""
    tp = _engine_tp(cfg, mesh)
    if tp == 1:
        return scene, intersect_fn
    if intersect_fn is not None:
        raise ValueError("a tp-sharded render intersects through "
                         "parallel.intersect.tp_intersector_pair; pass no "
                         "intersect_fn")
    scene_loc, shard = local_scene(scene, mesh, tp)
    return scene_loc, tp_intersector_pair(cfg, mesh, shard)


def _tile(x: Tensor, multiple: int, lo: int, hi: int, axis: int = 0):
    return pad_rows(x, multiple, axis).narrow(axis, lo, hi - lo)


def render_image_sharded(scene: Scene, camera: Camera, cfg: RenderConfig,
                         mesh: Mesh, seed: int = 0,
                         tables: Optional[_mk.MegaTables] = None,
                         rays: Optional[Rays] = None,
                         samples: Optional[SampleStream] = None,
                         intersect_fn=None) -> Tensor:
    """The full frame with pixels over 'dp' and prims over 'tp' ->
    float32[height, width, 3] on every rank (row 0 = bottom, as
    ``render_image``) (render.py:64).

    rays / samples: optional injected camera rays and stream for every ray
    of the frame, in swizzled pixel order (as ``render_image`` takes them);
    each member renders its slice.  intersect_fn: the wavefront's
    intersector when tp == 1 (brute force when None); a tp-sharded render
    takes the tp intersector pair."""
    dp = mesh.dp
    device = scene.device
    spp = cfg.samples
    pix = swizzled_pixels(cfg.width, cfg.height, device=device)
    n_pix = pix.shape[0]
    per = -(-n_pix // dp)
    lo, hi = mesh.dp_index * per, (mesh.dp_index + 1) * per
    tile = _tile(pix, dp, lo, hi)
    trays = tsamples = None
    if rays is not None:
        trays = Rays(*(_tile(x, dp * spp, lo * spp, hi * spp) for x in rays))
    if samples is not None:
        tsamples = SampleStream(
            *(_tile(x, dp * spp, lo * spp, hi * spp, 1) for x in samples))
    scene_loc, fn = _member_view(scene, cfg, mesh, intersect_fn)
    colors = render_pixels(scene_loc, camera, cfg, tile,
                           member_generator(seed, mesh.dp_index, device),
                           tables, trays, tsamples, fn)
    valid = max(0, min(per, n_pix - lo))
    frame = torch.zeros((n_pix, 3), dtype=colors.dtype, device=device)
    frame[tile[:valid]] = colors[:valid]
    frame = all_reduce(frame, dist.ReduceOp.SUM, mesh.dp_group)
    return frame.reshape(cfg.height, cfg.width, 3)


def render_image_sample_sharded(scene: Scene, camera: Camera,
                                cfg: RenderConfig, mesh: Mesh, seed: int = 0,
                                tables: Optional[_mk.MegaTables] = None,
                                intersect_fn=None) -> Tensor:
    """Sample-parallel rendering (render.py:117): every dp member renders
    all pixels with its own draws (``member_generator(seed, member)``),
    the members' linear, unclipped radiance is averaged over 'dp', and
    gamma and clip are applied once, after the mean; the effective samples
    per pixel are dp x cfg.samples.  Prims shard over 'tp' as in
    ``render_image_sharded``."""
    cfg_lin = dataclasses.replace(cfg, gamma=False, clip=False)
    scene_loc, fn = _member_view(scene, cfg, mesh, intersect_fn)
    cols = render_pixels(scene_loc, camera, cfg_lin, None,
                         member_generator(seed, mesh.dp_index, scene.device),
                         tables, intersect_fn=fn)
    cols = all_reduce(cols, dist.ReduceOp.SUM, mesh.dp_group) / mesh.dp
    return finish_pixels(cols, cfg).reshape(cfg.height, cfg.width, 3)
