"""Differentiable rendering: the inverse-rendering training step (the JAX
package's ``parallel/train.py``).

Scene parameters (sphere centers and radii, texture albedos, mesh
vertices) are fit to a target image by gradient descent on the pixel loss,
through the wavefront engine and the sweep kernels' autograd Functions, or
(``engine='mega_diff'``) through the fused kernel's forward and the replay
backward, with the kernel's tables rebuilt from the moving scene at every
step.

Over a mesh of ranks (``parallel.mesh``) the pixels are sharded over dp x
tp, one distinct tile a rank (the tp axis shards pixels too, as in JAX:
the fit's prims are replicated), the parameters are replicated and the
loss is the mean over ranks.  The gradients are averaged over the whole
mesh either per bounce inside the backward (``overlap_grads``: the path
integrator's ``grad_sync_axes``, one all-reduce bucket a bounce) or once
after it; both give the same step within float rounding.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..config import RenderConfig, check_supported
from ..core.camera import Camera
from ..models.scene import Scene
from ..ops import megakernel as _mk
from ..core.rays import Rays
from ..ops.integrators import SampleStream
from ..ops.render import render_pixels, sweep_intersector_pair
from ..utils import profiling
from .mesh import Mesh, make_mesh, pad_rows, pad_to_multiple, pmean

Tensor = torch.Tensor
Params = Dict[str, object]


def apply_sphere_params(scene: Scene, params: Params) -> Scene:
    """Install fit parameters into a scene.

    Keys: 'centers' float32[S, 3], 'radii' float32[S], 'albedo'
    float32[K, 3] (replaces texture color0 rows: lambertian albedos),
    'tri_v' a tuple of three float32[T, 3] (mesh vertices)."""
    s = scene
    if "centers" in params:
        s = s._replace(spheres=s.spheres._replace(center=params["centers"]))
    if "radii" in params:
        s = s._replace(spheres=s.spheres._replace(radius=params["radii"]))
    if "albedo" in params:
        s = s._replace(textures=s.textures._replace(color0=params["albedo"]))
    if "tri_v" in params:
        v0, v1, v2 = params["tri_v"]
        s = s._replace(triangles=s.triangles._replace(v0=v0, v1=v1, v2=v2))
    return s


def pixel_loss(scene_template: Scene, params: Params, camera: Camera,
               cfg: RenderConfig, pixel_index: Tensor, target: Tensor,
               generator: Optional[torch.Generator] = None,
               intersect_fn=None, rays=None,
               samples: Optional[SampleStream] = None,
               mesh: Optional[Mesh] = None) -> Tensor:
    """Mean squared pixel error on a pixel subset, rendered
    differentiably.  rays / samples: optional injected camera rays and
    scatter draws (render_pixels).  Under engine='mega_diff' the fused
    kernel's tables are built from the scene with the params installed
    (megakernel.py:2091-2094).  mesh: the mesh of cfg.grad_sync_axes."""
    scene = apply_sphere_params(scene_template, params)
    tables = (_mk.morton_tables(scene) if cfg.engine == "mega_diff"
              else None)
    cols = render_pixels(scene, camera, cfg, pixel_index, generator,
                         tables=tables, rays=rays, samples=samples,
                         intersect_fn=intersect_fn, mesh=mesh)
    return torch.mean((cols - target) ** 2)


def _leaves(params: Params):
    return [x for v in params.values()
            for x in (v if isinstance(v, tuple) else (v,))]


def _unflatten(params: Params, flat):
    it = iter(flat)
    return {k: tuple(next(it) for _ in v) if isinstance(v, tuple)
            else next(it) for k, v in params.items()}


def fit_config(cfg: RenderConfig) -> RenderConfig:
    """The fit's render config: the attribute-carrying sphere sweep (K5) on
    the wavefront, the gradient workload's form in the JAX package; or
    engine='mega_diff' (the fused forward, the replay backward)."""
    cfg = dataclasses.replace(cfg, wavefront_kernel_attrs=True)
    check_supported(cfg)
    if cfg.engine not in ("wavefront", "mega_diff"):
        raise ValueError(f"engine={cfg.engine!r} is forward only; the fit "
                         "differentiates through engine='wavefront' or "
                         "'mega_diff'")
    return cfg


def value_and_grad(scene_template: Scene, params: Params, camera: Camera,
                   cfg: RenderConfig, pixel_index: Tensor, target: Tensor,
                   generator: Optional[torch.Generator] = None,
                   intersect_fn=None, rays=None,
                   samples: Optional[SampleStream] = None,
                   mesh: Optional[Mesh] = None):
    """(loss, grads): the pixel loss and its gradient for every parameter
    (a dict shaped like ``params``, whose tensors must require grad)."""
    dev = scene_template.device
    with profiling.span("fit.forward", device=dev):
        loss = pixel_loss(scene_template, params, camera, cfg, pixel_index,
                          target, generator, intersect_fn, rays, samples,
                          mesh)
    with profiling.span("fit.backward", device=dev):
        grads = torch.autograd.grad(loss, _leaves(params))
    return loss.detach(), _unflatten(params, grads)


def make_fit_step(scene_template: Scene, camera: Camera, cfg: RenderConfig,
                  lr: float = 0.5, dp: int = 1, tp: int = 1,
                  use_sweeps: bool = True, mesh: Optional[Mesh] = None,
                  overlap_grads: bool = True) -> Callable:
    """An SGD step: (params, target_flat, generator=None, rays=None,
    samples=None) -> (loss, new params).

    target_flat: float32[H * W, 3] (row 0 = bottom).  params: a dict of
    leaf tensors that require grad; the new params are fresh leaves.
    use_sweeps: the wavefront's sweep pair (K3/K4/K5; on a CPU tensor
    their plain versions) or, False, the brute-force intersect.  Under
    engine='mega_diff' every step renders through the fused kernel from
    tables rebuilt from the current params.

    Over a mesh (``mesh``, or dp x tp > 1: ``make_mesh(dp * tp, tp)`` on
    the process group; train.py:63 of the JAX package) every rank calls
    the step with the same arguments: the pixels, padded to a multiple of
    the ranks with pixel 0 (its target row too), split into one tile a
    rank in row-major order; rays / samples: the injected rays and stream
    of the whole frame, each rank taking its tile's slice; generator: this
    rank's draws (``render.member_generator``).  The loss is the mean
    over ranks.  overlap_grads: average the gradients per bounce inside
    the backward (cfg.grad_sync_axes = ('dp', 'tp'), path integrator only,
    as JAX's :97), else once after it."""
    lcfg = fit_config(cfg)
    mega = lcfg.engine == "mega_diff"
    isect = (sweep_intersector_pair(lcfg) if use_sweeps and not mega
             else None)
    n_pix = cfg.width * cfg.height
    if mesh is None and dp * tp != 1:
        mesh = make_mesh(dp * tp, tp)
    if mesh is None:
        pixel_index = torch.arange(n_pix, device=scene_template.device)

        def step(params, target_flat, generator=None, rays=None,
                 samples=None):
            with profiling.span("fit.step"):
                loss, grads = value_and_grad(scene_template, params, camera,
                                             lcfg, pixel_index, target_flat,
                                             generator, isect, rays, samples)
                with profiling.span("fit.update"):
                    return loss, _sgd(params, grads, lr)

        return step

    overlap = overlap_grads and lcfg.integrator == "path"
    if overlap:
        lcfg = dataclasses.replace(lcfg, grad_sync_axes=("dp", "tp"))
    local = rank_tile(mesh, n_pix, cfg.samples, scene_template.device)

    def step(params, target_flat, generator=None, rays=None, samples=None):
        with profiling.span("fit.step"):
            pixel_index, target, rays, samples = local(target_flat, rays,
                                                       samples)
            loss, grads = value_and_grad(scene_template, params, camera,
                                         lcfg, pixel_index, target,
                                         generator, isect, rays, samples,
                                         mesh)
            with profiling.span("fit.update"):
                loss = pmean(loss, mesh, ("dp", "tp"))
                if not overlap:
                    leaves = _leaves(grads)
                    flat = pmean(torch.cat([g.reshape(-1) for g in leaves]),
                                 mesh, ("dp", "tp"))
                    grads = _unflatten(grads, [
                        part.view_as(g) for part, g in
                        zip(flat.split([g.numel() for g in leaves]),
                            leaves)])
                return loss, _sgd(params, grads, lr)

    return step


def rank_tile(mesh: Mesh, n_pix: int, spp: int, device) -> Callable:
    """This rank's tile of a frame over the mesh: a function (target_flat,
    rays=None, samples=None) -> (pixel_index, target, rays, samples) of
    the rank's pixels alone.  The pixels, padded to a multiple of the
    ranks with pixel 0 (its target row and rays too), are split into one
    tile a rank in row-major order; rays / samples are the whole frame's
    (``spp`` rays a pixel, pixel-major)."""
    ranks = mesh.size
    per = -(-n_pix // ranks)
    lo, hi = mesh.rank * per, (mesh.rank + 1) * per
    pixel_index = torch.from_numpy(pad_to_multiple(
        np.arange(n_pix), ranks, fill=0)[lo:hi]).to(device)

    def tile(x, axis=0):
        return pad_rows(x, ranks * spp, axis).narrow(axis, lo * spp,
                                                     (hi - lo) * spp)

    def local(target_flat, rays=None, samples=None):
        if rays is not None:
            rays = Rays(*(tile(x) for x in rays))
        if samples is not None:
            samples = SampleStream(*(tile(x, 1) for x in samples))
        return pixel_index, pad_rows(target_flat, ranks)[lo:hi], rays, samples

    return local


def _sgd(params: Params, grads: Params, lr: float) -> Params:
    flat = [(p - lr * g).detach().requires_grad_()
            for p, g in zip(_leaves(params), _leaves(grads))]
    return _unflatten(params, flat)


def fit(scene_template: Scene, params: Params, camera: Camera,
        cfg: RenderConfig, target_image: Tensor, steps: int = 50,
        lr: float = 0.5, seed: int = 0, verbose: bool = False,
        dp: int = 1, tp: int = 1, mesh: Optional[Mesh] = None):
    """Run ``steps`` of SGD -> (final params, losses).  The draws come from
    one generator seeded with ``seed`` on the scene's device; over a mesh
    (``mesh``, or dp x tp > 1 on the process group) from each rank's
    ``member_generator(seed, rank)``, and every rank returns the same
    params and losses."""
    if mesh is None and dp * tp != 1:
        mesh = make_mesh(dp * tp, tp)
    step_fn = make_fit_step(scene_template, camera, cfg, lr, mesh=mesh)
    if mesh is None:
        gen = torch.Generator(device=scene_template.device).manual_seed(seed)
    else:
        from .render import member_generator
        gen = member_generator(seed, mesh.rank, scene_template.device)
    target_flat = target_image.reshape(-1, 3)
    losses = []
    for i in range(steps):
        loss, params = step_fn(params, target_flat, gen)
        losses.append(float(loss))
        if verbose and i % 10 == 0:
            print(f"step {i}: loss {losses[-1]:.6f}")
    return params, losses
