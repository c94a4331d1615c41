"""Differentiable rendering: the inverse-rendering training step on one
device (the single-device part of the JAX package's ``parallel/train.py``).

Scene parameters (sphere centers and radii, texture albedos, mesh
vertices) are fit to a target image by gradient descent on the pixel loss,
through the wavefront engine and the sweep kernels' autograd Functions, or
(``engine='mega_diff'``) through the fused kernel's forward and the replay
backward, with the kernel's tables rebuilt from the moving scene at every
step.
Sharding pixels over several devices (``dp``) or prims (``tp``) comes with
slice 7 (``torch.distributed``); here both must be 1.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from ..config import RenderConfig, check_supported
from ..core.camera import Camera
from ..models.scene import Scene
from ..ops import megakernel as _mk
from ..ops.integrators import SampleStream
from ..ops.render import render_pixels, sweep_intersector_pair

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
               samples: Optional[SampleStream] = None) -> Tensor:
    """Mean squared pixel error on a pixel subset, rendered
    differentiably.  rays / samples: optional injected camera rays and
    scatter draws (render_pixels).  Under engine='mega_diff' the fused
    kernel's tables are built from the scene with the params installed
    (megakernel.py:2091-2094)."""
    scene = apply_sphere_params(scene_template, params)
    tables = (_mk.morton_tables(scene) if cfg.engine == "mega_diff"
              else None)
    cols = render_pixels(scene, camera, cfg, pixel_index, generator,
                         tables=tables, rays=rays, samples=samples,
                         intersect_fn=intersect_fn)
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
                   samples: Optional[SampleStream] = None):
    """(loss, grads): the pixel loss and its gradient for every parameter
    (a dict shaped like ``params``, whose tensors must require grad)."""
    loss = pixel_loss(scene_template, params, camera, cfg, pixel_index,
                      target, generator, intersect_fn, rays, samples)
    grads = torch.autograd.grad(loss, _leaves(params))
    return loss.detach(), _unflatten(params, grads)


def make_fit_step(scene_template: Scene, camera: Camera, cfg: RenderConfig,
                  lr: float = 0.5, dp: int = 1, tp: int = 1,
                  use_sweeps: bool = True) -> Callable:
    """An SGD step: (params, target_flat, generator=None, rays=None,
    samples=None) -> (loss, new params).

    target_flat: float32[H * W, 3] (row 0 = bottom).  params: a dict of
    leaf tensors that require grad; the new params are fresh leaves.
    use_sweeps: the wavefront's sweep pair (K3/K4/K5; on a CPU tensor
    their plain versions) or, False, the brute-force intersect.  Under
    engine='mega_diff' every step renders through the fused kernel from
    tables rebuilt from the current params."""
    if dp * tp != 1:
        raise NotImplementedError(
            f"dp={dp} x tp={tp}: multi-device fits are not ported yet: "
            "ROADMAP Queue 1 item 20 (slice 7)")
    lcfg = fit_config(cfg)
    mega = lcfg.engine == "mega_diff"
    isect = (sweep_intersector_pair(lcfg) if use_sweeps and not mega
             else None)
    pixel_index = torch.arange(cfg.width * cfg.height,
                               device=scene_template.device)

    def step(params, target_flat, generator=None, rays=None, samples=None):
        loss, grads = value_and_grad(scene_template, params, camera, lcfg,
                                     pixel_index, target_flat, generator,
                                     isect, rays, samples)
        flat = [(p - lr * g).detach().requires_grad_()
                for p, g in zip(_leaves(params), _leaves(grads))]
        return loss, _unflatten(params, flat)

    return step


def fit(scene_template: Scene, params: Params, camera: Camera,
        cfg: RenderConfig, target_image: Tensor, steps: int = 50,
        lr: float = 0.5, seed: int = 0, verbose: bool = False,
        dp: int = 1, tp: int = 1):
    """Run ``steps`` of SGD -> (final params, losses).  The draws come from
    one generator seeded with ``seed`` on the scene's device."""
    step_fn = make_fit_step(scene_template, camera, cfg, lr, dp, tp)
    gen = torch.Generator(device=scene_template.device).manual_seed(seed)
    target_flat = target_image.reshape(-1, 3)
    losses = []
    for i in range(steps):
        loss, params = step_fn(params, target_flat, gen)
        losses.append(float(loss))
        if verbose and i % 10 == 0:
            print(f"step {i}: loss {losses[-1]:.6f}")
    return params, losses
