"""Rank-side checks of the parallel layer: each case runs on every rank of
a spawn (``mesh.spawn(run_cases, n, (cases,))``), builds its own meshes and
holds the sharded result against the single-process one on the same
inputs.  The CPU tests (``tests/test_torch_parallel.py``) and
``chip_smoke.py``'s ``phase_parallel`` run them; they live here because
the spawn start method imports a rank's function by name.

Every rank must run the same cases in the same order (each makes process
groups and collectives).  A case returns rank 0's readings (numpy arrays,
floats) and None on the other ranks, unless it says otherwise.

Kernel launches: a case counts only its sharded calls' (``_main``: the
counts set to 0 just before each such call and read just after), never
those of the single-process comparison or of the set-up around it, so a
count shows what the parallel path itself launched.

Scene specs: ("preset", name, kwargs) for ``models.presets``, ("check",
name, kwargs) for ``models.check_scenes``,
("numpy", scene tree, camera tree or None) for a scene made elsewhere (the
JAX package's, in the tests).  isect: the intersector of an unsharded
wavefront, "brute" (brute force) or "sweeps" (``sweep_intersector``, the
sweep kernels); a tp-sharded wavefront takes the tp pair and is held
against ``sweep_intersector_pair`` of the same cull.  Injection specs:
("numpy", origin, direction, time, ball, prob) or ("seed", s) (rays in
swizzled order and a stream drawn on the rank's device from one
generator).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import Quirks, RenderConfig
from ..core.rays import Rays
from ..ops.integrators import SampleStream, stream_from_generator
from .mesh import make_mesh

Tensor = torch.Tensor


def _np(x):
    return None if x is None else x.detach().cpu().numpy()


def _lead() -> bool:
    return dist.get_rank() == 0


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _seconds(fn, device):
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def _counters():
    from ..ops import bvh, megakernel, sweeps
    return megakernel, sweeps, bvh


# This rank's kernel launches in the sharded calls of the running case
_MAIN: dict = {}


def _main(fn, device):
    """(fn(), seconds) of a sharded call, its kernel launches (the counts
    set to 0 just before it, read just after) added to the case's."""
    for mod in _counters():
        mod.reset_launch_counts()
    out = _seconds(fn, device)
    for mod in _counters():
        for k, v in mod.LAUNCHES.items():
            _MAIN[k] = _MAIN.get(k, 0) + v
    return out


def make_scene(device, spec):
    """(scene, camera or None) of a scene spec (module docstring)."""
    kind = spec[0]
    if kind == "preset":
        from ..models import presets
        return getattr(presets, spec[1])(device=device, **spec[2])
    if kind == "check":
        from ..models import check_scenes
        out = getattr(check_scenes, spec[1])(device=device, **spec[2])
        return out if isinstance(out, tuple) else (out, None)
    from ..utils.convert import camera_from_numpy, scene_from_numpy
    return (scene_from_numpy(spec[1], device),
            None if spec[2] is None else camera_from_numpy(spec[2], device))


def make_config(cfg: dict) -> RenderConfig:
    cfg = dict(cfg)
    if isinstance(cfg.get("quirks"), str):
        cfg["quirks"] = getattr(Quirks, cfg["quirks"])()
    return RenderConfig(**cfg)


def injected(device, spec, camera, cfg: RenderConfig):
    """(Rays, SampleStream) of an injection spec for the whole frame, in
    swizzled pixel order."""
    if spec[0] == "numpy":
        t = [torch.from_numpy(np.ascontiguousarray(x)).to(device)
             for x in spec[1:]]
        return Rays(*t[:3]), SampleStream(*t[3:])
    from ..core.camera import generate_pixel_rays
    from ..ops.render import swizzled_pixels
    gen = torch.Generator(device=device).manual_seed(spec[1])
    rays = generate_pixel_rays(
        camera, cfg.width, cfg.height, cfg.samples,
        swizzled_pixels(cfg.width, cfg.height, device=device), generator=gen)
    return rays, stream_from_generator(gen, rays.origin.shape[0],
                                       cfg.max_depth, device)


# ---------------------------------------------------------------------------
# Cases
# ---------------------------------------------------------------------------

def mesh_shapes(device) -> dict:
    """make_mesh's shapes on this world, and its assertion."""
    world = dist.get_world_size()
    out = {"tp2": make_mesh(world, tp=2).shape if world % 2 == 0 else None,
           "tp1": make_mesh(world, tp=1).shape}
    try:
        make_mesh(world, tp=world + 1)
        out["rejects"] = False
    except AssertionError:
        out["rejects"] = True
    return out


def tp_hits(device, scene, origin, direction, tp: int, quirks: str,
            coherent: bool = False, sphere_cull: str = "primary",
            t_min: float = 1e-3, t_max: float = 3.4e38) -> Optional[dict]:
    """The tp intersector's Hits over a (world / tp, tp) mesh and the
    single-process sweeps' (``intersect_scene_sweeps``, the same cull) on
    the same rays."""
    from ..ops.intersect import intersect_scene_sweeps
    from .intersect import intersect_scene_tp
    from .render import local_scene
    mesh = make_mesh(dist.get_world_size(), tp=tp)
    full, _ = make_scene(device, scene)
    rays = Rays(torch.from_numpy(origin).to(device),
                torch.from_numpy(direction).to(device),
                torch.zeros(origin.shape[0], device=device))
    q = getattr(Quirks, quirks)()
    loc, shard = local_scene(full, mesh, tp)
    got, _ = _main(lambda: intersect_scene_tp(
        loc, rays, mesh, shard, t_min, t_max, q, coherent,
        sphere_cull=sphere_cull), device)
    if not _lead():
        return None
    ref = intersect_scene_sweeps(full, rays, t_min, t_max, q, coherent,
                                 sphere_cull="all" if sphere_cull == "morton"
                                 else sphere_cull)
    keys = ("hit", "t", "p", "normal", "u", "v", "mat", "prim")
    return {"tp": {k: _np(getattr(got, k)) for k in keys},
            "single": {k: _np(getattr(ref, k)) for k in keys}}


def first_hits(device, scene, cfg: dict, tp: int, seed: int,
               chunk: int = 1 << 18) -> Optional[dict]:
    """The tp intersector's first-hit winners on a frame's camera rays
    (swizzled order, chunks of ``chunk``) against the single-process
    sweeps' (the same cull), with the differing rays counted by class:
    an exact-t tie (both winners at the same t), a triangle winner the
    margins' proof does not cover (``sweeps.triangle_conditioned``), or
    other.  Both intersectors timed."""
    from ..core.camera import generate_pixel_rays
    from ..ops import sweeps as sw
    from ..ops.intersect import intersect_scene_sweeps
    from ..ops.render import swizzled_pixels
    from .intersect import intersect_scene_tp
    from .render import local_scene
    mesh = make_mesh(dist.get_world_size(), tp=tp)
    full, camera = make_scene(device, scene)
    cfg = make_config(cfg)
    loc, shard = local_scene(full, mesh, tp)
    gen = torch.Generator(device=device).manual_seed(seed)
    rays = generate_pixel_rays(
        camera, cfg.width, cfg.height, cfg.samples,
        swizzled_pixels(cfg.width, cfg.height, device=device), generator=gen)
    n = rays.origin.shape[0]
    out = {"rays": n, "differ": 0, "ties": 0, "slivers": 0, "other": 0,
           "tp_s": 0.0, "single_s": 0.0}
    n_s = full.n_spheres
    tr = full.triangles
    for lo in range(0, n, chunk):
        r = Rays(*(x[lo:lo + chunk] for x in rays))
        with torch.no_grad():
            got, t_tp = _main(lambda: intersect_scene_tp(
                loc, r, mesh, shard, cfg.t_min, cfg.t_max, cfg.quirks, True,
                sphere_cull=cfg.wavefront_sphere_cull), device)
            ref, t_1 = _seconds(lambda: intersect_scene_sweeps(
                full, r, cfg.t_min, cfg.t_max, cfg.quirks, True,
                sphere_cull=cfg.wavefront_sphere_cull), device)
        out["tp_s"] += t_tp
        out["single_s"] += t_1
        diff = got.prim != ref.prim
        if not bool(diff.any()):
            continue
        tie = diff & got.hit & ref.hit & (got.t == ref.t)

        def covered(prim):
            k = (prim.long() - n_s).clamp(0, max(full.n_triangles - 1, 0))
            is_t = (prim >= n_s) & (prim < n_s + full.n_triangles)
            ok = sw.triangle_conditioned(r.direction, tr.v1[k] - tr.v0[k],
                                         tr.v2[k] - tr.v0[k])
            return ~is_t | ok

        sliver = diff & ~tie & ~(covered(got.prim) & covered(ref.prim))
        out["differ"] += int(diff.sum())
        out["ties"] += int(tie.sum())
        out["slivers"] += int(sliver.sum())
        out["other"] += int((diff & ~tie & ~sliver).sum())
    return out if _lead() else None


def _isect(cfg: RenderConfig, tp: int, isect: str):
    """(the sharded render's intersect_fn, the single process's)."""
    from ..ops.render import sweep_intersector, sweep_intersector_pair
    if cfg.engine != "wavefront":
        return None, None
    if tp > 1:
        return None, sweep_intersector_pair(cfg)
    fn = sweep_intersector(cfg) if isect == "sweeps" else None
    return fn, fn


def render(device, scene, cfg: dict, tp: int, inject, reference: bool = True,
           timed: bool = False, isect: str = "brute") -> Optional[dict]:
    """``render_image_sharded`` over a (world / tp, tp) mesh on an injected
    frame and, with ``reference``, the single-process ``render_image`` on
    the same rays and stream (rank 0; a tp-sharded wavefront against the
    sweep pair of the same cull, else against the caller's brute force or
    the fused engine)."""
    from ..ops.render import render_image
    from .render import render_image_sharded
    mesh = make_mesh(dist.get_world_size(), tp=tp)
    full, camera = make_scene(device, scene)
    cfg = make_config(cfg)
    rays, stream = injected(device, inject, camera, cfg)
    fn, fn1 = _isect(cfg, tp, isect)
    with torch.no_grad():
        img, secs = _main(lambda: render_image_sharded(
            full, camera, cfg, mesh, rays=rays, samples=stream,
            intersect_fn=fn), device)
        if timed:
            _, secs = _main(lambda: render_image_sharded(
                full, camera, cfg, mesh, rays=rays, samples=stream,
                intersect_fn=fn), device)
        if not _lead():
            return None
        out = {"img": _np(img), "s": secs, "mesh": mesh.shape}
        if reference:
            single, secs1 = _seconds(lambda: render_image(
                full, camera, cfg, rays=rays, samples=stream,
                intersect_fn=fn1), device)
            out.update(single=_np(single), single_s=secs1)
    return out


def sample_parallel(device, scene, cfg: dict, tp: int, seed: int,
                    isect: str = "brute") -> Optional[dict]:
    """``render_image_sample_sharded`` against the mean of the members'
    single-process renders (the same member generators; gamma and clip
    after the mean)."""
    from ..ops.render import finish_pixels, render_pixels
    from .render import member_generator, render_image_sample_sharded
    mesh = make_mesh(dist.get_world_size(), tp=tp)
    full, camera = make_scene(device, scene)
    cfg = make_config(cfg)
    fn0, fn = _isect(cfg, tp, isect)
    with torch.no_grad():
        img, secs = _main(lambda: render_image_sample_sharded(
            full, camera, cfg, mesh, seed=seed, intersect_fn=fn0), device)
        if not _lead():
            return None
        lin = dataclasses.replace(cfg, gamma=False, clip=False)
        acc = 0.0
        for member in range(mesh.dp):
            acc = acc + render_pixels(full, camera, lin, None,
                                      member_generator(seed, member, device),
                                      intersect_fn=fn)
        ref = finish_pixels(acc / mesh.dp, cfg).reshape(img.shape)
    return {"img": _np(img), "ref": _np(ref), "s": secs, "mesh": mesh.shape}


def _params(scene, names):
    out = {}
    if "centers" in names:
        out["centers"] = scene.spheres.center + 0.05
    if "albedo" in names:
        out["albedo"] = scene.textures.color0 * 0.6 + 0.1
    if "tri_v" in names:
        out["tri_v"] = tuple(x * 1.0 for x in (
            scene.triangles.v0, scene.triangles.v1, scene.triangles.v2))
    return {k: tuple(x.detach().clone().requires_grad_() for x in v)
            if isinstance(v, tuple) else v.detach().clone().requires_grad_()
            for k, v in out.items()}


def _flat(params) -> list:
    return [_np(x) for v in params.values()
            for x in (v if isinstance(v, tuple) else (v,))]


def _grad_scale(device, full, camera, cfg, mesh, names, target, rays,
                stream) -> np.ndarray:
    """Per parameter entry, sum over ranks of |T_r| / ranks, T_r the
    gradient of rank r's own tile before any reduction (what a post-hoc
    mesh step averages): the scale of the float32 sums that the mesh and
    a single process combine in different orders."""
    from ..ops.render import sweep_intersector_pair
    from .mesh import all_reduce
    from .train import _leaves, fit_config, rank_tile, value_and_grad
    lcfg = fit_config(cfg)
    isect = (sweep_intersector_pair(lcfg) if lcfg.engine == "wavefront"
             else None)
    local = rank_tile(mesh, cfg.width * cfg.height, cfg.samples, device)
    pixel_index, tgt, r, smp = local(target, rays, stream)
    _, grads = value_and_grad(full, _params(full, names), camera, lcfg,
                              pixel_index, tgt, None, isect, r, smp)
    flat = torch.cat([g.reshape(-1).abs() for g in _leaves(grads)])
    return _np(all_reduce(flat, dist.ReduceOp.SUM, dist.group.WORLD)
               / mesh.size)


@contextlib.contextmanager
def _algorithms(deterministic: bool):
    """The block under ``torch.use_deterministic_algorithms(deterministic,
    warn_only=True)``; the setting before is restored after."""
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(deterministic, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])


def fit_step(device, scene, cfg: dict, tp: int, names, inject,
             lr: float = 0.5, single: bool = True, reps: int = 1,
             by_counts: bool = False, deterministic: bool = False,
             grad_scale: bool = False) -> Optional[dict]:
    """One SGD step over a (world / tp, tp) mesh with per-bounce
    (overlapped) and with post-hoc gradient reduction, and, with
    ``single``, the single-process step (rank 0, twice: "single_again"
    shows whether the process repeats itself), all on the same params,
    target and injected frame (row-major); "start": the params before;
    with ``grad_scale``, "grad_scale": ``_grad_scale`` (flattened like
    the params, for ``regroup_limit``).
    reps > 1: each step's "s" is the least of ``reps`` - 1 more runs,
    timed under the default algorithms.  by_counts: make each step with
    ``make_fit_step(..., dp=, tp=)``, which makes its own mesh.
    deterministic: make the compared steps under
    ``torch.use_deterministic_algorithms`` (on the card the gradients'
    scatter-adds then sum in a fixed order; warnings only, so
    "single_again" is what shows that the run repeated itself)."""
    from ..ops.render import render_pixels
    from .train import make_fit_step
    world = dist.get_world_size()
    mesh = make_mesh(world, tp=tp)
    full, camera = make_scene(device, scene)
    cfg = make_config(cfg)
    rays, stream = injected(device, inject, camera, cfg)

    def run(step, timer=_main):
        return timer(lambda: step(_params(full, names), target, rays=rays,
                                  samples=stream), device)

    with _algorithms(deterministic), torch.no_grad():
        target = render_pixels(full, camera, cfg, None, rays=rays,
                               samples=stream) * 0.9
    out = {"mesh": mesh.shape}
    for name, overlap in (("overlapped", True), ("posthoc", False)):
        step = make_fit_step(full, camera, cfg, lr=lr, dp=world // tp,
                             tp=tp, mesh=None if by_counts else mesh,
                             overlap_grads=overlap)
        with _algorithms(deterministic):
            (loss, new), secs = run(step)
        times = [run(step)[1] for _ in range(reps - 1)] or [secs]
        out[name] = {"loss": float(loss), "params": _flat(new),
                     "s": min(times)}
    if grad_scale:
        with _algorithms(deterministic):
            out["grad_scale"] = _grad_scale(device, full, camera, cfg, mesh,
                                            names, target, rays, stream)
    if not _lead():
        return None
    out["start"] = _flat(_params(full, names))
    if single:
        step = make_fit_step(full, camera, cfg, lr=lr)
        for key in ("single", "single_again"):
            with _algorithms(deterministic):
                (loss, new), secs = run(step, _seconds)
            out[key] = {"loss": float(loss), "params": _flat(new),
                        "s": secs}
        times = [run(step, _seconds)[1] for _ in range(reps - 1)]
        out["single"]["s"] = min(times or [out["single"]["s"]])
    return out


def regroup_limit(out: dict, a: str, b: str, lr: float) -> list:
    """Per parameter array, the most by which the params of steps ``a``
    and ``b`` of a ``fit_step`` reading (with ``grad_scale``) may differ
    when both sum the same per-tile float32 gradients T_r and differ only
    in the order in which they add the R = ranks tiles: the post-hoc mesh
    step and the single process whose chunks are sized to the ranks'
    tiles (``cfg.ray_chunk``), each deterministic.  Each sum is within gamma_(R-1) sum_r |T_r| of the
    exact one (gamma_k = k u / (1 - k u), u = 2^-24; the division by a
    power-of-two R is exact), and each update p - lr g rounds twice
    (2 u (|p| + lr |g|) a step, |p| and lr |g| read from the params).  No
    tolerance: a difference beyond this is not rounding."""
    u = 2.0 ** -24
    ranks = out["mesh"]["dp"] * out["mesh"]["tp"]
    gamma = (ranks - 1) * u / (1 - (ranks - 1) * u)
    scale = out["grad_scale"]
    limits, at = [], 0
    for x, y, p in zip(out[a]["params"], out[b]["params"], out["start"]):
        g = scale[at:at + x.size].reshape(x.shape)
        at += x.size
        round_ = 2 * u * (np.abs(x) + np.abs(y) + np.abs(p - x)
                          + np.abs(p - y))
        limits.append(lr * 2 * gamma * g + round_)
    return limits


def albedo_fit(device, steps: int = 20) -> Optional[dict]:
    """The JAX package's test_fit_step_decreases_albedo_error
    (tests/test_parallel.py:126-141) over a (world / 2, 2) mesh: 24x16x2,
    path depth 3, no gamma, lr 1.0, albedos started 0.2 above the truth,
    ``steps`` steps on each rank's own draws; returns the mean albedo
    error before and after and the losses."""
    from ..models import presets
    from ..ops.render import render_image
    from .render import member_generator
    from .train import make_fit_step
    world = dist.get_world_size()
    mesh = make_mesh(world, tp=2 if world % 2 == 0 else 1)
    scene, cam = presets.three_spheres(aspect=1.5, device=device)
    cfg = RenderConfig(width=24, height=16, samples=2, max_depth=3,
                       gamma=False, ray_chunk=1 << 20)
    with torch.no_grad():
        target = render_image(scene, cam, cfg, torch.Generator(
            device=device).manual_seed(5))
    true = scene.textures.color0
    params = {"albedo": (true + 0.2).clamp(0, 1).requires_grad_()}
    step = make_fit_step(scene, cam, cfg, lr=1.0, mesh=mesh)
    err0 = float((true - params["albedo"]).abs().mean())
    losses = []
    for i in range(steps):
        (loss, params), _ = _main(lambda: step(
            params, target.reshape(-1, 3),
            member_generator(i, mesh.rank, device)), device)
        losses.append(float(loss))
    err1 = float((true - params["albedo"]).abs().mean())
    return {"err0": err0, "err1": err1, "losses": losses} if _lead() else None


CASES = {f.__name__: f for f in (mesh_shapes, tp_hits, first_hits, render,
                                 sample_parallel, fit_step, albedo_fit)}


def run_cases(device, cases) -> dict:
    """Run each (label, case name, kwargs) of ``cases`` on this rank, in
    order -> {label: result, "launches": {label: this rank's kernel launch
    counts in that case's sharded calls}} (module docstring)."""
    out = {"launches": {}}
    for label, name, kw in cases:
        _MAIN.clear()
        out[label] = CASES[name](device, **kw)
        zero = {k: 0 for mod in _counters() for k in mod.LAUNCHES}
        out["launches"][label] = {**zero, **_MAIN}
    return out
