"""Integrators and engine dispatch.

The reference ships three integrators, chosen by (un)commenting
render.h:119-121: ``shade`` (the path tracer, render.h:48-67),
``LambertShade`` (render.h:70-87) and ``shade_normal`` (render.h:90-103).

Three engines run them:
  * ``engine='mega'``: all three in the fused kernel (``ops/megakernel.py``;
    K1, with rects / TRS prims K8, with image textures K9, above 8,192
    prims of a type the segment level K6), forward only, routed by
    ``megakernel.select_mega``: the path integrator through the
    compaction drivers' bounce windows (K10) under cfg.compact_every,
    cfg.compact_after or, at 2^16 prims and more, cfg.compact_auto;
  * ``engine='wavefront'`` (the default): one intersection per bounce over
    the whole ray batch, then differentiable shading in tensor ops
    (``trace_path``, ``lambert_shade``, ``shade_normal``).  The intersector
    is brute force (``intersect_fn=None``) or the sweep kernels
    (``ops/render.sweep_intersector``);
  * ``engine='mega_diff'``: the path integrator through the fused kernel
    forward, recording each bounce's winner (K7), and a backward that
    replays the wavefront on those winners only
    (``megakernel.trace_path_mega_diff``).  Lambert and normal have no
    fused differentiable pairing and run on the wavefront.

``trace_path(return_winners=True)`` records the winners of a wavefront
render; ``trace_path(winners=...)`` replays them (``intersect.replay_hits``)
instead of intersecting.

Differentiability: the discrete hit choice is piecewise constant, so
gradients flow through the continuous quantities of the chosen prim (t, p,
normal, attenuation); random draws are taken outside the differentiated
function.  With gradients on, each bounce is checkpointed (recomputed in
the backward instead of stored), as the JAX package checkpoints its scan;
the draws are made before the checkpointed function, so the recompute
reads the same numbers whatever their source.

Draws of the wavefront path integrator, in order of precedence:
  1. an injected ``SampleStream``;
  2. ``cfg.wavefront_tpu_prng`` (the default; the JAX name kept for
     parity): the counter-keyed Philox draws of kernel K2
     (``megakernel.scatter_draws``, every bounce of a trace in one launch
     before the bounce loop) on a CUDA tensor, its plain version on a CPU
     tensor, so both devices draw the same numbers for a seed;
  3. otherwise the explicit ``torch.Generator`` (the JAX package's
     threefry draws).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint as _checkpoint

from ..config import RenderConfig, check_supported
from ..core import vec as v3
from ..core.rays import Rays
from ..models import materials as _mat
from ..models.scene import Scene
from ..utils import profiling
from . import intersect as _isect
from . import megakernel as _mk
from . import sweeps as _sw

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


def _split_fns(intersect_fn):
    """intersect_fn may be one callable or a (primary_fn, bounce_fn) pair
    (ops.render.sweep_intersector_pair): the primary fn serves the coherent
    camera pass, the bounce fn the incoherent later bounces."""
    if isinstance(intersect_fn, tuple):
        return intersect_fn
    return intersect_fn, intersect_fn


def _intersect(scene: Scene, rays: Rays, cfg: RenderConfig,
               intersect_fn=None, alive: Optional[Tensor] = None):
    """intersect_fn(scene, rays, alive=None), or brute force when None (the
    brute-force intersector ignores the alive mask; dead lanes are masked
    downstream either way)."""
    if intersect_fn is not None:
        return intersect_fn(scene, rays, alive=alive)
    return _isect.intersect_scene(scene, rays, cfg.t_min, cfg.t_max,
                                  cfg.quirks)


def _morton_scene(scene: Scene):
    """(scene, sphere order, triangle order): the scene with its spheres (by
    center) and triangles (by centroid) permuted into Morton order, each
    when it fills more than one chunk (else its order is None), so that the
    sweeps' chunk boxes are compact (integrators.py:184-203).  Prim ids stay
    in sorted space through the trace and gradients flow back through the
    gathers; on exact-t ties the winner follows Morton order."""
    s_order = t_order = None
    if scene.n_spheres > _sw.PRIM_CHUNK:
        sp = scene.spheres
        s_order = o = _sw.morton_argsort(sp.center)
        scene = scene._replace(spheres=sp._replace(
            center=sp.center[o], radius=sp.radius[o], mat=sp.mat[o]))
    if scene.n_triangles > _sw.PRIM_CHUNK:
        tr = scene.triangles
        t_order = o = _sw.morton_argsort((tr.v0 + tr.v1 + tr.v2) / 3.0)
        scene = scene._replace(triangles=tr._replace(
            v0=tr.v0[o], v1=tr.v1[o], v2=tr.v2[o], normal=tr.normal[o],
            mat=tr.mat[o]))
    return scene, s_order, t_order


def _with_sweep_tables(scene: Scene, fns):
    """The intersectors, those that build sweep tables
    (``render.sweep_intersector``'s ``build_tables``) bound to one set of
    tables of ``scene``, built here once for the whole trace."""
    tables = None
    out = []
    for fn in fns:
        build = getattr(fn, "build_tables", None)
        if build is not None:
            if tables is None:
                tables = build(scene)
            fn = functools.partial(fn, tables=tables)
        out.append(fn)
    return out


def _winners_to_scene(w: Tensor, n_s: int, n_t: int, s_order, t_order):
    """Winner ids recorded on a Morton-permuted scene -> the scene's own
    ids (integrators.py:343-358): sphere and triangle ids go back through
    their permutations; rect and TRS ids and -1 stay."""
    if s_order is not None:
        is_s = (w >= 0) & (w < n_s)
        w = torch.where(is_s, s_order[w.long().clamp(0, n_s - 1)].to(w.dtype),
                        w)
    if t_order is not None:
        is_t = (w >= n_s) & (w < n_s + n_t)
        w = torch.where(is_t, (n_s + t_order[(w.long() - n_s).clamp(
            0, n_t - 1)]).to(w.dtype), w)
    return w


def _follow(ref: Tensor, x: Tensor, hit: Tensor) -> Tensor:
    """On the lanes that hit, ref's value with x's gradient: ref + (x -
    x.detach()); x on the others (a miss lane's record is not finite)."""
    if x.dim() > hit.dim():
        hit = hit[:, None]
    return torch.where(hit, ref + (x - x.detach()), x)


def _replay_ref(ref_tables, winners, step, o, d, cfg, ball, prob):
    """The plain version's bounce on this step's recorded winners, or None
    without winners; made outside the bounce's checkpoint, so that the
    backward's recompute does not make it again."""
    if winners is None:
        return None
    return _mk.replay_reference(ref_tables, o.detach(), d.detach(),
                                winners[step], cfg, ball, prob)


def partition_alive_first(alive: Tensor) -> Tensor:
    """The stable alive-first permutation (megakernel.py:1848 of the JAX
    package): int64[N] order such that x[order] places every alive lane
    before every dead one, each group in its original order.  Two cumsums
    and one scatter, no sort, no host sync."""
    a = alive.to(torch.int64)
    n_alive = a.sum()
    pos = torch.where(alive, torch.cumsum(a, 0) - 1,
                      n_alive + torch.cumsum(1 - a, 0) - 1)
    n = alive.shape[0]
    return torch.empty(n, dtype=torch.int64, device=alive.device).scatter_(
        0, pos, torch.arange(n, device=alive.device))


class _PmeanCotangents(torch.autograd.Function):
    """The identity on the forward pass; on the backward pass the
    cotangents of all its tensors, flattened into one buffer, are averaged
    over the named axes of the mesh, one axis after another
    (``_pmean_cotangent_tree``, integrators.py:87-104 of the JAX package).
    The mesh is any object with ``group(axis)`` (a process group, or None
    for a one-rank axis) and ``axis_size(axis)``, as ``parallel.mesh.Mesh``
    has."""

    @staticmethod
    def forward(ctx, mesh, axes, *xs):
        ctx.mesh, ctx.axes = mesh, axes
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        flat = torch.cat([g.reshape(-1) for g in gs])
        for axis in ctx.axes:
            group = ctx.mesh.group(axis)
            if group is not None:
                dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
            flat = flat / ctx.mesh.axis_size(axis)
        out = [part.view_as(g) for part, g in
               zip(flat.split([g.numel() for g in gs]), gs)]
        return (None, None, *out)


def _sync_scene(scene: Scene, mesh, axes) -> Scene:
    """The scene unchanged, its tensors that require grad routed through
    ``_PmeanCotangents``: this bounce's scene cotangents are averaged over
    ``axes`` in its own backward step (integrators.py:87-104 and :290-292
    of the JAX package), so the gradient all-reduce runs in one bucket a
    bounce.  Linear: the bounces' averaged buckets sum to the average of
    the summed gradient."""
    leaves = _mk._leaves(scene)
    at = [k for k, x in enumerate(leaves) if x.requires_grad]
    if at:
        for k, x in zip(at, _PmeanCotangents.apply(
                mesh, tuple(axes), *[leaves[k] for k in at])):
            leaves[k] = x
    return _mk._rebuild(scene, iter(leaves))


def _bounce(scene, cfg, isect_fn, step, win, ref, o, d, tm,
            throughput, radiance, alive, ball, prob, idx=None, sync=None):
    """One wavefront bounce (integrators.py:236-317): intersect (or replay
    the recorded winners ``win``), shade, scatter; returns the next (o, d,
    time, throughput, radiance, alive) and this bounce's winners (-1 where
    the lane was dead or missed).

    idx: the rays' ids under cfg.wavefront_compact; then the next state
    and idx leave in alive-first order (``partition_alive_first``), the
    index riding in the state under the checkpoint, and the winners are
    not returned.  sync: (mesh, axes) to average the scene's cotangents
    over, or None.

    A replay follows the path the kernel traced: ``ref``, the plain
    version's bounce on the same winners (``_replay_ref``: the scene's
    tables in scene order, the same rays and draws), makes every discrete
    decision (the sphere root, the material's scatter choices) and gives
    the values of the hit point, normal, (u, v) and scattered direction,
    while their gradients come from the differentiable tensor ops."""
    dev = o.device
    with profiling.span("wavefront.bounce", device=dev, step=step):
        if sync is not None:
            scene = _sync_scene(scene, *sync)
        rays = Rays(o, d, tm)
        with profiling.span("wavefront.intersect", device=dev):
            decide = None
            if win is not None:
                hits = _isect.replay_hits(scene, rays, win, cfg.t_min,
                                          cfg.t_max, cfg.quirks, ref.near)
                hits = hits._replace(
                    p=_follow(ref.p, hits.p, hits.hit),
                    normal=_follow(ref.n, hits.normal, hits.hit),
                    u=_follow(ref.uv[0], hits.u, hits.hit),
                    v=_follow(ref.uv[1], hits.v, hits.hit))
                decide = ref.decide
            else:
                hits = _intersect(scene, rays, cfg, isect_fn,
                                  alive=alive if step > 0 else None)
        with profiling.span("wavefront.shade", device=dev):
            dec = hits.dec
            if dec is None:
                dec = _mat.decode_materials(scene.materials, scene.textures,
                                            hits.mat)
            emitted = _mat.emitted(scene.materials, scene.textures, hits.mat,
                                   hits.u, hits.v, hits.p, dec=dec)
            sc = _mat.scatter(scene.materials, scene.textures, hits.mat,
                              rays, hits.p, hits.normal, hits.u, hits.v,
                              ball, prob,
                              cfg.quirks.dielectric_reference_cosine,
                              cfg.quirks.lambertian_zero_uv, dec=dec,
                              decide=decide)
            out_dir = sc.scattered.direction
            if ref is not None:
                out_dir = _follow(ref.direction, out_dir, hits.hit)
            sky = background_sky(d)
            can_recurse = step < cfg.max_depth        # render.h:57 depth > 0
            continues = alive & hits.hit & sc.ok & can_recurse
            absorbed = alive & hits.hit & ~(sc.ok & can_recurse)
            missed = alive & ~hits.hit
            contrib = torch.where((alive & hits.hit)[:, None], emitted, 0.0)
            contrib = contrib + torch.where(absorbed[:, None],
                                            cfg.quirks.ambient_on_absorb, 0.0)
            contrib = contrib + torch.where(missed[:, None], sky, 0.0)
            radiance = radiance + throughput * contrib
            c3 = continues[:, None]
            throughput = torch.where(c3, throughput * sc.attenuation,
                                     throughput)
            nxt = (torch.where(c3, sc.scattered.origin, o),
                   torch.where(c3, out_dir, d),
                   torch.where(continues, sc.scattered.time, tm),
                   throughput, radiance, continues)
            if idx is not None:
                order = partition_alive_first(continues)
                return tuple(x[order] for x in nxt) + (idx[order],)
            return nxt + (torch.where(alive & hits.hit,
                                      hits.prim.to(torch.int32), -1),)


def _draws(cfg: RenderConfig, n: int, dev, samples, seed, generator):
    """step -> that bounce's (ball, prob) draws, in the order of precedence
    of the module docstring.  K2 draws every bounce of the trace in one
    launch here, (max_depth + 1) x n x 16 bytes (37.7 MB for 2^18 rays at
    depth 8); the generator draws one bounce a call, in bounce order."""
    if samples is not None:
        return lambda step: (samples.ball[step], samples.prob[step])
    if cfg.wavefront_tpu_prng:
        draws = _mk.scatter_draws(
            torch.empty(cfg.max_depth + 1, n, 4, device=dev), seed)
        return lambda step: (draws[step, :, :3], draws[step, :, 3])
    return lambda step: _mat.scatter_draws(n, generator, dev)


def _grad_sync(cfg: RenderConfig, mesh):
    """(mesh, axes) for ``_bounce`` when cfg names grad_sync_axes, else
    None; naming them without a mesh raises."""
    if not cfg.grad_sync_axes:
        return None
    if mesh is None:
        raise ValueError(
            f"cfg.grad_sync_axes={cfg.grad_sync_axes} needs the mesh to "
            "average over: pass mesh= (parallel.mesh.make_mesh)")
    return mesh, tuple(cfg.grad_sync_axes)


def trace_path(scene: Scene, rays: Rays, cfg: RenderConfig,
               intersect_fn=None, samples: Optional[SampleStream] = None,
               seed: Optional[int] = None,
               generator: Optional[torch.Generator] = None,
               checkpoint: bool = True, winners: Optional[Tensor] = None,
               return_winners: bool = False, mesh=None):
    """shade() as a wavefront loop -> radiance float32[N, 3]
    (integrators.py:143 of the JAX package).

    Step i is the recursive call at depth max_depth - i; the last step can
    no longer scatter (render.h:57), so after max_depth + 1 steps every lane
    has ended.  samples / seed / generator: the draws (module docstring).
    checkpoint: with gradients on, recompute each bounce in the backward
    instead of storing it (the JAX package always does).

    winners: optional int32[max_depth + 1, N] winner per bounce in the
    scene's Hits.prim ids (-1 for a miss): replay them instead of
    intersecting (``intersect_fn`` is then unused and the scene keeps its
    order).  return_winners: also return the winners this render recorded,
    int32[max_depth + 1, N] in the scene's own ids.

    cfg.wavefront_compact: after each bounce the rays, throughput,
    radiance, alive mask and an index of ray ids are permuted alive first
    (``partition_alive_first``), so dead lanes collect in the tail tiles
    the alive-masked sweeps skip; each bounce's draws are gathered through
    the index (whatever their source, so the feature is a pure
    permutation) and the radiance is scattered back once at the end.
    Replaying and recording runs keep the original order (integrators.py
    :204-211 of the JAX package).

    mesh: the ``parallel.mesh.Mesh`` over whose cfg.grad_sync_axes each
    bounce averages the scene's cotangents (``_sync_scene``); a config
    naming grad_sync_axes needs one."""
    n = rays.origin.shape[0]
    dev = rays.origin.device
    primary_fn, bounce_fn = _split_fns(intersect_fn)
    n_s, n_t = scene.n_spheres, scene.n_triangles
    s_order = t_order = None
    if winners is None and getattr(bounce_fn, "morton_spheres", False):
        scene, s_order, t_order = _morton_scene(scene)
    if winners is None and dev.type == "cuda":
        primary_fn, bounce_fn = _with_sweep_tables(scene,
                                                   (primary_fn, bounce_fn))
    if winners is not None and tuple(winners.shape) != (cfg.max_depth + 1,
                                                        n):
        raise ValueError(f"winners of shape {tuple(winners.shape)} do not "
                         f"fit {cfg.max_depth + 1} steps x {n} rays")
    if samples is None and cfg.wavefront_tpu_prng and seed is None:
        if generator is None:
            raise ValueError("the path integrator needs samples, a seed or "
                             "a generator")
        seed = _mk.draw_seed(generator)
    throughput = torch.ones(n, 3, device=dev)
    radiance = torch.zeros(n, 3, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    o, d, tm = rays
    use_ckpt = checkpoint and torch.is_grad_enabled()
    ref_tables = (_mk.build_mega_tables(scene) if winners is not None
                  else None)
    recorded = []
    draws = _draws(cfg, n, dev, samples, seed, generator)
    compact = (cfg.wavefront_compact and winners is None
               and not return_winners)
    idx = torch.arange(n, device=dev) if compact else None
    sync = _grad_sync(cfg, mesh)
    for step in range(cfg.max_depth + 1):
        ball, prob = draws(step)
        if compact:
            ball, prob = ball[idx], prob[idx]
        body = functools.partial(
            _bounce, scene, cfg, primary_fn if step == 0 else bounce_fn,
            step, winners[step] if winners is not None else None,
            _replay_ref(ref_tables, winners, step, o, d, cfg, ball, prob),
            sync=sync)
        state = (o, d, tm, throughput, radiance, alive, ball, prob)
        if compact:
            state += (idx,)
        if use_ckpt:
            out = _checkpoint(body, *state, use_reentrant=False)
        else:
            out = body(*state)
        if compact:
            o, d, tm, throughput, radiance, alive, idx = out
        else:
            o, d, tm, throughput, radiance, alive, win = out
            recorded.append(win)
    if compact:
        radiance = torch.zeros_like(radiance).index_copy(0, idx, radiance)
    if not return_winners:
        return radiance
    return radiance, _winners_to_scene(torch.stack(recorded), n_s, n_t,
                                       s_order, t_order)


@torch.no_grad()
def replay_misses(scene: Scene, rays: Rays, cfg: RenderConfig,
                  winners: Tensor, samples: Optional[SampleStream] = None,
                  seed: Optional[int] = None) -> Tensor:
    """bool[N]: the rays whose replay of recorded winners (the mega_diff
    backward's ``trace_path(winners=)``, on the same draws) meets, at some
    bounce, a winner that fails its own test on the replayed ray
    (``megakernel.winner_valid``): where the replay's arithmetic and the
    kernel's rounded a decision apart (ROADMAP Queue 3)."""
    missed = torch.zeros(rays.origin.shape[0], dtype=torch.bool,
                         device=rays.origin.device)
    for step, o, d, _ in replay_rays(scene, rays, cfg, winners, samples,
                                     seed):
        missed |= ~_mk.winner_valid(scene, Rays(o, d, rays.time),
                                    winners[step], cfg)
    return missed


@torch.no_grad()
def replay_rays(scene: Scene, rays: Rays, cfg: RenderConfig,
                winners: Tensor, samples: Optional[SampleStream] = None,
                seed: Optional[int] = None):
    """Yield (step, origin, direction, alive) of the replay of recorded
    winners (the mega_diff backward's ``trace_path(winners=)``, on the same
    draws) at the start of each bounce."""
    n = rays.origin.shape[0]
    dev = rays.origin.device
    ref_tables = _mk.build_mega_tables(scene)
    throughput = torch.ones(n, 3, device=dev)
    radiance = torch.zeros(n, 3, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    o, d, tm = rays
    draws = _draws(cfg, n, dev, samples, seed, None)
    for step in range(cfg.max_depth + 1):
        yield step, o, d, alive
        ball, prob = draws(step)
        o, d, tm, throughput, radiance, alive, _ = _bounce(
            scene, cfg, None, step, winners[step],
            _replay_ref(ref_tables, winners, step, o, d, cfg, ball, prob),
            o, d, tm, throughput, radiance, alive, ball, prob)


def lambert_shade(scene: Scene, rays: Rays, cfg: RenderConfig,
                  intersect_fn=None) -> Tensor:
    """LambertShade (render.h:70-87), the reference's active integrator."""
    hits = _intersect(scene, rays, cfg, _split_fns(intersect_fn)[0])
    dec = hits.dec
    if dec is None:
        dec = _mat.decode_materials(scene.materials, scene.textures,
                                    hits.mat)
    emitted = _mat.emitted(scene.materials, scene.textures, hits.mat, hits.u,
                           hits.v, hits.p, dec=dec)
    att = _mat.attenuation(dec, scene.textures, hits.u, hits.v, hits.p,
                           cfg.quirks.lambertian_zero_uv)
    direction = rays.direction if cfg.quirks.lambert_unnormalized_dot \
        else v3.unit_vector(rays.direction)
    t = torch.clamp(v3.dot(direction, hits.normal), min=0.0)  # render.h:80
    sky = background_sky(rays.direction)
    lit = att * t[:, None] * sky * 0.2 + emitted              # render.h:82
    return torch.where(hits.hit[:, None], lit, sky)


def shade_normal(scene: Scene, rays: Rays, cfg: RenderConfig,
                 intersect_fn=None) -> Tensor:
    """shade_normal (render.h:90-103): raw normals as colour."""
    hits = _intersect(scene, rays, cfg, _split_fns(intersect_fn)[0])
    return torch.where(hits.hit[:, None], hits.normal,
                       background_sky(rays.direction))


def integrate(scene: Scene, rays: Rays, cfg: RenderConfig,
              tables: Optional[_mk.MegaTables] = None,
              samples: Optional[SampleStream] = None,
              generator: Optional[torch.Generator] = None,
              seed: Optional[int] = None, intersect_fn=None,
              mesh=None) -> Tensor:
    """Radiance float32[N, 3] of the rays under cfg.integrator and
    cfg.engine, as JAX ``integrate`` routes them (integrators.py:399-441):
    under engine='mega' all three integrators go to the fused kernel (image
    scenes too, in kernel mode K9; normal reads no texture); under
    engine='mega_diff' the path goes to ``trace_path_mega_diff`` and
    lambert and normal to the wavefront.  engine='mega' goes through
    ``megakernel.select_mega`` (the compaction drivers, as JAX routes).  A
    scene the fused engine does not serve (above MAX_STREAM_PRIMS spheres
    or triangles) renders on the wavefront under either fused engine, as
    in JAX, and ``tables`` is dropped there; the wavefront launches its own
    kernels on CUDA rays.  mesh: the mesh of cfg.grad_sync_axes (the
    path integrator's bounces average the scene's cotangents over it;
    lambert and normal have no bounces to bucket, as in JAX)."""
    check_supported(cfg)
    _grad_sync(cfg, mesh)
    fused = cfg.engine in ("mega", "mega_diff")
    if fused and not _mk.megakernel_supported(scene):
        fused, tables = False, None
    if fused and cfg.engine == "mega_diff" and cfg.integrator == "path":
        return _mk.trace_path_mega_diff(scene, rays, cfg, tables=tables,
                                        samples=samples, generator=generator,
                                        seed=seed, mesh=mesh)
    if fused and cfg.engine == "mega":
        return _mk.select_mega(scene, rays, cfg, tables=tables,
                               samples=samples, generator=generator,
                               seed=seed)
    # the wavefront; also lambert and normal under mega_diff, which pairs
    # only the path integrator with a replay backward (integrators.py:404)
    if cfg.integrator == "path":
        return trace_path(scene, rays, cfg, intersect_fn, samples, seed,
                          generator, mesh=mesh)
    fn = lambert_shade if cfg.integrator == "lambert" else shade_normal
    return fn(scene, rays, cfg, intersect_fn)
