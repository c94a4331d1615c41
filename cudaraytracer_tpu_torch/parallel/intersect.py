"""The primitive-sharded closest hit (the JAX package's
``parallel/intersect.py``).

Each 'tp' member holds a contiguous shard of the sphere and triangle
tables (``render.shard_scene``: padding rows duplicate row 0 and are masked
by their global index); rects and runtime-TRS tables are replicated and
only tp member 0 tests them.  Each member finds its local closest hit,
then the members combine:

    t_min  = all_reduce MIN of the local t              the nearest hit
    winner = all_reduce MIN of the global id where t == t_min
                                                        first prim wins
                                                        (hitable_list.h:84)
    record = all_reduce SUM of the winner's masked record (p, normal, u,
             v, mat), so every member returns the same Hits

Departure from JAX, which tests its shard by brute force ([N, M]
candidates): the local pass runs the port's closest hit on the shard, the
sweep kernels K3 and K4 on CUDA rays and their plain versions on the CPU
(``sweeps.sphere_best_hit``, ``triangle_best_hit``), and brute force for
the rects and runtime-TRS prims.  At 128,000 triangles the candidates
would be a 2^18 x 64,000 matrix per shard.

The shards keep builder order (the tp intersector sets no
``morton_spheres``), so the first-prim tie-break is global.  Gradients
follow the winner on the winning rank only: the record's SUM passes its
cotangent back unchanged (every member shades the same record), masked to
the winner's lanes, into the sweeps' autograd Functions.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from ..config import Quirks, RenderConfig, check_supported
from ..core.rays import Rays
from ..models.scene import Scene
from ..ops import intersect as _isect
from ..ops import sweeps as _sw
from ..ops.sweeps import BIG, _f32
from .mesh import Mesh, all_reduce

Tensor = torch.Tensor
IDX_MISS = 2 ** 31 - 1


class Shard(NamedTuple):
    """Where this member's sphere and triangle rows sit in the scene."""

    sphere_offset: int
    tri_offset: int
    n_spheres_global: int
    n_triangles_global: int


class _SumRecord(torch.autograd.Function):
    """all_reduce SUM over the group on the forward; on the backward the
    cotangent passes unchanged, since each member shades the same record
    downstream."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _global_ids(best_idx: Tensor, n_s: int, n_t: int, shard: Shard) -> Tensor:
    """Local typed ids ([spheres | triangles | replicated classes] of the
    shard) -> global prim ids, IDX_MISS for a miss or a padding row."""
    s_g, t_g = shard.n_spheres_global, shard.n_triangles_global
    is_s = (best_idx >= 0) & (best_idx < n_s)
    is_t = (best_idx >= n_s) & (best_idx < n_s + n_t)
    is_x = best_idx >= n_s + n_t
    g_s = best_idx + shard.sphere_offset
    g_t = best_idx - n_s + shard.tri_offset
    g_x = best_idx - n_s - n_t + s_g + t_g
    miss = torch.full_like(best_idx, IDX_MISS)
    out = torch.where(is_x, g_x, miss)
    out = torch.where(is_t & (g_t < t_g), g_t + s_g, out)
    return torch.where(is_s & (g_s < s_g), g_s, out)


def intersect_scene_tp(scene_local: Scene, rays: Rays, mesh: Mesh,
                       shard: Shard, t_min: float = 1e-3, t_max: float = BIG,
                       quirks: Quirks = Quirks(), coherent: bool = False,
                       alive: Optional[Tensor] = None,
                       sphere_cull: str = "primary",
                       tables: Optional[_sw.SweepTables] = None
                       ) -> _isect.Hits:
    """Closest hit over the whole (sharded) scene, called by every member
    of this rank's tp group on the same rays (intersect.py:35).

    scene_local: the scene with this member's sphere and triangle shards;
    coherent / sphere_cull: the sphere sweep's cull policy, as
    ``intersect_scene_sweeps`` ('morton' culls every sweep, in builder
    order); alive: a dead lane misses in the sweeps; tables: the shard's
    ``intersect.sweep_tables``."""
    n = rays.origin.shape[0]
    dev = rays.origin.device
    n_s, n_t = scene_local.n_spheres, scene_local.n_triangles
    cull = sphere_cull in ("all", "morton") or (sphere_cull != "off"
                                                and coherent)
    if tables is None:
        tables = _sw.SweepTables(None, None, None)
    best_t = torch.full((n,), BIG, device=dev)
    best_idx = torch.full((n,), -1, dtype=torch.int32, device=dev)
    if n_s:
        sp = scene_local.spheres
        st, si = _sw.sphere_best_hit(rays.origin, rays.direction, sp.center,
                                     sp.radius, t_min, t_max, cull, alive,
                                     tables.sph)
        take = ((si >= 0) & (si + shard.sphere_offset
                             < shard.n_spheres_global) & (st < best_t))
        best_t = torch.where(take, st, best_t)
        best_idx = torch.where(take, si, best_idx)
    if n_t:
        tr = scene_local.triangles
        tt, ti = _sw.triangle_best_hit(rays.origin, rays.direction, tr.v0,
                                       tr.v1, tr.v2, tr.normal, t_min, t_max,
                                       quirks, alive, tables.tri)
        take = ((ti >= 0) & (ti + shard.tri_offset
                             < shard.n_triangles_global) & (tt < best_t))
        best_t = torch.where(take, tt, best_t)
        best_idx = torch.where(take, ti + n_s, best_idx)
    n_x = (scene_local.n_rects + scene_local.n_t_spheres
           + scene_local.n_t_triangles)
    if n_x and mesh.tp_index == 0:
        best_t, best_idx = _isect._reduce_x_tables(
            scene_local, rays, (best_t, best_idx), _f32(t_min), _f32(t_max),
            quirks)
    gidx = _global_ids(best_idx, n_s, n_t, shard)
    best_t = torch.where(gidx == IDX_MISS, BIG, best_t)

    group = mesh.tp_group
    t_glob = all_reduce(best_t, dist.ReduceOp.MIN, group)
    gidx_glob = all_reduce(torch.where(best_t == t_glob, gidx, IDX_MISS),
                           dist.ReduceOp.MIN, group)
    hit = gidx_glob != IDX_MISS
    win = hit & (gidx == gidx_glob)
    local = _isect.finalize_hits(scene_local, rays, best_t,
                                 torch.where(win, best_idx, -1), t_min,
                                 t_max, quirks)
    rec = torch.cat([local.p, local.normal, local.u[:, None],
                     local.v[:, None], local.mat.to(torch.float32)[:, None]],
                    1)
    rec = _SumRecord.apply(torch.where(win[:, None], rec, 0.0), group)
    return _isect.Hits(hit, torch.where(hit, t_glob, BIG), rec[:, 0:3],
                       rec[:, 3:6], rec[:, 6], rec[:, 7],
                       rec[:, 8].to(torch.int32),
                       torch.where(hit, gidx_glob, -1))


def tp_intersector(cfg: RenderConfig, mesh: Mesh, shard: Shard,
                   coherent: bool = False):
    """intersect_fn(scene_local, rays, alive=None, tables=None) through
    ``intersect_scene_tp`` under cfg's quirks, window and sphere cull; its
    ``build_tables`` builds the shard's sweep tables once per trace."""
    check_supported(cfg)

    def fn(scene, rays, alive=None, tables=None):
        return intersect_scene_tp(scene, rays, mesh, shard, cfg.t_min,
                                  cfg.t_max, cfg.quirks, coherent, alive,
                                  cfg.wavefront_sphere_cull, tables)

    fn.build_tables = functools.partial(_isect.sweep_tables)
    return fn


def tp_intersector_pair(cfg: RenderConfig, mesh: Mesh, shard: Shard):
    """(primary_fn, bounce_fn): the coherent camera pass and the bounces."""
    return (tp_intersector(cfg, mesh, shard, coherent=True),
            tp_intersector(cfg, mesh, shard, coherent=False))
