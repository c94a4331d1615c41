"""Closest hit over a scene's spheres and triangles, as differentiable
tensor ops (the JAX package's ``ops/intersect.py``).

Three ways to find the winner, one way to build its hit record:
  * ``intersect_scene``: brute force over (rays x prims) candidate matrices
    in chunks of prims, differentiated by autograd through the winner's
    candidate (``--accel bruteforce``, and the oracle in the tests);
  * ``intersect_scene_sweeps``: the sphere sweep (K3, or K5 for pure-sphere
    scenes under ``wavefront_kernel_attrs``) then the triangle sweep (K4)
    of ``ops/sweeps.py``, whose autograd Functions recompute only the
    winner in the backward (the counterpart of ``intersect_scene_pallas``);
  * ``intersect_scene_bvh``: the triangles through a FlatBVH (the
    traversal kernel of ``ops/bvh.py``), the other prims by brute force
    (``--accel bvh``, apps/animate.py's BVH pipelines);
  * ``finalize_hits`` rebuilds the winner's record (point, normal, u, v,
    material) from its id.

Differentiability follows the detached-discrete / attached-continuous
estimator: the argmin is piecewise constant; t, p, normal and the material
fields flow.  Every division or root that a masked-out lane could reach is
double-where guarded, so a zero cotangent never meets an inf.

Rects and runtime-TRS prims (``rect_candidates``,
``t_sphere_candidates``, ``t_triangle_candidates``) are tested on the ray
TransformRay'd into object space (``models/transform.py``), in tensor ops in
both intersectors.  Their t is tested in the native parameterization (a
distance along the unit object-space direction) and then divided by
|raw direction| for the closest-hit comparison, so it is commensurable with
sphere and triangle t along the unnormalized world direction.  Global prim
ids run over [spheres | triangles | rects | t_spheres | t_triangles].

``replay_hits`` builds the record of a winner decided in advance (the
replay backward of ``engine='mega_diff'``).

Dropped from the JAX package: the decode-column fold of the TPU's
consolidated form (``FOLD_DEC`` / ``CONSOLIDATE``).  The port decodes
materials by one row gather everywhere, and takes the attribute-carrying
sweep whenever ``wavefront_kernel_attrs`` is set on a pure-sphere scene, on
any device.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..config import Quirks
from ..core import vec as v3
from ..core.rays import Rays
from ..models import materials as _mat
from ..models import transform as _tf
from ..models.scene import Scene
from ..models.transform import TRS
from . import bvh as _bvh
from . import sweeps as _sw
from .sweeps import BIG, TRI_EPSILON, _f32

Tensor = torch.Tensor


class Hits(NamedTuple):
    """Batched HitRecord (hitable.h:11-18)."""

    hit: Tensor     # bool[N]
    t: Tensor       # float32[N]
    p: Tensor       # float32[N, 3]
    normal: Tensor  # float32[N, 3]
    u: Tensor       # float32[N]
    v: Tensor       # float32[N]
    mat: Tensor     # int32[N]
    prim: Tensor    # int32[N] global prim id (spheres, then triangles)
    # the winner's decoded material rows when the sweep carried them (K5);
    # None -> the integrator decodes from ``mat``
    dec: Optional[_mat.DecodedMaterials] = None


# ---------------------------------------------------------------------------
# Brute force
# ---------------------------------------------------------------------------

def sphere_candidates(origin: Tensor, direction: Tensor, center: Tensor,
                      radius: Tensor, t_min: float, t_max: float):
    """sphere.h:27-55, nearest in-range root -> (valid bool[N, C],
    t float32[N, C])."""
    oc = origin[:, None, :] - center[None, :, :]
    d = direction[:, None, :]
    a = (d * d).sum(-1)
    b = (oc * d).sum(-1)
    c = (oc * oc).sum(-1) - radius[None, :] ** 2
    disc = b * b - a * c
    # double-where: d(sqrt)/d(disc) stays finite for misses
    disc_safe = torch.where(disc > 0.0, disc, 1.0)
    sq = torch.where(disc > 0.0, torch.sqrt(disc_safe), 0.0)
    t0 = (-b - sq) / a
    t1 = (-b + sq) / a
    ok0 = (disc > 0.0) & (t0 < t_max) & (t0 > t_min)
    ok1 = (disc > 0.0) & (t1 < t_max) & (t1 > t_min)
    return ok0 | ok1, torch.where(ok0, t0, torch.where(ok1, t1, BIG))


def triangle_candidates(origin: Tensor, direction: Tensor, v0: Tensor,
                        v1: Tensor, v2: Tensor, face_normal: Tensor,
                        t_min: float, t_max: float, quirks: Quirks):
    """triangle.h:57-100, Moller-Trumbore with the reference's quirks ->
    (valid, t, u, v), each [N, C]."""
    d = direction[:, None, :]
    e1 = (v1 - v0)[None]
    e2 = (v2 - v0)[None]
    h = v3.cross(d, e2)
    a = (e1 * h).sum(-1)
    # double-where the 1/a: rejected near-zero determinants would leak inf
    eps_ok = a.abs() >= TRI_EPSILON
    f = 1.0 / torch.where(eps_ok, a, 1.0)
    s = origin[:, None, :] - v0[None]
    u = f * (s * h).sum(-1)
    q = v3.cross(s, e1)
    v = f * (d * q).sum(-1)
    t = f * (e2 * q).sum(-1)
    valid = eps_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
    if quirks.triangle_back_culling:
        valid &= a >= TRI_EPSILON
    if quirks.triangle_backface_only:
        valid &= (d * face_normal[None]).sum(-1) >= 0.0
    if quirks.triangle_no_t_clip:
        valid &= t < t_max       # hitable_list.h:84 only
    else:
        valid &= (t > t_min) & (t < t_max)
    return valid, torch.where(valid, t, BIG), u, v


# ---------------------------------------------------------------------------
# Rects and runtime-TRS prims (tested through TransformRay)
# ---------------------------------------------------------------------------

def _rows3x3(R: Tensor) -> list:
    """The 9 components of float32[..., 3, 3] row-major matrices."""
    return [R[..., i, j] for i in range(3) for j in range(3)]


def _transform_rays_nc(rays: Rays, trs: TRS):
    """TransformRay of every ray against every prim (intersect.py:187) ->
    (object-space origin, unit direction) as 3-lists of [N, C] and
    |raw direction| float32[N, 1]."""
    m = [x[None] for x in _rows3x3(
        v3.rotation_matrix_euler_deg(trs.rotation))]
    o = [rays.origin[:, k:k + 1] for k in range(3)]
    d = [rays.direction[:, k:k + 1] for k in range(3)]
    xo, xd = _tf.transform_arrays(o, d,
                                  [trs.position[None, :, k] for k in range(3)],
                                  [trs.scale[None, :, k] for k in range(3)],
                                  m)
    return list(xo), list(xd), _raw_len(rays.direction)[:, None]


def _t_cmp(valid: Tensor, t_native: Tensor, raw_len: Tensor) -> Tensor:
    """Native t over |raw d| where valid, else BIG; double-where'd, since an
    invalid lane's t (BIG, or huge) over |d| < 1 overflows and the quotient
    rule's backward would meet 0 * inf."""
    return torch.where(valid, torch.where(valid, t_native, 0.0) / raw_len,
                       BIG)


def _raw_len(d: Tensor) -> Tensor:
    return torch.sqrt(_sw._dot(d, d))


def rect_candidates(rays: Rays, rects, t_min: float, t_max: float):
    """rectangle.h:22-44 through TransformRay (intersect.py:138): the unit
    rect on the object z = 0 plane, facing +z (-z when flipped) ->
    (valid, t, u, v) [N, C], p [N, C, 3] (the OBJECT-space hit point: the
    reference never maps rec.p back, so it is also the scattered origin
    and the checker point) and normal [N, C, 3] (rotated, hitable.h:36).

    t is tested in the native parameterization (rectangle.h:32, the window
    inclusive) and returned divided by |raw d| (BIG where invalid).  The
    plane division is double-where'd: an edge-on ray never hits, but an
    unguarded inf would NaN the backward."""
    trs = rects.trs
    (ox, oy, oz), (dx, dy, dz), raw_len = _transform_rays_nc(rays, trs)
    sgn = torch.where(rects.flip, -1.0, 1.0)[None]
    facing = dz * sgn
    dz_ok = dz != 0.0
    t = -oz / torch.where(dz_ok, dz, 1.0)
    x = ox + t * dx
    y = oy + t * dy
    valid = (dz_ok & (facing <= 0.0) & (t >= t_min) & (t <= t_max)
             & (x >= -0.5) & (x <= 0.5) & (y >= -0.5) & (y <= 0.5))
    p = torch.stack([x, y, oz + t * dz], dim=-1)
    R = v3.rotation_matrix_euler_deg(trs.rotation)
    normal = (R[:, :, 2] * sgn[0, :, None])[None].expand(p.shape)
    return (valid, _t_cmp(valid, t, raw_len), x + 0.5, y + 0.5, p, normal)


def t_sphere_candidates(rays: Rays, tsph, t_min: float, t_max: float):
    """Runtime-TRS spheres (intersect.py:204): sphere.h:27-55 on the
    TransformRay'd ray against the origin-centred object-space sphere ->
    (valid, t) [N, C], p [N, C, 3] (object space) and normal [N, C, 3]
    (p / r rotated).  The t window applies to the native t."""
    (ox, oy, oz), (dx, dy, dz), raw_len = _transform_rays_nc(rays, tsph.trs)
    r = tsph.radius[None]
    b = ox * dx + oy * dy + oz * dz
    a = dx * dx + dy * dy + dz * dz
    c = ox * ox + oy * oy + oz * oz - r * r
    disc = b * b - a * c
    disc_safe = torch.where(disc > 0.0, disc, 1.0)
    sq = torch.where(disc > 0.0, torch.sqrt(disc_safe), 0.0)
    t0 = (-b - sq) / a
    t1 = (-b + sq) / a
    ok0 = (disc > 0.0) & (t0 < t_max) & (t0 > t_min)
    ok1 = (disc > 0.0) & (t1 < t_max) & (t1 > t_min)
    t = torch.where(ok0, t0, torch.where(ok1, t1, BIG))
    valid = ok0 | ok1
    # p at t = BIG overflows, and 0 * inf would NaN the backward: take the
    # point at t = 0 on the lanes that miss
    t_p = torch.where(valid, t, 0.0)
    px, py, pz = ox + t_p * dx, oy + t_p * dy, oz + t_p * dz
    m = [x[None] for x in _rows3x3(
        v3.rotation_matrix_euler_deg(tsph.trs.rotation))]
    normal = torch.stack(_tf.rotate_rows(m, px / r, py / r, pz / r), -1)
    return (valid, _t_cmp(valid, t, raw_len), torch.stack([px, py, pz], -1),
            normal)


def t_triangle_candidates(rays: Rays, ttri, t_min: float, t_max: float,
                          quirks: Quirks):
    """Runtime-TRS triangles (intersect.py:238): Moller-Trumbore on the
    TransformRay'd ray against object-space vertices, with the quirk gates
    on the TRANSFORMED direction against the object normal -> (valid, t, u,
    v) [N, C], p [N, C, 3] (object space), normal [N, C, 3] (rotated)."""
    (ox, oy, oz), (dx, dy, dz), raw_len = _transform_rays_nc(rays, ttri.trs)
    v0 = ttri.v0
    e1, e2 = ttri.v1 - v0, ttri.v2 - v0
    e1x, e1y, e1z = (e1[None, :, k] for k in range(3))
    e2x, e2y, e2z = (e2[None, :, k] for k in range(3))
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    eps_ok = a.abs() >= TRI_EPSILON
    f = 1.0 / torch.where(eps_ok, a, 1.0)
    sx, sy, sz = ox - v0[None, :, 0], oy - v0[None, :, 1], oz - v0[None, :, 2]
    u = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    valid = eps_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
    if quirks.triangle_back_culling:
        valid &= a >= TRI_EPSILON
    if quirks.triangle_backface_only:
        n = ttri.normal
        valid &= (dx * n[None, :, 0] + dy * n[None, :, 1]
                  + dz * n[None, :, 2]) >= 0.0
    if quirks.triangle_no_t_clip:
        valid &= t < t_max
    else:
        valid &= (t > t_min) & (t < t_max)
    p = torch.stack([ox + t * dx, oy + t * dy, oz + t * dz], -1)
    m = _rows3x3(v3.rotation_matrix_euler_deg(ttri.trs.rotation))
    n = ttri.normal
    normal = torch.stack(_tf.rotate_rows(m, n[:, 0], n[:, 1], n[:, 2]),
                         -1)[None].expand(p.shape)
    return valid, _t_cmp(valid, t, raw_len), u, v, p, normal


def _reduce_x_tables(scene: Scene, rays: Rays, best, t_min, t_max,
                     quirks: Quirks, prim_chunk: int = 1024):
    """Fold rects, then runtime-TRS spheres, then runtime-TRS triangles into
    the running (best_t, best_idx) (intersect.py:278, :363), each in chunks
    of ``prim_chunk`` prims; ids continue [spheres | triangles | rects |
    t_spheres | t_triangles]."""
    base = scene.n_spheres + scene.n_triangles
    tables = ((scene.n_rects, scene.rects,
               lambda x: rect_candidates(rays, x, t_min, t_max)),
              (scene.n_t_spheres, scene.t_spheres,
               lambda x: t_sphere_candidates(rays, x, t_min, t_max)),
              (scene.n_t_triangles, scene.t_triangles,
               lambda x: t_triangle_candidates(rays, x, t_min, t_max,
                                               quirks)))
    for count, table, cand in tables:
        for lo in range(0, count, prim_chunk):
            part = _slice_record(table, lo, min(count, lo + prim_chunk))
            out = cand(part)
            best = _reduce_best(best, out[1], out[0], base + lo)
        base += count
    return best


def _slice_record(record, lo: int, hi: int):
    """Rows lo:hi of every tensor of a prim record (nested TRS too)."""
    return type(record)(*(_slice_record(x, lo, hi)
                          if isinstance(x, tuple) else x[lo:hi]
                          for x in record))


def _reduce_best(best, cand_t: Tensor, cand_valid: Tensor, base: int):
    """Keep the smaller-t candidate; the first occurrence wins ties
    (hitable_list.h:84 strictly-less scan order)."""
    best_t, best_idx = best
    c = torch.argmin(cand_t, dim=1)
    rows = torch.arange(cand_t.shape[0], device=cand_t.device)
    ct = cand_t[rows, c]
    take = cand_valid[rows, c] & (ct < best_t)
    return (torch.where(take, ct, best_t),
            torch.where(take, (c + base).to(torch.int32), best_idx))


def intersect_scene(scene: Scene, rays: Rays, t_min: float = 1e-3,
                    t_max: float = BIG, quirks: Quirks = Quirks(),
                    prim_chunk: int = 1024) -> Hits:
    """Brute-force closest hit over all prims (hitable_list.h:76-91), in
    chunks of ``prim_chunk`` prims."""
    n = rays.origin.shape[0]
    dev = rays.origin.device
    t_min, t_max = _f32(t_min), _f32(t_max)
    best = (torch.full((n,), BIG, device=dev),
            torch.full((n,), -1, dtype=torch.int32, device=dev))
    n_s, n_t = scene.n_spheres, scene.n_triangles
    sp, tr = scene.spheres, scene.triangles
    for lo in range(0, n_s, prim_chunk):
        hi = min(n_s, lo + prim_chunk)
        valid, t = sphere_candidates(rays.origin, rays.direction,
                                     sp.center[lo:hi], sp.radius[lo:hi],
                                     t_min, t_max)
        best = _reduce_best(best, t, valid, lo)
    for lo in range(0, n_t, prim_chunk):
        hi = min(n_t, lo + prim_chunk)
        valid, t, _, _ = triangle_candidates(
            rays.origin, rays.direction, tr.v0[lo:hi], tr.v1[lo:hi],
            tr.v2[lo:hi], tr.normal[lo:hi], t_min, t_max, quirks)
        best = _reduce_best(best, t, valid, n_s + lo)
    best = _reduce_x_tables(scene, rays, best, t_min, t_max, quirks,
                            prim_chunk)
    return finalize_hits(scene, rays, best[0], best[1], t_min, t_max, quirks)


# ---------------------------------------------------------------------------
# BVH (the triangles through crt_bvh_traverse)
# ---------------------------------------------------------------------------

def intersect_scene_bvh(scene: Scene, rays: Rays, bvh, t_min: float = 1e-3,
                        t_max: float = BIG, quirks: Quirks = Quirks(),
                        tri_override=None, alive: Optional[Tensor] = None,
                        prim_chunk: int = 1024) -> Hits:
    """Closest hit with a FlatBVH (``ops/bvh.py``) over the triangles
    (intersect.py:375 of the JAX package: the reference's active pipeline,
    a BVH over the FBX mesh, kernel.cu:97): the spheres by brute force,
    then the triangles through ``bvh_best_hit`` (the BVH's winner takes a
    ray only when strictly nearer, so a sphere keeps a tie), then the rects
    and runtime-TRS prims by brute force, then finalize_hits.
    tri_override: (v0, v1, v2, normal) in place of the scene's triangles
    (the BVH's prim ids index them); alive: a dead lane is a miss."""
    n = rays.origin.shape[0]
    dev = rays.origin.device
    t_min_f, t_max_f = _f32(t_min), _f32(t_max)
    best = (torch.full((n,), BIG, device=dev),
            torch.full((n,), -1, dtype=torch.int32, device=dev))
    n_s, n_t = scene.n_spheres, scene.n_triangles
    if tri_override is not None:
        scene = scene.with_triangle_vertices(*tri_override)
    sp, tr = scene.spheres, scene.triangles
    for lo in range(0, n_s, prim_chunk):
        hi = min(n_s, lo + prim_chunk)
        valid, t = sphere_candidates(rays.origin, rays.direction,
                                     sp.center[lo:hi], sp.radius[lo:hi],
                                     t_min_f, t_max_f)
        best = _reduce_best(best, t, valid, lo)
    best_t, best_idx = best
    if n_t:
        bt, bp = _bvh.bvh_best_hit(bvh, tr.v0, tr.v1, tr.v2, tr.normal, rays,
                                   t_min, t_max, quirks, alive=alive)
        take = (bp >= 0) & (bt < best_t)
        best_t = torch.where(take, bt, best_t)
        best_idx = torch.where(take, bp + n_s, best_idx)
    best_t, best_idx = _reduce_x_tables(scene, rays, (best_t, best_idx),
                                        t_min_f, t_max_f, quirks, prim_chunk)
    if alive is not None:
        best_t = torch.where(alive, best_t, BIG)
        best_idx = torch.where(alive, best_idx, -1)
    return finalize_hits(scene, rays, best_t, best_idx, t_min, t_max, quirks)


# ---------------------------------------------------------------------------
# Sweeps (kernels K3, K4, K5)
# ---------------------------------------------------------------------------

def intersect_scene_sweeps(scene: Scene, rays: Rays, t_min: float = 1e-3,
                           t_max: float = BIG, quirks: Quirks = Quirks(),
                           coherent: bool = False,
                           alive: Optional[Tensor] = None,
                           sphere_cull: str = "primary",
                           kernel_attrs: bool = False,
                           tables: Optional[_sw.SweepTables] = None) -> Hits:
    """Closest hit through the sweeps (intersect.py:425 of the JAX package):
    the sphere sweep, then the triangle sweep with ids offset by the sphere
    count (a triangle wins only when strictly nearer), then finalize_hits.

    sphere_cull: 'all' culls every sphere sweep by chunk boxes (the trace
    permutes spheres into Morton order first), 'primary' only coherent
    (camera) sweeps, 'off' none.  Triangle sweeps cull from 128 triangles
    up.  alive: optional mask; a dead lane returns a miss.  kernel_attrs: on
    a pure-sphere scene, K5 carries the winner's record row out.  tables:
    the scene's ``sweep_tables`` (built once per trace), else each sweep
    builds its own."""
    n_s, n_t = scene.n_spheres, scene.n_triangles
    n_x = scene.n_rects + scene.n_t_spheres + scene.n_t_triangles
    cull = sphere_cull == "all" or (sphere_cull != "off" and coherent)
    if tables is None:
        tables = _sw.SweepTables(None, None, None)
    if n_s and not n_t and not n_x and kernel_attrs:
        return _sphere_attrs_hits(scene, rays, t_min, t_max, cull, alive,
                                  tables)
    n = rays.origin.shape[0]
    dev = rays.origin.device
    best_t = torch.full((n,), BIG, device=dev)
    best_idx = torch.full((n,), -1, dtype=torch.int32, device=dev)
    if n_s:
        sp = scene.spheres
        st, si = _sw.sphere_best_hit(rays.origin, rays.direction, sp.center,
                                     sp.radius, t_min, t_max, cull, alive,
                                     tables.sph)
        take = (si >= 0) & (st < best_t)
        best_t = torch.where(take, st, best_t)
        best_idx = torch.where(take, si, best_idx)
    if n_t:
        tr = scene.triangles
        tt, ti = _sw.triangle_best_hit(rays.origin, rays.direction, tr.v0,
                                       tr.v1, tr.v2, tr.normal, t_min, t_max,
                                       quirks, alive, tables.tri)
        take = (ti >= 0) & (tt < best_t)
        best_t = torch.where(take, tt, best_t)
        best_idx = torch.where(take, ti + n_s, best_idx)
    if n_x:
        best_t, best_idx = _reduce_x_tables(scene, rays, (best_t, best_idx),
                                            _f32(t_min), _f32(t_max), quirks)
    return finalize_hits(scene, rays, best_t, best_idx, t_min, t_max, quirks)


def sphere_attr_table(scene: Scene) -> Tensor:
    """float32[21, S]: center(3), radius, mat, the 16 decode columns of each
    sphere's material (the K5 attribute contract)."""
    sp = scene.spheres
    dec = _mat.decode_table(scene.materials, scene.textures)
    return torch.cat([sp.center.t(), sp.radius[None],
                      sp.mat.to(torch.float32)[None],
                      dec[sp.mat.long()].t()], dim=0)


def sweep_tables(scene: Scene, attrs: bool = False) -> _sw.SweepTables:
    """The scene's sweep tables from detached tensors, built once for a
    trace (``integrators.trace_path`` on CUDA rays): the spheres' and
    triangles' tables with their chunk and super boxes, and with ``attrs``
    on a pure-sphere scene K5's attribute rows."""
    sp, tr = scene.spheres, scene.triangles
    sph = (_sw.sphere_table(sp.center.detach(), sp.radius.detach())
           if scene.n_spheres else None)
    tri = (_sw.triangle_table(tr.v0.detach(), tr.v1.detach(),
                              tr.v2.detach(), tr.normal.detach())
           if scene.n_triangles else None)
    pure = scene.n_spheres and not (scene.n_triangles + scene.n_rects
                                    + scene.n_t_spheres
                                    + scene.n_t_triangles)
    rows = (_sw.attr_rows(sphere_attr_table(scene)) if attrs and pure
            else None)
    return _sw.SweepTables(sph, tri, rows)


def _sphere_attrs_hits(scene: Scene, rays: Rays, t_min, t_max, cull: bool,
                       alive: Optional[Tensor],
                       tables: _sw.SweepTables) -> Hits:
    """Pure-sphere hit records through K5 (intersect.py:522): the kernel
    returns each winner's attribute row, so the record and its decoded
    material build without a gather.  Same values as the finalize_hits
    path."""
    sp = scene.spheres
    st, si, attrs = _sw.sphere_best_hit_attrs(
        rays.origin, rays.direction, sp.center, sp.radius,
        sphere_attr_table(scene), t_min, t_max, cull, alive, tables.sph,
        tables.sph_attr)
    hit = si >= 0
    t = torch.where(hit, st, BIG)
    p = rays.point_at(t)
    s_norm, s_u, s_v = _sphere_record(p, hit, attrs[:, 0:3], attrs[:, 3])
    return Hits(hit, t, p, torch.where(hit[:, None], s_norm, 0.0),
                torch.where(hit, s_u, 0.0), torch.where(hit, s_v, 0.0),
                torch.where(hit, attrs[:, 4].to(torch.int32), 0), si,
                _mat.decoded_from_rows(attrs[:, 5:5 + _mat.DEC_COLS]))


# ---------------------------------------------------------------------------
# Hit records
# ---------------------------------------------------------------------------

def _safe_arcsin(z: Tensor) -> Tensor:
    """arcsin(clip(z, -1, 1)) with finite gradients everywhere (the bare
    composition is 0 * inf = NaN at |z| >= 1); the gradient at the poles is
    defined as 0 (intersect.py:991)."""
    zc = torch.clamp(z, -1.0, 1.0)
    interior = zc.abs() < 1.0
    inner = torch.where(interior, zc, 0.0)
    return torch.where(interior, torch.asin(inner),
                       torch.sign(zc) * (math.pi / 2.0))


def _sphere_record(p: Tensor, mask: Tensor, center: Tensor,
                   radius_raw: Tensor):
    """(normal, u, v) of sphere winners (intersect.py:555).  Non-mask lanes
    pair p (possibly inf at t = BIG) with another prim's row: the inputs
    are double-where'd so the masked 1/r stays finite.  u, v:
    get_sphere_uv (texture.h:45-50) on the unit normal."""
    p_in = torch.where(mask[..., None], p, center)
    radius = torch.where(mask, radius_raw, 1.0)
    s_norm = (p_in - center) / radius[..., None]
    phi = torch.atan2(s_norm[..., 2], s_norm[..., 0])
    theta = _safe_arcsin(s_norm[..., 2])
    u = 1.0 - (phi + math.pi) / (2.0 * math.pi)
    v = (theta + math.pi / 2.0) / math.pi
    return s_norm, u, v


def _tri_single(rays: Rays, v0: Tensor, v1: Tensor, v2: Tensor):
    """(t, u, v) of one already-chosen triangle per ray.  Non-winner lanes
    pair with a clipped index whose determinant may be 0: double-where
    keeps them finite (intersect.py:1004)."""
    d = rays.direction
    e1 = v1 - v0
    e2 = v2 - v0
    h = v3.cross(d, e2)
    a = _sw._dot(e1, h)
    f = 1.0 / torch.where(a.abs() >= TRI_EPSILON, a, 1.0)
    s = rays.origin - v0
    u = f * _sw._dot(s, h)
    q = v3.cross(s, e1)
    v = f * _sw._dot(d, q)
    t = f * _sw._dot(e2, q)
    return t, u, v


def _prim_rows(scene: Scene):
    """(float32 geometry rows, int32 material ids) over [spheres |
    triangles]: sphere rows center(3), radius, pad; triangle rows v0, v1,
    v2, normal (intersect.py:584, the split form)."""
    n_s, n_t = scene.n_spheres, scene.n_triangles
    width = 12 if n_t else 4
    blocks, mats = [], []
    if n_s:
        sp = scene.spheres
        blocks.append(torch.cat([sp.center, sp.radius[:, None],
                                 sp.center.new_zeros(n_s, width - 4)], 1))
        mats.append(sp.mat)
    if n_t:
        tr = scene.triangles
        blocks.append(torch.cat([tr.v0, tr.v1, tr.v2, tr.normal], 1))
        mats.append(tr.mat)
    return torch.cat(blocks), torch.cat(mats)


def _xform_rows(scene: Scene) -> Tensor:
    """float32[R + TS + TT, 23] rows of the transform-tested classes
    [rects | t_spheres | t_triangles] (intersect.py:641): position(3),
    rotation(3), scale(3), mat(1), {rect: object normal z (+-1) | t_sphere:
    radius | t_triangle: 0}(1), t_triangle v0, v1, v2, object normal (12).
    The record of a winner gathers one row and recomputes that prim on a
    per-ray TransformRay'd ray."""
    blocks = []
    if scene.n_rects:
        rc = scene.rects
        nz = torch.where(rc.flip, -1.0, 1.0)
        blocks.append(torch.cat([
            rc.trs.position, rc.trs.rotation, rc.trs.scale,
            rc.mat.to(torch.float32)[:, None], nz[:, None],
            nz.new_zeros(scene.n_rects, 12)], 1))
    if scene.n_t_spheres:
        ts = scene.t_spheres
        blocks.append(torch.cat([
            ts.trs.position, ts.trs.rotation, ts.trs.scale,
            ts.mat.to(torch.float32)[:, None], ts.radius[:, None],
            ts.radius.new_zeros(scene.n_t_spheres, 12)], 1))
    if scene.n_t_triangles:
        tt = scene.t_triangles
        blocks.append(torch.cat([
            tt.trs.position, tt.trs.rotation, tt.trs.scale,
            tt.mat.to(torch.float32)[:, None],
            tt.v0.new_zeros(scene.n_t_triangles, 1),
            tt.v0, tt.v1, tt.v2, tt.normal], 1))
    return torch.cat(blocks)


def _transform_rays_single(rays: Rays, position: Tensor, rotation: Tensor,
                           scale: Tensor):
    """TransformRay with one gathered TRS per ray (intersect.py:956) ->
    (object-space origin float32[N, 3], unit direction float32[N, 3],
    |raw d| float32[N], the rotation's 9 components)."""
    m = _rows3x3(v3.rotation_matrix_euler_deg(rotation))
    xo, xd = _tf.transform_arrays(
        [rays.origin[:, k] for k in range(3)],
        [rays.direction[:, k] for k in range(3)],
        [position[:, k] for k in range(3)], [scale[:, k] for k in range(3)],
        m)
    return (torch.stack(xo, -1), torch.stack(xd, -1),
            _raw_len(rays.direction), m)


def _rotate(m, v: Tensor) -> Tensor:
    return torch.stack(_tf.rotate_rows(m, v[..., 0], v[..., 1], v[..., 2]),
                       -1)


def _tsph_roots(xo: Tensor, xd: Tensor, r: Tensor, t_min, t_max,
                near: Optional[Tensor] = None):
    """Native t of a TRS sphere already chosen per ray: the near root when
    it is in the window (or where ``near`` says so), else the far one
    (never BIG)."""
    b = _sw._dot(xo, xd)
    a = _sw._dot(xd, xd)
    c = _sw._dot(xo, xo) - r * r
    disc = b * b - a * c
    disc_safe = torch.where(disc > 0.0, disc, 1.0)
    sq = torch.where(disc > 0.0, torch.sqrt(disc_safe), 0.0)
    t0 = (-b - sq) / a
    t1 = (-b + sq) / a
    if near is None:
        near = (disc > 0.0) & (t0 < t_max) & (t0 > t_min)
    return torch.where(near, t0, t1)


def _ttri_single(xo: Tensor, xd: Tensor, xrow: Tensor):
    """(t, u, v) of a TRS triangle already chosen per ray, on the object-
    space ray (double-where on the determinant: non-winner lanes)."""
    tv0 = xrow[:, 11:14]
    e1 = xrow[:, 14:17] - tv0
    e2 = xrow[:, 17:20] - tv0
    h = v3.cross(xd, e2)
    det = _sw._dot(e1, h)
    f = 1.0 / torch.where(det.abs() >= TRI_EPSILON, det, 1.0)
    s = xo - tv0
    u = f * _sw._dot(s, h)
    q = v3.cross(s, e1)
    v = f * _sw._dot(xd, q)
    t = f * _sw._dot(e2, q)
    return t, u, v


def finalize_hits(scene: Scene, rays: Rays, best_t: Tensor,
                  best_idx: Tensor, t_min, t_max, quirks: Quirks,
                  near: Optional[Tensor] = None) -> Hits:
    """The full hit record of each ray's winner only (intersect.py:688):
    one row gather over [spheres | triangles] and one over the transform-
    tested classes, then the winner's continuous quantities.  Rect and TRS
    winners record the OBJECT-space point (the reference's rec.p), the
    rotated normal and, for rects, the plane's (x, y) + 0.5 as (u, v).
    near: the TRS spheres' root choice made elsewhere (``replay_hits``)."""
    n = rays.origin.shape[0]
    n_s, n_t = scene.n_spheres, scene.n_triangles
    n_r, n_ts, n_tt = scene.n_rects, scene.n_t_spheres, scene.n_t_triangles
    hit = best_idx >= 0
    t = torch.where(hit, best_t, BIG)
    p = rays.point_at(t)
    normal = p.new_zeros(n, 3)
    u = p.new_zeros(n)
    vv = p.new_zeros(n)
    mat = torch.zeros(n, dtype=torch.int32, device=p.device)
    if n_s or n_t:
        prow, pmat = _prim_rows(scene)
        cidx = best_idx.clamp(0, n_s + n_t - 1).long()
        row = _mat.gather_rows(prow, cidx)
        row_mat = pmat[cidx].to(torch.int32)
    if n_s:
        is_s = hit & (best_idx < n_s)
        s_norm, s_u, s_v = _sphere_record(p, is_s, row[:, 0:3], row[:, 3])
        normal = torch.where(is_s[:, None], s_norm, normal)
        u = torch.where(is_s, s_u, u)
        vv = torch.where(is_s, s_v, vv)
        mat = torch.where(is_s, row_mat, mat)
    if n_t:
        is_t = hit & (best_idx >= n_s) & (best_idx < n_s + n_t)
        tnorm = row[:, 9:12]
        _, tu, tv = _tri_single(rays, row[:, 0:3], row[:, 3:6], row[:, 6:9])
        normal = torch.where(is_t[:, None], tnorm, normal)
        u = torch.where(is_t, tu, u)
        vv = torch.where(is_t, tv, vv)
        mat = torch.where(is_t, row_mat, mat)
    n_x = n_r + n_ts + n_tt
    if not n_x:
        return Hits(hit, t, p, normal, u, vv, mat, best_idx)
    base = n_s + n_t + n_r
    xrow = _mat.gather_rows(_xform_rows(scene),
                            (best_idx.long() - n_s - n_t).clamp(0, n_x - 1))
    xo, xd, _, m = _transform_rays_single(rays, xrow[:, 0:3], xrow[:, 3:6],
                                          xrow[:, 6:9])
    x_mat = xrow[:, 9].to(torch.int32)
    if n_r:
        # the upper bound matters: TRS winners must not take a rect's record
        is_r = hit & (best_idx >= n_s + n_t) & (best_idx < base)
        dz = xd[:, 2]
        tz = -xo[:, 2] / torch.where(dz != 0.0, dz, 1.0)
        rx = xo[:, 0] + tz * xd[:, 0]
        ry = xo[:, 1] + tz * xd[:, 1]
        r_obj_n = torch.cat([torch.zeros_like(xo[:, 0:2]), xrow[:, 10:11]],
                            -1)
        normal = torch.where(is_r[:, None], _rotate(m, r_obj_n), normal)
        u = torch.where(is_r, rx + 0.5, u)
        vv = torch.where(is_r, ry + 0.5, vv)
        p = torch.where(is_r[:, None], xo + tz[:, None] * xd, p)
        mat = torch.where(is_r, x_mat, mat)
    if n_ts:
        is_ts = hit & (best_idx >= base) & (best_idx < base + n_ts)
        # non-winner lanes may pair with a row whose radius column is 0
        r = torch.where(is_ts, xrow[:, 10], 1.0)
        ts_nat = _tsph_roots(xo, xd, r, t_min, t_max, near)
        ps = xo + ts_nat[:, None] * xd
        tsn = _rotate(m, ps / r[:, None])
        normal = torch.where(is_ts[:, None], tsn, normal)
        p = torch.where(is_ts[:, None], ps, p)
        phi = torch.atan2(tsn[:, 2], tsn[:, 0])
        theta = _safe_arcsin(tsn[:, 2])
        u = torch.where(is_ts, 1.0 - (phi + math.pi) / (2.0 * math.pi), u)
        vv = torch.where(is_ts, (theta + math.pi / 2.0) / math.pi, vv)
        mat = torch.where(is_ts, x_mat, mat)
    if n_tt:
        is_tt = hit & (best_idx >= base + n_ts)
        ttt, ttu, ttv = _ttri_single(xo, xd, xrow)
        normal = torch.where(is_tt[:, None], _rotate(m, xrow[:, 20:23]),
                             normal)
        p = torch.where(is_tt[:, None], xo + ttt[:, None] * xd, p)
        u = torch.where(is_tt, ttu, u)
        vv = torch.where(is_tt, ttv, vv)
        mat = torch.where(is_tt, x_mat, mat)
    return Hits(hit, t, p, normal, u, vv, mat, best_idx)


# ---------------------------------------------------------------------------
# Replay
# ---------------------------------------------------------------------------

def _sphere_single(rays: Rays, center: Tensor, radius: Tensor, t_min,
                   t_max, near: Optional[Tensor] = None) -> Tensor:
    """Nearest in-window root of one already-chosen sphere per ray
    (intersect.py:971), the far root when neither is in the window, so a
    recorded winner never gives an overflowing t; double-where for the
    non-winner lanes.  near: the root choice made elsewhere."""
    oc = rays.origin - center
    d = rays.direction
    a = _sw._dot(d, d)
    b = _sw._dot(oc, d)
    c = _sw._dot(oc, oc) - radius * radius
    disc = b * b - a * c
    disc_safe = torch.where(disc > 0.0, disc, 1.0)
    sq = torch.where(disc > 0.0, torch.sqrt(disc_safe), 0.0)
    t0 = (-b - sq) / a
    t1 = (-b + sq) / a
    if near is None:
        near = (disc > 0.0) & (t0 < t_max) & (t0 > t_min)
    return torch.where(near, t0, t1)


def replay_hits(scene: Scene, rays: Rays, winner: Tensor, t_min, t_max,
                quirks: Quirks, near: Optional[Tensor] = None) -> Hits:
    """The hit record of a winner decided in advance (intersect.py:851):
    winner int32[N] in the Hits.prim id space, -1 for a miss.  Gathers each
    ray's one prim and recomputes only its continuous quantities (t, p,
    normal, u, v), O(N) per bounce instead of a sweep over every prim.

    The validity windows are NOT applied again: the winner passed them when
    it was recorded, and a test repeated in float32 could turn a real t
    into BIG (whose point overflows and NaNs the backward).  The sphere
    root choice is made again (near root in the window, else the far one),
    or taken from ``near`` bool[N] (sphere and TRS sphere winners).
    Rect and TRS t are native t over |raw d|, as the sweeps compare them."""
    t_min, t_max = _f32(t_min), _f32(t_max)
    n = rays.origin.shape[0]
    n_s, n_t = scene.n_spheres, scene.n_triangles
    n_r, n_ts, n_tt = scene.n_rects, scene.n_t_spheres, scene.n_t_triangles
    hit = winner >= 0
    best_t = torch.full((n,), BIG, device=rays.origin.device)
    if n_s or n_t:
        row = _mat.gather_rows(_prim_rows(scene)[0],
                               winner.long().clamp(0, n_s + n_t - 1))
    if n_s:
        ts = _sphere_single(rays, row[:, 0:3], row[:, 3], t_min, t_max,
                            near)
        best_t = torch.where(hit & (winner < n_s), ts, best_t)
    if n_t:
        tt, _, _ = _tri_single(rays, row[:, 0:3], row[:, 3:6], row[:, 6:9])
        best_t = torch.where(hit & (winner >= n_s) & (winner < n_s + n_t),
                             tt, best_t)
    n_x = n_r + n_ts + n_tt
    if n_x:
        base = n_s + n_t + n_r
        xrow = _mat.gather_rows(_xform_rows(scene), (
            winner.long() - n_s - n_t).clamp(0, n_x - 1))
        xo, xd, raw_len, _ = _transform_rays_single(
            rays, xrow[:, 0:3], xrow[:, 3:6], xrow[:, 6:9])
        if n_r:
            dz = xd[:, 2]
            tz = -xo[:, 2] / torch.where(dz != 0.0, dz, 1.0)
            is_r = hit & (winner >= n_s + n_t) & (winner < base)
            best_t = torch.where(is_r, _t_cmp(is_r, tz, raw_len), best_t)
        if n_ts:
            is_ts = hit & (winner >= base) & (winner < base + n_ts)
            r = torch.where(is_ts, xrow[:, 10], 1.0)
            ts_ = _tsph_roots(xo, xd, r, t_min, t_max, near)
            best_t = torch.where(is_ts, _t_cmp(is_ts, ts_, raw_len), best_t)
        if n_tt:
            ttt, _, _ = _ttri_single(xo, xd, xrow)
            is_tt = hit & (winner >= base + n_ts)
            best_t = torch.where(is_tt, _t_cmp(is_tt, ttt, raw_len), best_t)
    return finalize_hits(scene, rays, torch.where(hit, best_t, BIG), winner,
                         t_min, t_max, quirks, near)
