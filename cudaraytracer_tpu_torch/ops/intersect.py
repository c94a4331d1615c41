"""Closest hit over a scene's spheres and triangles, as differentiable
tensor ops (the JAX package's ``ops/intersect.py``).

Two ways to find the winner, one way to build its hit record:
  * ``intersect_scene``: brute force over (rays x prims) candidate matrices
    in chunks of prims, differentiated by autograd through the winner's
    candidate (``--accel bruteforce``, and the oracle in the tests);
  * ``intersect_scene_sweeps``: the sphere sweep (K3, or K5 for pure-sphere
    scenes under ``wavefront_kernel_attrs``) then the triangle sweep (K4)
    of ``ops/sweeps.py``, whose autograd Functions recompute only the
    winner in the backward (the counterpart of ``intersect_scene_pallas``);
  * ``finalize_hits`` rebuilds the winner's record (point, normal, u, v,
    material) from its id.

Differentiability follows the detached-discrete / attached-continuous
estimator: the argmin is piecewise constant; t, p, normal and the material
fields flow.  Every division or root that a masked-out lane could reach is
double-where guarded, so a zero cotangent never meets an inf.

Dropped from the JAX package: the decode-column fold of the TPU's
consolidated form (``FOLD_DEC`` / ``CONSOLIDATE``).  The port decodes
materials by one row gather everywhere, and takes the attribute-carrying
sweep whenever ``wavefront_kernel_attrs`` is set on a pure-sphere scene, on
any device.  Rects and runtime-TRS prims raise until slice 5.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..config import Quirks
from ..core import vec as v3
from ..core.rays import Rays
from ..models import materials as _mat
from ..models.scene import Scene
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


def check_prims(scene: Scene) -> None:
    """Raise for prim classes the port's wavefront does not test yet."""
    if scene.n_rects or scene.n_t_spheres or scene.n_t_triangles:
        raise NotImplementedError(
            "rects and runtime-TRS prims are not ported yet: ROADMAP Queue 1 "
            "item 16 (slice 5)")


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
    check_prims(scene)
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
    return finalize_hits(scene, rays, best[0], best[1], t_min, t_max, quirks)


# ---------------------------------------------------------------------------
# Sweeps (kernels K3, K4, K5)
# ---------------------------------------------------------------------------

def intersect_scene_sweeps(scene: Scene, rays: Rays, t_min: float = 1e-3,
                           t_max: float = BIG, quirks: Quirks = Quirks(),
                           coherent: bool = False,
                           alive: Optional[Tensor] = None,
                           sphere_cull: str = "primary",
                           kernel_attrs: bool = False) -> Hits:
    """Closest hit through the sweeps (intersect.py:425 of the JAX package):
    the sphere sweep, then the triangle sweep with ids offset by the sphere
    count (a triangle wins only when strictly nearer), then finalize_hits.

    sphere_cull: 'all' culls every sphere sweep by chunk boxes (the trace
    permutes spheres into Morton order first), 'primary' only coherent
    (camera) sweeps, 'off' none.  Triangle sweeps cull from 128 triangles
    up.  alive: optional mask; a dead lane returns a miss.  kernel_attrs: on
    a pure-sphere scene, K5 carries the winner's record row out."""
    check_prims(scene)
    n_s, n_t = scene.n_spheres, scene.n_triangles
    cull = sphere_cull == "all" or (sphere_cull != "off" and coherent)
    if n_s and not n_t and kernel_attrs:
        return _sphere_attrs_hits(scene, rays, t_min, t_max, cull, alive)
    n = rays.origin.shape[0]
    dev = rays.origin.device
    best_t = torch.full((n,), BIG, device=dev)
    best_idx = torch.full((n,), -1, dtype=torch.int32, device=dev)
    if n_s:
        sp = scene.spheres
        st, si = _sw.sphere_best_hit(rays.origin, rays.direction, sp.center,
                                     sp.radius, t_min, t_max, cull, alive)
        take = (si >= 0) & (st < best_t)
        best_t = torch.where(take, st, best_t)
        best_idx = torch.where(take, si, best_idx)
    if n_t:
        tr = scene.triangles
        tt, ti = _sw.triangle_best_hit(rays.origin, rays.direction, tr.v0,
                                       tr.v1, tr.v2, tr.normal, t_min, t_max,
                                       quirks, alive)
        take = (ti >= 0) & (tt < best_t)
        best_t = torch.where(take, tt, best_t)
        best_idx = torch.where(take, ti + n_s, best_idx)
    return finalize_hits(scene, rays, best_t, best_idx, t_min, t_max, quirks)


def sphere_attr_table(scene: Scene) -> Tensor:
    """float32[21, S]: center(3), radius, mat, the 16 decode columns of each
    sphere's material (the K5 attribute contract)."""
    sp = scene.spheres
    dec = _mat.decode_table(scene.materials, scene.textures)
    return torch.cat([sp.center.t(), sp.radius[None],
                      sp.mat.to(torch.float32)[None],
                      dec[sp.mat.long()].t()], dim=0)


def _sphere_attrs_hits(scene: Scene, rays: Rays, t_min, t_max, cull: bool,
                       alive: Optional[Tensor]) -> Hits:
    """Pure-sphere hit records through K5 (intersect.py:522): the kernel
    returns each winner's attribute row, so the record and its decoded
    material build without a gather.  Same values as the finalize_hits
    path."""
    sp = scene.spheres
    st, si, attrs = _sw.sphere_best_hit_attrs(
        rays.origin, rays.direction, sp.center, sp.radius,
        sphere_attr_table(scene), t_min, t_max, cull, alive)
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
    a = (e1 * h).sum(-1)
    f = 1.0 / torch.where(a.abs() >= TRI_EPSILON, a, 1.0)
    s = rays.origin - v0
    u = f * (s * h).sum(-1)
    q = v3.cross(s, e1)
    v = f * (d * q).sum(-1)
    t = f * (e2 * q).sum(-1)
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


def finalize_hits(scene: Scene, rays: Rays, best_t: Tensor,
                  best_idx: Tensor, t_min, t_max, quirks: Quirks) -> Hits:
    """The full hit record of each ray's winner only (intersect.py:688,
    sphere and triangle branches): one row gather over [spheres |
    triangles], then the winner's continuous quantities."""
    n = rays.origin.shape[0]
    n_s, n_t = scene.n_spheres, scene.n_triangles
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
        row = prow[cidx]
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
    return Hits(hit, t, p, normal, u, vv, mat, best_idx)
