"""A plain brute-force ray tracer of the reference renderer's semantics
(CudaTest's render.h, material.h, sphere.h, triangle.h, texture.h), in
PyTorch tensor operations, for spheres and triangles on lambertian
(constant or checker texture), metal and dielectric materials.

- closest hit: every sphere (the half-b quadratic, nearest root in (t_min,
  t_max)), then every triangle (Moller-Trumbore), a triangle winning only
  when strictly nearer, the first prim on ties;
- the path integrator (shade(), render.h:48-67) and the lambert integrator
  (LambertShade, render.h:70-87) under the reference's quirks (config.py
  ``Quirks.reference``): back faces only and no t clip for triangles, 0.1
  of ambient on absorption, the unnormalised camera direction in the
  lambert dot, the dielectric's exit-side cosine, lambertian textures read
  at u = v = 0;
- the post-process of render.h:123-128: mean over samples, sqrt gamma,
  clip.

Every function takes a ``dtype``: float32 is the reference; a lower one
(bfloat16) is the control that the comparison must reject.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import philox

Tensor = torch.Tensor

BIG = float(np.finfo(np.float32).max)
BIG_CUT = 1e37
TRI_EPSILON = 1e-6
LAMBERTIAN, METAL, DIELECTRIC = 0, 1, 2
CHECKER = 1
# render.h:61: an absorbed path returns emitted + 0.1
AMBIENT_ON_ABSORB = 0.1


class Prims(NamedTuple):
    """The scene as the tracer reads it, in one dtype.  Per prim: its
    material's kind, texture kind, aux (metal fuzz, dielectric index),
    colour 0 (metal albedo, texture colour or checker even) and colour 1
    (checker odd)."""
    center: Tensor     # [S, 3]
    r2: Tensor         # [S]
    inv_r: Tensor      # [S]
    s_mat: Tensor      # [S, 9]
    v0: Tensor         # [T, 3]
    e1: Tensor
    e2: Tensor
    normal: Tensor
    t_mat: Tensor      # [T, 9]


def material_rows(a: dict, mat_id: np.ndarray, tex_c0=None) -> Tensor:
    """[N, 9] rows (kind, texture kind, aux, colour 0, colour 1) of the
    materials ``mat_id`` of the scene arrays ``a``.  tex_c0: the textures'
    colour 0 as a tensor (a fit's parameter), else ``a["tex_c0"]``."""
    kind = torch.as_tensor(a["mat_kind"][mat_id])
    tex = torch.as_tensor(a["mat_tex"][mat_id]).long()
    if tex_c0 is None:
        tex_c0 = torch.as_tensor(a["tex_c0"])
    dev = tex_c0.device
    kind, tex = kind.to(dev), tex.to(dev)
    metal = kind == METAL
    c0 = torch.where(metal[:, None],
                     torch.as_tensor(a["mat_albedo"][mat_id], device=dev),
                     tex_c0[tex])
    tkind = torch.where(metal, 0, torch.as_tensor(a["tex_kind"],
                                                  device=dev)[tex])
    aux = torch.where(metal, torch.as_tensor(a["mat_fuzz"][mat_id],
                                             device=dev),
                      torch.as_tensor(a["mat_ref_idx"][mat_id], device=dev))
    c1 = torch.as_tensor(a["tex_c1"], device=dev)[tex]
    return torch.cat([kind.to(torch.float32)[:, None],
                      tkind.to(torch.float32)[:, None], aux[:, None], c0, c1],
                     dim=1)


def sphere_prims(a: dict, device, dtype=torch.float32, center=None,
                 tex_c0=None) -> Prims:
    """Prims of the spheres of scene arrays ``a`` (centre and texture
    colours optionally given as tensors)."""
    if center is None:
        center = torch.as_tensor(a["center"], device=device)
    radius = torch.as_tensor(a["radius"], device=device)
    mat = material_rows(a, a["sph_mat"], tex_c0).to(device)
    z3 = torch.zeros(0, 3, device=device, dtype=dtype)
    return Prims(center.to(dtype), (radius * radius).to(dtype),
                 (1.0 / radius).to(dtype), mat.to(dtype), z3, z3, z3, z3,
                 torch.zeros(0, 9, device=device, dtype=dtype))


def triangle_prims(v0: Tensor, v1: Tensor, v2: Tensor, normal: Tensor,
                   mat_row: Tensor, dtype=torch.float32) -> Prims:
    """Prims of triangles on one material (row [9])."""
    dev = v0.device
    z = torch.zeros(0, device=dev, dtype=dtype)
    return Prims(z.view(0, 3), z, z, z.view(0, 9), v0.to(dtype),
                 (v1 - v0).to(dtype), (v2 - v0).to(dtype), normal.to(dtype),
                 mat_row.to(dtype).expand(v0.shape[0], 9))


ELEMENTS = 1 << 24    # rays x prims of one candidate block


def big_of(dtype) -> float:
    """The "no hit" t in ``dtype``: float32's largest, or the dtype's own
    where that is smaller."""
    return min(BIG, float(torch.finfo(dtype).max))


def _sphere_t(o, d, center, r2, t_min, t_max):
    """[rays, spheres] candidate t, BIG on a miss."""
    ox, oy, oz = (o[:, k:k + 1] for k in range(3))
    dx, dy, dz = (d[:, k:k + 1] for k in range(3))
    a = dx * dx + dy * dy + dz * dz
    ocx, ocy, ocz = ox - center[:, 0], oy - center[:, 1], oz - center[:, 2]
    b = ocx * dx + ocy * dy + ocz * dz
    c = ocx * ocx + ocy * ocy + ocz * ocz - r2
    disc = b * b - a * c
    hit = disc > 0.0
    sq = torch.sqrt(torch.where(hit, disc, 0.0))
    inv_a = 1.0 / a
    t0 = (-b - sq) * inv_a
    t1 = (-b + sq) * inv_a
    ok0 = hit & (t0 < t_max) & (t0 > t_min)
    ok1 = hit & (t1 < t_max) & (t1 > t_min)
    big = torch.full_like(t0, big_of(t0.dtype))
    return torch.where(ok0, t0, torch.where(ok1, t1, big))


def _triangle_t(o, d, v0, e1, e2, nrm, t_max):
    """[rays, triangles] candidate t, BIG on a miss: Moller-Trumbore, only
    faces whose normal points away from the ray (triangle.h:61), t never
    clipped below (triangle.h:92-94)."""
    ox, oy, oz = (o[:, k:k + 1] for k in range(3))
    dx, dy, dz = (d[:, k:k + 1] for k in range(3))
    e1x, e1y, e1z = e1[:, 0], e1[:, 1], e1[:, 2]
    e2x, e2y, e2z = e2[:, 0], e2[:, 1], e2[:, 2]
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    f = 1.0 / a
    sx, sy, sz = ox - v0[:, 0], oy - v0[:, 1], oz - v0[:, 2]
    u = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    valid = ((a.abs() >= TRI_EPSILON) & (u >= 0.0) & (u <= 1.0)
             & (v >= 0.0) & (u + v <= 1.0)
             & ((dx * nrm[:, 0] + dy * nrm[:, 1] + dz * nrm[:, 2]) >= 0.0)
             & (t < t_max))
    return torch.where(valid, t, torch.full_like(t, big_of(t.dtype)))


def _closest(cand, n_prims: int, o: Tensor):
    """(t, idx) of the nearest candidate over prims in blocks (the first
    prim on ties)."""
    n = o.shape[0]
    best_t = torch.full((n,), big_of(o.dtype), dtype=o.dtype,
                        device=o.device)
    best_i = torch.zeros(n, dtype=torch.int64, device=o.device)
    step = max(16, ELEMENTS // max(n, 1))
    for lo in range(0, n_prims, step):
        t, i = cand(lo, min(n_prims, lo + step)).min(dim=1)
        take = t < best_t
        best_t = torch.where(take, t, best_t)
        best_i = torch.where(take, i + lo, best_i)
    return best_t, best_i


class Hit(NamedTuple):
    t: Tensor        # [N] (BIG on a miss)
    hit: Tensor      # bool[N]
    p: Tensor        # [N, 3]
    n: Tensor        # [N, 3]
    m: Tensor        # [N, 9]


def closest_hit(pr: Prims, o: Tensor, d: Tensor, cfg: dict) -> Hit:
    t_min = float(np.float32(cfg["t_min"]))
    t_max = float(np.float32(cfg["t_max"]))
    n = o.shape[0]
    big = torch.full((n,), big_of(o.dtype), dtype=o.dtype, device=o.device)
    zero = torch.zeros(n, dtype=torch.int64, device=o.device)
    s_t, s_i, t_t, t_i = big, zero, big, zero
    if pr.center.shape[0]:
        s_t, s_i = _closest(lambda lo, hi: _sphere_t(
            o, d, pr.center[lo:hi], pr.r2[lo:hi], t_min, t_max),
            pr.center.shape[0], o)
    if pr.v0.shape[0]:
        t_t, t_i = _closest(lambda lo, hi: _triangle_t(
            o, d, pr.v0[lo:hi], pr.e1[lo:hi], pr.e2[lo:hi],
            pr.normal[lo:hi], t_max), pr.v0.shape[0], o)
    is_tri = t_t < s_t
    t = torch.where(is_tri, t_t, s_t)
    p = o + t[:, None] * d
    if pr.center.shape[0]:
        si = s_i.clamp(max=pr.center.shape[0] - 1)
        s_n = (p - pr.center[si]) * pr.inv_r[si][:, None]
        s_m = pr.s_mat[si]
    else:
        s_n, s_m = torch.zeros_like(p), p.new_zeros(n, 9)
    if pr.v0.shape[0]:
        ti = t_i.clamp(max=pr.v0.shape[0] - 1)
        t_n, t_m = pr.normal[ti], pr.t_mat[ti]
    else:
        t_n, t_m = torch.zeros_like(p), p.new_zeros(n, 9)
    tri3 = is_tri[:, None]
    return Hit(t, t < BIG_CUT, p, torch.where(tri3, t_n, s_n),
               torch.where(tri3, t_m, s_m))


def checker_sines(p: Tensor) -> Tensor:
    """texture.h:30-38: sin(10 x) sin(10 y) sin(10 z)."""
    return (torch.sin(10.0 * p[..., 0]) * torch.sin(10.0 * p[..., 1])
            * torch.sin(10.0 * p[..., 2]))


def attenuation(m: Tensor, p: Tensor) -> Tensor:
    """[N, 3]: 1 (dielectric), the albedo (metal), the texture at p
    (lambertian; a checker by the sign of its sines)."""
    kind, c0, c1 = m[:, 0:1], m[:, 3:6], m[:, 6:9]
    odd = (m[:, 1:2] == float(CHECKER)) & (checker_sines(p)[:, None] < 0.0)
    tex = torch.where(odd, c1, c0)
    return torch.where(kind == float(DIELECTRIC), torch.ones_like(tex),
                       torch.where(kind == float(METAL), c0, tex))


def sky(d: Tensor, inv_dlen: Tensor) -> Tensor:
    """render.h:41-46: white blended to (0.5, 0.7, 1.0) by the direction's
    height."""
    s = (0.5 * (d[:, 1] * inv_dlen + 1.0))[:, None]
    top = torch.tensor([0.5, 0.7, 1.0], device=d.device, dtype=d.dtype)
    return (1.0 - s) + s * top


def _sqrt_pos(x: Tensor) -> Tensor:
    """sqrt(x) where x > 0, else 0, with a finite gradient at x <= 0 (the
    double where)."""
    pos = x > 0.0
    root = torch.sqrt(torch.where(pos, x, torch.ones_like(x)))
    return torch.where(pos, root, torch.zeros_like(x))


def scatter(d, nrm, m, inv_dlen, ball, prob):
    """The four materials' scatter (material.h:55-143) -> (ok, direction)."""
    kind, aux = m[:, 0:1], m[:, 2:3]
    is_met = kind == float(METAL)
    is_die = kind == float(DIELECTRIC)
    nx, ny, nz = nrm[:, 0:1], nrm[:, 1:2], nrm[:, 2:3]
    il = inv_dlen[:, None]
    lam = nrm + ball
    ud = d * il
    udx, udy, udz = ud[:, 0:1], ud[:, 1:2], ud[:, 2:3]
    ud_n = udx * nx + udy * ny + udz * nz
    met = (ud - 2.0 * ud_n * nrm) + aux * ball
    met_ok = (met[:, 0:1] * nx + met[:, 1:2] * ny + met[:, 2:3] * nz) > 0.0
    d_n = d[:, 0:1] * nx + d[:, 1:2] * ny + d[:, 2:3] * nz
    exiting = d_n > 0.0
    on = torch.where(exiting, -1.0, 1.0).to(d.dtype) * nrm
    # the dielectric's index (1 on other lanes, whose aux may be a fuzz of
    # 0: the gradient of lanes the selects drop stays finite)
    ri = torch.where(is_die, aux, torch.ones_like(aux))
    ni = torch.where(exiting, ri, 1.0 / ri)
    cos_plain = torch.where(exiting, d_n, -d_n) * il
    qv = 1.0 - ri * ri * (1.0 - cos_plain * cos_plain)
    cos_exit = _sqrt_pos(qv)
    cosine = torch.where(exiting, cos_exit, cos_plain)
    dtv = udx * on[:, 0:1] + udy * on[:, 1:2] + udz * on[:, 2:3]
    disc = 1.0 - ni * ni * (1.0 - dtv * dtv)
    sq = _sqrt_pos(disc)
    refr = ni * (ud - on * dtv) - on * sq
    one_c = torch.clamp(1.0 - cosine, min=0.0)
    r0 = (1.0 - ri) / (1.0 + ri)
    r0 = r0 * r0
    c5 = one_c * one_c
    c5 = c5 * c5 * one_c
    refl_p = torch.where(disc > 0.0, r0 + (1.0 - r0) * c5,
                         torch.ones_like(r0))
    dref = d - 2.0 * d_n * nrm
    die = torch.where(prob[:, None] < refl_p, dref, refr)
    out = torch.where(is_die, die, torch.where(is_met, met, lam))
    ok = (is_met & met_ok) | ~is_met
    return ok[:, 0], out


def inv_len(d: Tensor) -> Tensor:
    return 1.0 / torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                            + d[:, 2] * d[:, 2])


def path_radiance(pr: Prims, o: Tensor, d: Tensor, seed: Tensor,
                  index: Tensor, cfg: dict) -> Tensor:
    """shade() (render.h:48-67) of rays [N] to depth cfg['max_depth'],
    each ray's draws keyed by (its seed, its index, the bounce) ->
    radiance [N, 3] in the rays' dtype."""
    dt = o.dtype
    n = o.shape[0]
    thr = torch.ones(n, 3, device=o.device, dtype=dt)
    rad = torch.zeros(n, 3, device=o.device, dtype=dt)
    alive = torch.ones(n, dtype=torch.bool, device=o.device)
    for step in range(cfg["max_depth"] + 1):
        il = inv_len(d)
        h = closest_hit(pr, o, d, cfg)
        att = attenuation(h.m, h.p)
        ball, prob = philox.counter_draws(seed, index, step, dt)
        ok, out = scatter(d, h.n, h.m, il, ball, prob)
        can = step < cfg["max_depth"]
        cont = alive & h.hit & ok & can
        absorbed = (alive & h.hit & ~(ok & can))[:, None]
        missed = (alive & ~h.hit)[:, None]
        rad = rad + thr * (torch.where(absorbed, AMBIENT_ON_ABSORB,
                                       0.0).to(dt)
                           + torch.where(missed, sky(d, il),
                                         torch.zeros_like(rad)))
        c3 = cont[:, None]
        thr = torch.where(c3, thr * att, thr)
        o = torch.where(c3, h.p, o)
        d = torch.where(c3, out, d)
        alive = cont
    return rad


def lambert_radiance(pr: Prims, o: Tensor, d: Tensor, cfg: dict) -> Tensor:
    """LambertShade (render.h:70-87): the hit's attenuation times the
    camera direction (unnormalised) dot the normal times the sky times 0.2;
    the sky on a miss -> [N, 3]."""
    il = inv_len(d)
    h = closest_hit(pr, o, d, cfg)
    att = attenuation(h.m, h.p)
    tq = torch.clamp(d[:, 0] * h.n[:, 0] + d[:, 1] * h.n[:, 1]
                     + d[:, 2] * h.n[:, 2], min=0.0)
    s = sky(d, il)
    return torch.where(h.hit[:, None], att * tq[:, None] * s * 0.2, s)


def finish(colors: Tensor, spp: int, gamma: bool = True,
           clip: bool = True) -> Tensor:
    """render.h:123-128: the mean over each pixel's ``spp`` adjacent
    samples, sqrt gamma (0 at or below 0), clip to [0, 1] -> [n, 3]."""
    out = colors.reshape(-1, spp, 3).mean(dim=1)
    if gamma:
        pos = out > 0.0
        out = torch.where(pos, torch.sqrt(torch.where(pos, out, 1.0)),
                          torch.zeros_like(out))
    return torch.clamp(out, 0.0, 1.0) if clip else out


def render_rays(pr: Prims, o: Tensor, d: Tensor, seed: Tensor,
                index: Tensor, cfg: dict, block: int = 1 << 16) -> Tensor:
    """The integrator of ``cfg`` over rays in blocks -> radiance [N, 3]."""
    out = []
    for lo in range(0, o.shape[0], block):
        hi = min(o.shape[0], lo + block)
        if cfg["integrator"] == "path":
            out.append(path_radiance(pr, o[lo:hi], d[lo:hi], seed[lo:hi],
                                     index[lo:hi], cfg))
        else:
            out.append(lambert_radiance(pr, o[lo:hi], d[lo:hi], cfg))
    return torch.cat(out)
