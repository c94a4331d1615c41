"""A plain brute-force path tracer of triangle meshes under the fixed quirks
(the program's ``Quirks.fixed()``), in PyTorch tensor operations, for
triangles on lambertian materials with constant textures.

Where it departs from ``tracer.py`` (the reference's quirks), and only
there:

- a triangle is hit from either side and only at t in (t_min, t_max)
  (``tracer._triangle_t`` hits back faces only and never clips t from
  below, triangle.h:61, 92-94); the Moller-Trumbore arithmetic is
  ``tracer._triangle_t``'s, in its order;
- an absorbed path adds nothing (``tracer.path_radiance`` adds 0.1 of
  ambient, render.h:61).

As there, the closest hit is the first triangle on ties (blocks over the
triangles, each block's first minimum, a later block winning only when
strictly nearer), the normal is the triangle's stored face normal (the
fixed quirks do not turn it to face the ray), and the sky, the lambertian
scatter, the Philox draws keyed by (seed, ray, bounce), the gamma and the
clip are ``tracer.py``'s and ``philox.py``'s functions.  The program adds
a lambertian's emission (0) to every hit; adding 0.0 changes no sum, so
it is left out here.

Every function takes a ``dtype``: float32 is the reference; a lower one
(bfloat16) is the control that the comparison must reject.
"""

from __future__ import annotations

import numpy as np
import torch

from . import philox, tracer

Tensor = torch.Tensor


def mesh_prims(vertices: Tensor, normal: Tensor, albedo: Tensor,
               dtype=torch.float32) -> tracer.Prims:
    """Prims of triangles float32[T, 3, 3] with face normals [T, 3], each
    on a lambertian of constant colour ``albedo`` [T, 3]."""
    t = vertices.shape[0]
    dev = vertices.device
    v0, v1, v2 = vertices[:, 0], vertices[:, 1], vertices[:, 2]
    # (kind, texture kind, aux, colour 0, colour 1): lambertian, constant
    row = torch.zeros(t, 9, device=dev)
    row[:, 0] = tracer.LAMBERTIAN
    row[:, 2] = 1.0
    row[:, 3:6] = albedo
    z = torch.zeros(0, device=dev, dtype=dtype)
    return tracer.Prims(z.view(0, 3), z, z, z.view(0, 9), v0.to(dtype),
                        (v1 - v0).to(dtype), (v2 - v0).to(dtype),
                        normal.to(dtype), row.to(dtype))


def triangle_t(o, d, v0, e1, e2, t_min, t_max):
    """[rays, triangles] candidate t, BIG on a miss: Moller-Trumbore in
    ``tracer._triangle_t``'s order, both faces, t in (t_min, t_max)."""
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
    valid = ((a.abs() >= tracer.TRI_EPSILON) & (u >= 0.0) & (u <= 1.0)
             & (v >= 0.0) & (u + v <= 1.0) & (t > t_min) & (t < t_max))
    return torch.where(valid, t, torch.full_like(t, tracer.big_of(t.dtype)))


def closest_hit(pr: tracer.Prims, o: Tensor, d: Tensor,
                cfg: dict) -> tracer.Hit:
    """The nearest triangle of ``pr`` along each ray (the first on ties)."""
    t_min = float(np.float32(cfg["t_min"]))
    t_max = float(np.float32(cfg["t_max"]))
    t, i = tracer._closest(lambda lo, hi: triangle_t(
        o, d, pr.v0[lo:hi], pr.e1[lo:hi], pr.e2[lo:hi], t_min, t_max),
        pr.v0.shape[0], o)
    p = o + t[:, None] * d
    return tracer.Hit(t, t < tracer.BIG_CUT, p, pr.normal[i], pr.t_mat[i])


def path_radiance(pr: tracer.Prims, o: Tensor, d: Tensor, seed: Tensor,
                  index: Tensor, cfg: dict) -> Tensor:
    """The path integrator of rays [N] to depth cfg['max_depth'] under the
    fixed quirks, each ray's draws keyed by (its seed, its index, the
    bounce) -> radiance [N, 3] in the rays' dtype."""
    dt = o.dtype
    n = o.shape[0]
    thr = torch.ones(n, 3, device=o.device, dtype=dt)
    rad = torch.zeros(n, 3, device=o.device, dtype=dt)
    alive = torch.ones(n, dtype=torch.bool, device=o.device)
    for step in range(cfg["max_depth"] + 1):
        il = tracer.inv_len(d)
        h = closest_hit(pr, o, d, cfg)
        att = tracer.attenuation(h.m, h.p)
        ball, prob = philox.counter_draws(seed, index, step, dt)
        ok, out = tracer.scatter(d, h.n, h.m, il, ball, prob)
        cont = alive & h.hit & ok & (step < cfg["max_depth"])
        missed = (alive & ~h.hit)[:, None]
        rad = rad + thr * torch.where(missed, tracer.sky(d, il),
                                      torch.zeros_like(rad))
        c3 = cont[:, None]
        thr = torch.where(c3, thr * att, thr)
        o = torch.where(c3, h.p, o)
        d = torch.where(c3, out, d)
        alive = cont
    return rad


def render_rays(pr: tracer.Prims, o: Tensor, d: Tensor, seed: Tensor,
                index: Tensor, cfg: dict, block: int = 1 << 16) -> Tensor:
    """The path integrator over rays in blocks -> radiance [N, 3]."""
    if cfg["integrator"] != "path":
        raise ValueError("the mesh reference runs the path integrator")
    return torch.cat([path_radiance(pr, o[lo:lo + block], d[lo:lo + block],
                                    seed[lo:lo + block],
                                    index[lo:lo + block], cfg)
                      for lo in range(0, o.shape[0], block)])
