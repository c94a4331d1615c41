"""The path integrator in the differentiable wavefront's arithmetic, for
the fit: shade() (render.h:48-67) one bounce at a time over the whole
batch of rays, each step's closest sphere chosen without gradients and
its record and scatter written as tensor operations that autograd
differentiates (material.h:55-143 as the JAX package's materials.py
writes them: unit vectors by division, dot products as sums over the last
axis, the sky by linear interpolation, the sphere normal (p - c) / r).

A path tracer is chaotic: a last-place difference in a scatter direction
sends a ray elsewhere a few bounces on, and its share of a small
parameter gradient can then be large.  So this tracer rounds as the
program's wavefront rounds, operation for operation, and the comparison
sees only how the two sum their gradients.
"""

from __future__ import annotations

import numpy as np
import torch

from . import philox
from . import tracer as tr

Tensor = torch.Tensor

LAMBERTIAN, METAL, DIELECTRIC = 0, 1, 2


def dot(a: Tensor, b: Tensor) -> Tensor:
    return (a * b).sum(dim=-1)


def vdot(a: Tensor, b: Tensor) -> Tensor:
    return (a * b).sum(dim=-1, keepdim=True)


def length(v: Tensor) -> Tensor:
    return torch.sqrt(dot(v, v))


def unit_vector(v: Tensor) -> Tensor:
    return v / length(v)[..., None]


def reflect(v: Tensor, n: Tensor) -> Tensor:
    return v - 2.0 * vdot(v, n) * n


def refract(v: Tensor, n: Tensor, ni: Tensor):
    uv = unit_vector(v)
    dt = vdot(uv, n)
    ni = ni[..., None]
    disc = 1.0 - ni * ni * (1.0 - dt * dt)
    ok = disc[..., 0] > 0.0
    sq = torch.where(disc > 0.0,
                     torch.sqrt(torch.where(disc > 0.0, disc, 1.0)), 0.0)
    return ok, ni * (uv - n * dt) - n * sq


def schlick(cosine: Tensor, ri: Tensor) -> Tensor:
    r0 = (1.0 - ri) / (1.0 + ri)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * torch.pow(torch.clamp(1.0 - cosine, min=0.0),
                                       5.0)


def background_sky(d: Tensor) -> Tensor:
    """render.h:41-46: lerp(0.5 (unit(d).y + 1), white, (0.5, 0.7, 1))."""
    t = 0.5 * (unit_vector(d)[..., 1] + 1.0)
    top = torch.tensor([0.5, 0.7, 1.0], device=d.device, dtype=d.dtype)
    a = torch.ones_like(d)
    return a + t[..., None] * (top.expand_as(d) - a)


def material_table(a: dict, tex_c0: Tensor) -> Tensor:
    """[M, 13] per material: kind, fuzz, ref_idx, metal albedo (3),
    texture kind, colour 0 (3), colour 1 (3); colour 0 from ``tex_c0`` (the
    fit's parameter)."""
    dev, dt = tex_c0.device, tex_c0.dtype

    def t(x):
        return torch.as_tensor(x, device=dev).to(dt)

    tex = torch.as_tensor(a["mat_tex"], device=dev).long()
    return torch.cat([t(a["mat_kind"])[:, None], t(a["mat_fuzz"])[:, None],
                      t(a["mat_ref_idx"])[:, None], t(a["mat_albedo"]),
                      t(a["tex_kind"])[tex][:, None], tex_c0[tex],
                      t(a["tex_c1"])[tex]], dim=1)


def sphere_t(o: Tensor, d: Tensor, c: Tensor, r: Tensor, pick_first):
    """The root (-b -+ sqrt(b^2 - a c)) / a of a known sphere per ray, with
    its gradient (the components summed in the kernels' order)."""
    oc = o - c
    a = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    b = oc[:, 0] * d[:, 0] + oc[:, 1] * d[:, 1] + oc[:, 2] * d[:, 2]
    cc = (oc[:, 0] * oc[:, 0] + oc[:, 1] * oc[:, 1] + oc[:, 2] * oc[:, 2]
          - r * r)
    sq = torch.sqrt(torch.clamp(b * b - a * cc, min=1e-20))
    return torch.where(pick_first, (-b - sq) / a, (-b + sq) / a)


def bounce(a: dict, center: Tensor, radius: Tensor, mats: Tensor,
           sph_mat: Tensor, cfg: dict, step: int, o, d, thr, rad, alive,
           ball, prob):
    """One bounce of the whole batch -> (o, d, throughput, radiance,
    alive)."""
    dt = o.dtype
    t_min = float(np.float32(cfg["t_min"]))
    t_max = float(np.float32(cfg["t_max"]))
    big = tr.big_of(dt)
    with torch.no_grad():
        t_val, idx = tr._closest(lambda lo, hi: tr._sphere_t(
            o, d, center[lo:hi], radius[lo:hi] * radius[lo:hi], t_min,
            t_max), center.shape[0], o)
        hit = t_val < big
        oc = o - center[idx]
        aa = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
        bb = oc[:, 0] * d[:, 0] + oc[:, 1] * d[:, 1] + oc[:, 2] * d[:, 2]
        cc = (oc[:, 0] * oc[:, 0] + oc[:, 1] * oc[:, 1] + oc[:, 2] * oc[:, 2]
              - radius[idx] * radius[idx])
        disc = bb * bb - aa * cc
        t0 = (-bb - torch.sqrt(torch.clamp(disc, min=0.0))) / aa
        first = (disc > 0.0) & (t0 < t_max) & (t0 > t_min)
    c_w, r_w = center[idx], radius[idx]
    t_d = sphere_t(o, d, c_w, r_w, first)
    t = torch.where(hit, t_val + (t_d - t_d.detach()), big)
    p = o + t[..., None] * d
    p_in = torch.where(hit[:, None], p, c_w)
    normal = torch.where(hit[:, None],
                         (p_in - c_w) / torch.where(hit, r_w, 1.0)[..., None],
                         0.0)
    m = torch.nn.functional.embedding(sph_mat[idx], mats)
    kind, fuzz, ri = m[:, 0], m[:, 1], m[:, 2]
    albedo, tex_kind, c0, c1 = m[:, 3:6], m[:, 6], m[:, 7:10], m[:, 10:13]
    lam_dir = normal + ball
    met_dir = reflect(unit_vector(d), normal) + fuzz[..., None] * ball
    met_ok = dot(met_dir, normal) > 0.0
    d_dot_n = dot(d, normal)
    d_len = length(d)
    exiting = d_dot_n > 0.0
    outward = torch.where(exiting[..., None], -normal, normal)
    ni = torch.where(exiting, ri, 1.0 / ri)
    cos_plain = torch.where(exiting, d_dot_n / d_len, -d_dot_n / d_len)
    q = 1.0 - ri * ri * (1.0 - cos_plain * cos_plain)
    cos_exit = torch.where(q > 0.0, torch.sqrt(torch.where(q > 0.0, q, 1.0)),
                           0.0)
    cosine = torch.where(exiting, cos_exit, cos_plain)
    refr_ok, refracted = refract(d, outward, ni)
    reflect_prob = torch.where(refr_ok, schlick(cosine, ri), 1.0)
    die_dir = torch.where((prob < reflect_prob)[..., None], reflect(d, normal),
                          refracted)
    kc = kind[..., None]
    out = torch.where(kc == float(METAL), met_dir, lam_dir)
    out = torch.where(kc == float(DIELECTRIC), die_dir, out)
    ok = (kind != float(METAL)) | met_ok
    checker = torch.where((tr.checker_sines(p) < 0.0)[..., None], c1, c0)
    tex = torch.where((tex_kind == float(tr.CHECKER))[..., None], checker, c0)
    att = torch.where(kc == float(METAL), albedo, tex)
    att = torch.where(kc == float(DIELECTRIC), 1.0, att)
    can = step < cfg["max_depth"]
    cont = alive & hit & ok & can
    absorbed = alive & hit & ~(ok & can)
    missed = alive & ~hit
    zero = torch.zeros_like(d)
    contrib = torch.where((alive & hit)[:, None], zero, 0.0)
    contrib = contrib + torch.where(
        absorbed[:, None], tr.AMBIENT_ON_ABSORB, 0.0)
    contrib = contrib + torch.where(missed[:, None], background_sky(d), 0.0)
    rad = rad + thr * contrib
    c3 = cont[:, None]
    thr = torch.where(c3, thr * att, thr)
    return (torch.where(c3, p, o), torch.where(c3, out, d), thr, rad, cont)


def path_radiance(a: dict, center: Tensor, tex_c0: Tensor, o: Tensor,
                  d: Tensor, seed: Tensor, index: Tensor, cfg: dict) -> Tensor:
    """shade() of rays [N] with gradients to ``center`` [S, 3] and
    ``tex_c0`` [K, 3] -> radiance [N, 3]."""
    dt, dev = o.dtype, o.device
    radius = torch.as_tensor(a["radius"], device=dev).to(dt)
    mats = material_table(a, tex_c0)
    sph_mat = torch.as_tensor(a["sph_mat"], device=dev).long()
    n = o.shape[0]
    thr = torch.ones(n, 3, device=dev, dtype=dt)
    rad = torch.zeros(n, 3, device=dev, dtype=dt)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    for step in range(cfg["max_depth"] + 1):
        ball, prob = philox.counter_draws(seed, index, step, dt)
        o, d, thr, rad, alive = bounce(a, center, radius, mats, sph_mat, cfg,
                                       step, o, d, thr, rad, alive, ball,
                                       prob)
    return rad

