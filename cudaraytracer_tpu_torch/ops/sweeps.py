"""Closest-hit sweeps over one primitive type: kernels K3, K4 and K5.

The counterpart of the JAX package's ``ops/pallas_intersect.py``: the
wrappers around ``csrc/sweeps.cu`` (the ports of ``_sphere_kernel`` /
``_sphere_kernel_plain`` (K3), ``_triangle_kernel`` /
``_triangle_kernel_culled`` (K4) and ``_sphere_kernel_attrs`` (K5)), their
plain PyTorch versions, and the ``torch.autograd.Function``s around them
whose backward recomputes only the winning primitive and sums the rays'
gradients into the primitives' with the winner sum ``winner_add``
(``crt_winner_add``, a kernel of the same library).

Contract kept from the TPU kernels: per-ray (t, idx) with t = BIG and
idx = -1 on a miss; the nearest in-range sphere root; Moller-Trumbore with
the quirk gates; first prim wins ties (strict <, prims in table order);
tables padded by repeating the last prim, so padding never wins; chunk
boxes of 16 prims with the negated slab test (NaN keeps a chunk
reachable), cut at t_min, or at -BIG for triangles under the no-t-clip
quirk.  The tables are built at every call, or once per trace
(``SweepTables``, ``intersect.sweep_tables``) when the caller passes
them.

What the culled forms guarantee against the plain ones (brute force):
  * triangles: a triangle's box, widened by TRI_MARGIN x (the box's
    largest |coordinate| + the ray origin's), holds every point where
    Moller-Trumbore accepts a hit with |a| >= TRI_WELL x |d| |e1| |e2|
    (infinity norms; the bound is derived below).  So the culled sweep
    gives the plain version's (t, idx) on every ray whose plain winner
    is such a hit, and on every ray the plain version misses.  A ray
    that grazes a sliver (|a| below that) may lose its hit to the cull,
    as it may to the TPU kernel's exact boxes; ``triangle_conditioned``
    tells which winners are covered;
  * spheres: a sphere's box, widened by SPH_MARGIN x (the box's largest
    |coordinate| + the ray origin's), holds every point where the half-b
    quadratic accepts a root (derived below), so the culled sweep gives
    the plain version's (t, idx) on every ray.  The exact boxes (the TPU
    kernel's) can lose a ray tangent to a sphere: the cancellation in
    |oc|^2 - r^2 lets the computed discriminant be positive on a line
    that misses the sphere by up to sqrt(u) |oc|.

TPU layout dropped (a CUDA thread loads what it needs):
  * no 32 x 128 ray tiles or per-tile any() votes: each ray culls its own
    boxes, and a block packs the live rays of its 128-ray tile, so a dead
    lane (alive false) returns (BIG, -1) and does no work, where the TPU
    kernel ran dead lanes of a live tile;
  * tables are rows (4 floats per sphere, 12 per triangle, 8 per box)
    padded to a multiple of 16 prims, not (comp, c_pad, 1) planes in
    SEG_PRIMS=1024 segments; a second box level over 16 chunks (256
    prims), as K1's tables have, for triangles and from SPH_SUPER_MIN
    spheres up;
  * K5 does not carry the attribute row through every chunk merge: it
    loads the winner's row once after the sweep (miss lanes get row 0).

Culled triangle launches, and sphere launches with an alive mask (the
wavefront's bounces), split a reached chunk's (ray, prim) tests over the
warp's lanes (``coop``); sphere camera launches test one ray per thread,
where the split's shuffles cost more than a sphere test saves (the
choice measured on the card, PERF.md).  Either way the tests and
decisions are the same (csrc/sweeps.cu).

Dispatch: a CUDA tensor launches the kernel or raises; a CPU tensor runs
the plain version.  Nothing falls back from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import Quirks
from . import _cuda

Tensor = torch.Tensor

BIG = float(np.finfo(np.float32).max)   # 3.4028235e38, the "no hit" t
TRI_EPSILON = 1e-6                       # triangle.h:9
PRIM_CHUNK = 16                          # prims per chunk box
CHUNKS_PER_SUPER = 16
SUPER_PRIMS = PRIM_CHUNK * CHUNKS_PER_SUPER   # prims per super box
BOX_COLS = 8                             # lo.xyz hi.xyz | 2 pad
TRI_CULL_MIN = 128   # triangle sweeps cull from this many triangles up
# sphere sweeps take the super level from this many spheres up (K1's
# SPH_SUPER_MIN); triangle sweeps always do when they cull
SPH_SUPER_MIN = 1024
# The triangle boxes' margin, and the conditioning it covers.  With u =
# 2^-24, float32 rounding and no fused multiply-add (the plain version's
# and the kernel's arithmetic), s = o - v0, and P = |d| |e1| |e2|
# (infinity norms), Moller-Trumbore's computed a, u, v, t satisfy
#   |a D| <= 150 u P |s| + 3 u |a| (|t d| + |e1| + |e2|),
# where D = o + t d - (v0 + u e1 + v e2) is the gap between the ray's point
# at the returned t and the point the returned (u, v) names in the
# triangle; 150 u is 6 (g5 + g6 + g7 + g7), g_n = n u / (1 - n u), from
# the rounding of a, u a, v a and t a (for the exact values a s = (u a) e1
# + (v a) e2 - (t a) d).  An accepted
# (u, v) lies in the triangle, so with |a| >= TRI_WELL P the point o + t d
# lies within 150 u |s| / TRI_WELL + 30 u (|o| + R) of the vertices' box
# (R the triangle's largest |coordinate|; |s| <= |o| + R, |t d| <= |s| +
# 4 R + |D|); e1 and e2 rounded from the vertices add 4 u R, and the slab's
# own rounding 3 u (|box| + |o|).  In all under 9,700 u (|o| + R) = 0.59
# TRI_MARGIN (|o| + R): each box is widened by TRI_MARGIN x its largest
# |coordinate| here (``widen_boxes``) and by TRI_MARGIN x the ray origin's
# largest |coordinate| in the kernel, so such a hit keeps its box's slab
# true against any running best above its t.
TRI_MARGIN = 2.0 ** -10
TRI_WELL = 2.0 ** -6
# The sphere boxes' margin.  With oc = o - c, a = d.d, b = oc.d and r2 the
# stored r^2, the exact discriminant of the line is b^2 - a (|oc|^2 - r2)
# = a (r2 - h^2), h the distance from c to the line.  Rounded as the
# kernels round it (oc, then b and |oc|^2 - r2, then b^2 - a c; no fused
# multiply-add), the computed discriminant is within 21 u a (|oc|^2 + r2)
# of it to first order (b: 4 u |oc| |d|, squared 9 u; oc.oc - r2: 6 u
# |oc|^2 + u r2; times a: 4 u more; the last subtraction 2 u), which we
# take as 32 u.  So a root is accepted only where h^2 < r2 + 32 u (|oc|^2
# + r2): the line passes within r + sqrt(33 u) (|oc| + r) of c, 2-norms.
# The accepted t lies on that line within the ball of that radius, up to
# the root's own rounding, 8 u (|oc| + r) in distance, and the slab's, 3 u
# (|box| + |o|).  With |oc| + r <= sqrt(3) (|o| + R) (infinity norms, R the
# box's largest |coordinate|, which is at least |c| + r), the point lies
# within sqrt(99 u) (|o| + R) + 17 u (|o| + R) < 0.63 SPH_MARGIN (|o| + R)
# of the sphere's exact box: each sphere box is widened by SPH_MARGIN x its
# largest |coordinate| here and by SPH_MARGIN x the ray origin's in the
# kernel, so no accepted root is culled, whatever the ray.  The bound is
# sqrt(u) wide because of the cancellation, hence four times TRI_MARGIN.
SPH_MARGIN = 2.0 ** -8
# plain versions bound their (rays x prims) candidate matrices to this
PLAIN_ELEMENTS = 1 << 22
N_ATTRS = 21         # K5 attribute row: center(3), radius, mat, decode(16)
F_BACKFACE_ONLY, F_NO_T_CLIP, F_BACK_CULLING = 1, 2, 4

# What the counting instances count (csrc/sweeps.cu CountIdx): box and
# prim tests, and the warp steps that issued them
COUNT_NAMES = ("box", "prim", "box_step", "prim_step")
N_COUNTS = len(COUNT_NAMES)

# The winner sum's row blocks a launch, and its forms (csrc/sweeps.cu
# crt_winner_add: the shared form while the [C, K] sums fit its budget of
# shared memory, else the global form; under PyTorch's deterministic
# algorithms the ordered form, whose sums repeat bit for bit, over at most
# WINNER_ORDERED_BLOCKS one-warp blocks and a scratch of at most
# WINNER_ORDERED_BYTES)
WINNER_BLOCKS = 3
WINNER_FORMS = ("shared", "global", "ordered")
WINNER_ORDERED_BLOCKS = 1024
WINNER_ORDERED_BYTES = 1 << 28

# Launches of each kernel since the last reset_launch_counts(), and the
# same launches by kind: a sweep's "bounce" with an alive mask, else
# "camera"; the winner sum's by form.
LAUNCH_KINDS = {**{k: {"camera": 0, "bounce": 0} for k in (
    "sphere_sweep", "sphere_sweep_attrs", "triangle_sweep")},
    "winner_add": dict.fromkeys(WINNER_FORMS, 0)}
LAUNCHES = dict.fromkeys(LAUNCH_KINDS, 0)


def reset_launch_counts() -> None:
    for k, kinds in LAUNCH_KINDS.items():
        LAUNCHES[k] = 0
        LAUNCH_KINDS[k] = dict.fromkeys(kinds, 0)


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------

def pad_rows(x: Tensor, mult: int) -> Tensor:
    """Pad rows to a multiple of ``mult`` by repeating the last row."""
    n = x.shape[0]
    pad = -(-max(n, 1) // mult) * mult - n
    if pad == 0:
        return x
    return torch.cat([x, x[-1:].expand((pad,) + tuple(x.shape[1:]))])


def widen(cols: Tensor, width: int) -> Tensor:
    return torch.cat([cols, cols.new_zeros(cols.shape[0],
                                           width - cols.shape[1])], dim=1)


def group_boxes(lo: Tensor, hi: Tensor, group: int, mult: int) -> Tensor:
    """float32[k, 8] boxes (lo.xyz, hi.xyz, 2 pad) of consecutive groups of
    ``group`` rows, after padding to a multiple of ``mult``."""
    lo, hi = pad_rows(lo, mult), pad_rows(hi, mult)
    k = lo.shape[0] // group
    b = torch.cat([lo.reshape(k, group, 3).amin(dim=1),
                   hi.reshape(k, group, 3).amax(dim=1)], dim=1)
    return widen(b, BOX_COLS)


def morton_argsort(points: Tensor) -> Tensor:
    """Device-side order of float32[N, 3] points by their 30-bit Morton
    code (stable) -> int64[N] (pallas_intersect.py:728)."""
    p = points.detach()
    lo = p.amin(dim=0)
    span = torch.clamp(p.amax(dim=0) - lo, min=1e-20)
    q = torch.clamp((p - lo) / span * 1023.0, 0.0, 1023.0).to(torch.int64)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    code = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    return torch.argsort(code, stable=True)


def _box_levels(lo: Tensor, hi: Tensor, supers: bool = True,
                margin: float = 0.0):
    """(chunk boxes float32[C_pad / 16, 8], super boxes
    float32[ceil(C_pad / 256), 8] or None) of prims padded to 16, each
    widened by ``margin`` x its largest |coordinate|."""
    groups = (PRIM_CHUNK, SUPER_PRIMS) if supers else (PRIM_CHUNK,)
    levels = [group_boxes(lo, hi, g, g) for g in groups]
    if margin:      # both levels widened in one pass
        levels = widen_boxes(torch.cat(levels), margin).split(
            [b.shape[0] for b in levels])
    return levels[0], levels[1] if supers else None


def widen_boxes(box: Tensor, margin: float) -> Tensor:
    """Boxes float32[k, 8] widened on every side by ``margin`` x each
    box's largest |coordinate|."""
    lo, hi = box[:, 0:3], box[:, 3:6]
    m = torch.maximum(lo.abs(), hi.abs()).amax(dim=1, keepdim=True) * margin
    return torch.cat([lo - m, hi + m, box[:, 6:]], dim=1).contiguous()


def sphere_table(center: Tensor, radius: Tensor):
    """(float32[C_pad, 4] rows cx cy cz r^2, float32[C_pad / 16, 8] chunk
    boxes, float32[ceil(C_pad / 256), 8] super boxes from SPH_SUPER_MIN
    spheres up, else None; each box widened by SPH_MARGIN x its largest
    |coordinate|), padded by repeating the last sphere."""
    center_p = pad_rows(center, PRIM_CHUNK)
    radius_p = pad_rows(radius, PRIM_CHUNK)
    tbl = torch.cat([center_p, (radius_p * radius_p)[:, None]], dim=1)
    box, sup = _box_levels(center_p - radius_p[:, None],
                           center_p + radius_p[:, None],
                           center.shape[0] >= SPH_SUPER_MIN, SPH_MARGIN)
    return tbl.contiguous(), box, sup


def triangle_table(v0: Tensor, v1: Tensor, v2: Tensor, normal: Tensor):
    """(float32[C_pad, 12] rows v0, e1 = v1 - v0, e2 = v2 - v0, normal;
    float32[C_pad / 16, 8] chunk boxes and float32[ceil(C_pad / 256), 8]
    super boxes of the vertices, each widened by TRI_MARGIN x its largest
    |coordinate|), padded by repeating the last triangle
    (pallas_intersect.py:794-835)."""
    v0, v1, v2, normal = (pad_rows(x, PRIM_CHUNK) for x in (v0, v1, v2,
                                                            normal))
    tbl = torch.cat([v0, v1 - v0, v2 - v0, normal], dim=1)
    lo = torch.minimum(torch.minimum(v0, v1), v2)
    hi = torch.maximum(torch.maximum(v0, v1), v2)
    return (tbl.contiguous(), *_box_levels(lo, hi, margin=TRI_MARGIN))


def triangle_conditioned(direction: Tensor, e1: Tensor,
                         e2: Tensor) -> Tensor:
    """bool[N]: ray i and triangle i (edges e1, e2 as the table holds
    them) satisfy |a| >= TRI_WELL |d| |e1| |e2| (infinity norms), a the
    denominator Moller-Trumbore computes: the hits the culled sweep is
    proven to keep (TRI_MARGIN)."""
    dx, dy, dz = direction.unbind(1)
    hx = dy * e2[:, 2] - dz * e2[:, 1]
    hy = dz * e2[:, 0] - dx * e2[:, 2]
    hz = dx * e2[:, 1] - dy * e2[:, 0]
    a = e1[:, 0] * hx + e1[:, 1] * hy + e1[:, 2] * hz
    p = (direction.double().abs().amax(1) * e1.double().abs().amax(1)
         * e2.double().abs().amax(1))
    return a.double().abs() >= TRI_WELL * p


class SweepTables(NamedTuple):
    """A scene's sweep tables, built once (``intersect.sweep_tables``)
    from detached tensors and passed to every sweep of a trace."""

    sph: Optional[tuple]          # sphere_table of the spheres, or None
    tri: Optional[tuple]          # triangle_table of the triangles, or None
    sph_attr: Optional[Tensor]    # K5's attribute rows float32[C_pad, A]


def _f32(x: float) -> float:
    """A bound as the kernels see it (float32)."""
    return float(np.float32(x))


# ---------------------------------------------------------------------------
# Candidate math, shared by the plain versions (and by the fused kernel's)
# ---------------------------------------------------------------------------

def sphere_candidates_t(o: Tensor, d: Tensor, center: Tensor, r2: Tensor,
                        t_min: float, t_max: float) -> Tensor:
    """(rays x spheres) candidate t, BIG on a miss: the half-b quadratic
    with a strict disc > 0, each root times 1/a, the nearest root inside
    (t_min, t_max) (pallas_intersect.py:112-133)."""
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
    return torch.where(ok0, t0, torch.where(ok1, t1, BIG))


def triangle_candidates_t(o: Tensor, d: Tensor, v0: Tensor, e1: Tensor,
                          e2: Tensor, normal: Tensor, t_min: float,
                          t_max: float, quirks: Quirks) -> Tensor:
    """(rays x triangles) candidate t, BIG on a miss: Moller-Trumbore with
    the quirk gates of pallas_intersect.py:136-174."""
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
             & (v >= 0.0) & (u + v <= 1.0))
    if quirks.triangle_back_culling:      # triangle.h:74
        valid &= a >= TRI_EPSILON
    if quirks.triangle_backface_only:     # triangle.h:61
        valid &= (dx * normal[:, 0] + dy * normal[:, 1]
                  + dz * normal[:, 2]) >= 0.0
    if quirks.triangle_no_t_clip:         # triangle.h:92-94
        valid &= t < t_max
    else:
        valid &= (t > t_min) & (t < t_max)
    return torch.where(valid, t, BIG)


def _closest(cand_fn, n_prims: int, o: Tensor, alive: Optional[Tensor]):
    """Brute-force closest hit over prims in chunks -> (t, int32 idx).
    ``cand_fn(lo, hi)`` gives the (rays x prims[lo:hi]) candidate t.  Ties:
    ``min`` returns the first index, and a later chunk wins only when
    strictly nearer."""
    n = o.shape[0]
    best_t = torch.full((n,), BIG, dtype=o.dtype, device=o.device)
    best_i = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    step = max(PRIM_CHUNK, PLAIN_ELEMENTS // max(n, 1))
    for lo in range(0, n_prims, step):
        hi = min(n_prims, lo + step)
        tmin, imin = cand_fn(lo, hi).min(dim=1)
        take = tmin < best_t
        best_t = torch.where(take, tmin, best_t)
        best_i = torch.where(take, imin + lo, best_i)
    if alive is not None:
        best_t = torch.where(alive, best_t, BIG)
        best_i = torch.where(alive, best_i, -1)
    return best_t, best_i.to(torch.int32)


def _alive_mask(alive: Optional[Tensor]) -> Optional[Tensor]:
    if alive is None:
        return None
    return alive if alive.dtype == torch.bool else alive > 0


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def sphere_best_hit_plain(origin: Tensor, direction: Tensor, center: Tensor,
                          radius: Tensor, t_min: float, t_max: float,
                          alive: Optional[Tensor] = None):
    """Plain version of K3: (t float32[N], idx int32[N])."""
    t_min, t_max = _f32(t_min), _f32(t_max)
    r2 = radius * radius
    return _closest(lambda lo, hi: sphere_candidates_t(
        origin, direction, center[lo:hi], r2[lo:hi], t_min, t_max),
        center.shape[0], origin, _alive_mask(alive))


def sphere_best_hit_attrs_plain(origin: Tensor, direction: Tensor,
                                center: Tensor, radius: Tensor,
                                attr_tbl: Tensor, t_min: float, t_max: float,
                                alive: Optional[Tensor] = None):
    """Plain version of K5: (t, idx, attrs float32[N, A]); attr_tbl is
    float32[A, C]; a miss lane carries prim 0's row."""
    t, idx = sphere_best_hit_plain(origin, direction, center, radius, t_min,
                                   t_max, alive)
    return t, idx, attr_tbl.t()[idx.clamp(min=0).long()]


def triangle_best_hit_plain(origin: Tensor, direction: Tensor, v0: Tensor,
                            v1: Tensor, v2: Tensor, normal: Tensor,
                            t_min: float, t_max: float, quirks: Quirks,
                            alive: Optional[Tensor] = None):
    """Plain version of K4: (t float32[N], idx int32[N])."""
    t_min, t_max = _f32(t_min), _f32(t_max)
    e1, e2 = v1 - v0, v2 - v0
    return _closest(lambda lo, hi: triangle_candidates_t(
        origin, direction, v0[lo:hi], e1[lo:hi], e2[lo:hi], normal[lo:hi],
        t_min, t_max, quirks), v0.shape[0], origin, _alive_mask(alive))


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

def _library() -> ctypes.CDLL:
    lib = _cuda.load("sweeps")
    if not getattr(lib, "_crt_declared", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.crt_sphere_sweep.argtypes = [vp] * 11 + [ci] * 4 + [cf] * 2 + [vp]
        lib.crt_sphere_sweep.restype = ci
        lib.crt_triangle_sweep.argtypes = ([vp] * 9 + [ci] * 4 + [cf] * 2
                                           + [vp])
        lib.crt_triangle_sweep.restype = ci
        lib.crt_winner_add.argtypes = [vp] * 6 + [ctypes.c_longlong, ci,
                                           vp, ci, vp, vp]
        lib.crt_winner_add.restype = ci
        lib.crt_sweeps_error_string.argtypes = [ci]
        lib.crt_sweeps_error_string.restype = ctypes.c_char_p
        lib._crt_declared = True
    return lib


def _check_cuda(name: str, x: Tensor, dtype, shape, device,
                align: int = 4) -> None:
    if not x.is_cuda or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} CUDA tensor; "
                         f"got {x.dtype} on {x.device}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, rays on {device}")
    if x.numel() and x.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")


def _ptr(x: Optional[Tensor]):
    return None if x is None else x.data_ptr()


def _launch_checks(origin, direction, alive, counts):
    n = origin.shape[0]
    dev = origin.device
    _check_cuda("origin", origin, torch.float32, (n, 3), dev)
    _check_cuda("direction", direction, torch.float32, (n, 3), dev)
    if alive is not None:
        _check_cuda("alive", alive, torch.bool, (n,), dev)
    if counts is not None:
        _check_cuda("counts", counts, torch.int64, (N_COUNTS,), dev, 8)
    if n >= 2 ** 31:
        raise ValueError(f"{n} rays exceed one launch")


def _check(lib, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.crt_sweeps_error_string(code).decode()}")


def _check_boxes(what: str, n_pad: int, box, sup, dev) -> None:
    if n_pad % PRIM_CHUNK:
        raise ValueError(f"{what} table of {n_pad} rows is not padded to "
                         f"{PRIM_CHUNK}")
    n_chunks = n_pad // PRIM_CHUNK
    if box is not None:
        _check_cuda(f"{what} boxes", box, torch.float32,
                    (n_chunks, BOX_COLS), dev, 16)
    if sup is not None:
        _check_cuda(f"{what} super boxes", sup, torch.float32,
                    (-(-n_chunks // CHUNKS_PER_SUPER), BOX_COLS), dev, 16)


def _count_launch(name: str, alive: Optional[Tensor]) -> None:
    LAUNCHES[name] += 1
    LAUNCH_KINDS[name]["camera" if alive is None else "bounce"] += 1


def launch_sphere_sweep(origin: Tensor, direction: Tensor, tbl: Tensor,
                        box: Optional[Tensor], alive: Optional[Tensor],
                        attr_rows: Optional[Tensor], t_min: float,
                        t_max: float, counts: Optional[Tensor] = None,
                        sup: Optional[Tensor] = None,
                        coop: Optional[bool] = None):
    """One launch of K3 (attr_rows None) or K5 over prepared tables ->
    (t, idx[, attrs]); K5's attrs float32[N, A] are the transposed view of
    the planes it writes, float32[A, N].  box None: the plain form; given,
    the culled form, with the super boxes ``sup`` as a second level when
    given.  coop: the warp-cooperative chunk tests of a culled launch
    (default: on a launch with an alive mask).  counts: optional
    int64[N_COUNTS] CUDA tensor that a separately compiled counting
    instance adds its tests to (measurement only)."""
    n = origin.shape[0]
    dev = origin.device
    _launch_checks(origin, direction, alive, counts)
    n_pad = tbl.shape[0]
    _check_cuda("sphere table", tbl, torch.float32, (n_pad, 4), dev, 16)
    _check_boxes("sphere", n_pad, box, sup, dev)
    n_attr = 0
    if attr_rows is not None:
        n_attr = attr_rows.shape[1]
        _check_cuda("attr rows", attr_rows, torch.float32, (n_pad, n_attr),
                    dev)
    out_t = torch.empty(n, dtype=torch.float32, device=dev)
    out_i = torch.empty(n, dtype=torch.int32, device=dev)
    # K5 writes one plane of n floats per attribute
    out_a = (torch.empty((n_attr, n), dtype=torch.float32, device=dev)
             if attr_rows is not None else None)
    if coop is None:
        coop = alive is not None
    lib = _library()
    with torch.cuda.device(dev):
        code = lib.crt_sphere_sweep(
            origin.data_ptr(), direction.data_ptr(), tbl.data_ptr(),
            _ptr(box), _ptr(sup), _ptr(alive), _ptr(attr_rows),
            out_t.data_ptr(), out_i.data_ptr(), _ptr(out_a), _ptr(counts),
            n, n_pad // PRIM_CHUNK, n_attr, int(coop), _f32(t_min),
            _f32(t_max), torch.cuda.current_stream().cuda_stream)
    _check(lib, code, "sphere_sweep")
    if counts is None:
        _count_launch("sphere_sweep_attrs" if attr_rows is not None
                      else "sphere_sweep", alive)
    return (out_t, out_i) if out_a is None else (out_t, out_i, out_a.t())


def launch_triangle_sweep(origin: Tensor, direction: Tensor, tbl: Tensor,
                          box: Optional[Tensor], alive: Optional[Tensor],
                          t_min: float, t_max: float, quirks: Quirks,
                          counts: Optional[Tensor] = None,
                          sup: Optional[Tensor] = None,
                          coop: Optional[bool] = None):
    """One launch of K4 over prepared tables -> (t, idx).  box None: the
    plain form; given, the culled form.  sup, counts: as
    launch_sphere_sweep; coop: the warp-cooperative chunk tests of a
    culled launch (default: on)."""
    n = origin.shape[0]
    dev = origin.device
    _launch_checks(origin, direction, alive, counts)
    n_pad = tbl.shape[0]
    _check_cuda("triangle table", tbl, torch.float32, (n_pad, 12), dev, 16)
    _check_boxes("triangle", n_pad, box, sup, dev)
    flags = ((F_BACKFACE_ONLY if quirks.triangle_backface_only else 0)
             | (F_NO_T_CLIP if quirks.triangle_no_t_clip else 0)
             | (F_BACK_CULLING if quirks.triangle_back_culling else 0))
    out_t = torch.empty(n, dtype=torch.float32, device=dev)
    out_i = torch.empty(n, dtype=torch.int32, device=dev)
    if coop is None:
        coop = True
    lib = _library()
    with torch.cuda.device(dev):
        code = lib.crt_triangle_sweep(
            origin.data_ptr(), direction.data_ptr(), tbl.data_ptr(),
            _ptr(box), _ptr(sup), _ptr(alive), out_t.data_ptr(),
            out_i.data_ptr(), _ptr(counts), n, n_pad // PRIM_CHUNK, flags,
            int(coop), _f32(t_min), _f32(t_max),
            torch.cuda.current_stream().cuda_stream)
    _check(lib, code, "triangle_sweep")
    if counts is None:
        _count_launch("triangle_sweep", alive)
    return out_t, out_i


def _rays_in(origin: Tensor, direction: Tensor, alive: Optional[Tensor]):
    return (origin.detach().contiguous(), direction.detach().contiguous(),
            None if alive is None else _alive_mask(alive).contiguous())


def _miss(origin: Tensor, n_attr: int = 0):
    n = origin.shape[0]
    out = (torch.full((n,), BIG, dtype=origin.dtype, device=origin.device),
           torch.full((n,), -1, dtype=torch.int32, device=origin.device))
    if n_attr:
        out += (origin.new_zeros(n, n_attr),)
    return out


def _sphere_sweep_in(center, radius, cull, tables):
    """(tbl, box, sup) of a sphere launch: the given sphere_table or one
    built now; box and sup None for the plain form."""
    tbl, box, sup = (tables if tables is not None
                     else sphere_table(center.detach(), radius.detach()))
    return (tbl, box, sup) if cull else (tbl, None, None)


def sphere_best_hit_raw(origin: Tensor, direction: Tensor, center: Tensor,
                        radius: Tensor, t_min: float, t_max: float,
                        cull: bool = False, alive: Optional[Tensor] = None,
                        tables: Optional[tuple] = None):
    """K3 (pallas_intersect.py:503): (best_t float32[N], best_idx int32[N])
    over all spheres; idx -1 = miss.  cull: box culling (chunk boxes, and
    super boxes from SPH_SUPER_MIN spheres up).  alive: optional
    bool/float[N] mask; a dead lane returns (BIG, -1).  tables: the
    spheres' sphere_table, built here when None (a CPU tensor ignores
    it)."""
    if center.shape[0] == 0:
        return _miss(origin)
    if origin.device.type == "cpu":
        return sphere_best_hit_plain(origin, direction, center, radius,
                                     t_min, t_max, alive)
    tbl, box, sup = _sphere_sweep_in(center, radius, cull, tables)
    o, d, al = _rays_in(origin, direction, alive)
    return launch_sphere_sweep(o, d, tbl, box, al, None, t_min, t_max,
                               sup=sup)


def sphere_best_hit_attrs_raw(origin: Tensor, direction: Tensor,
                              center: Tensor, radius: Tensor,
                              attr_tbl: Tensor, t_min: float, t_max: float,
                              cull: bool = False,
                              alive: Optional[Tensor] = None,
                              tables: Optional[tuple] = None,
                              rows: Optional[Tensor] = None):
    """K5 (pallas_intersect.py:411): K3 plus the winner's attribute row ->
    (t, idx, attrs float32[N, A]).  attr_tbl: float32[A, C] per-prim
    columns; rows 0..2 are the center and row 3 the radius (the backward
    reads them from attrs).  A miss or dead lane carries prim 0's row.
    tables, rows: the sphere_table and attr_tbl's padded rows
    (SweepTables.sph_attr), built here when None."""
    if center.shape[0] == 0:
        return _miss(origin, attr_tbl.shape[0])
    if origin.device.type == "cpu":
        return sphere_best_hit_attrs_plain(origin, direction, center, radius,
                                           attr_tbl, t_min, t_max, alive)
    tbl, box, sup = _sphere_sweep_in(center, radius, cull, tables)
    if rows is None:
        rows = attr_rows(attr_tbl)
    o, d, al = _rays_in(origin, direction, alive)
    return launch_sphere_sweep(o, d, tbl, box, al, rows, t_min, t_max,
                               sup=sup)


def attr_rows(attr_tbl: Tensor) -> Tensor:
    """K5's attribute rows float32[C_pad, A] of attr_tbl float32[A, C]."""
    return pad_rows(attr_tbl.detach().t(), PRIM_CHUNK).contiguous()


def triangle_best_hit_raw(origin: Tensor, direction: Tensor, v0: Tensor,
                          v1: Tensor, v2: Tensor, normal: Tensor,
                          t_min: float, t_max: float, quirks: Quirks,
                          cull: Optional[bool] = None,
                          alive: Optional[Tensor] = None,
                          tables: Optional[tuple] = None):
    """K4 (pallas_intersect.py:773): (t, idx) over all triangles.  cull
    None: the culled form (chunk and super boxes) from TRI_CULL_MIN
    triangles up (:785-786).  tables: the triangles' triangle_table, built
    here when None (a CPU tensor ignores it)."""
    c = v0.shape[0]
    if c == 0:
        return _miss(origin)
    if origin.device.type == "cpu":
        return triangle_best_hit_plain(origin, direction, v0, v1, v2, normal,
                                       t_min, t_max, quirks, alive)
    if cull is None:
        cull = c >= TRI_CULL_MIN
    tbl, box, sup = (tables if tables is not None else triangle_table(
        v0.detach(), v1.detach(), v2.detach(), normal.detach()))
    o, d, al = _rays_in(origin, direction, alive)
    return launch_triangle_sweep(o, d, tbl, box if cull else None, al,
                                 t_min, t_max, quirks,
                                 sup=sup if cull else None)


# ---------------------------------------------------------------------------
# The winner sum: per-ray gradients into per-prim gradients
# ---------------------------------------------------------------------------
#
# crt_winner_add (csrc/sweeps.cu) replaces no pallas_call: the JAX package
# sums the winner-only backwards' rows with XLA's scatter
# (pallas_intersect.py:1038-1043, .at[safe].add).  It is bounded by bytes,
# one read of idx and of each row (about 104 B a ray for K5's K = 25), and
# works around the contention of a few hot winners: misses and dead lanes
# add nothing, and the lanes of a warp with the same winner add once.

def _winner_views(out: Tensor, blocks) -> list:
    """out [C, K] split into one view per row block: [C, k] for a block
    [N, k], [C] for a block [N]."""
    views, col = [], 0
    for b in blocks:
        if b.dim() == 1:
            views.append(out[:, col])
            col += 1
        else:
            views.append(out[:, col:col + b.shape[1]])
            col += b.shape[1]
    return views


def winner_add_plain(idx: Tensor, blocks, n_slots: int) -> list:
    """Plain version of crt_winner_add: index_add_ of the hit lanes' rows
    (idx >= 0) into n_slots slots -> one view per block (``winner_add``)."""
    hit = idx >= 0
    rows = torch.cat([b.reshape(b.shape[0], -1)[hit] for b in blocks],
                     dim=1)
    out = rows.new_zeros(n_slots, rows.shape[1]).index_add_(
        0, idx[hit].long(), rows)
    return _winner_views(out, blocks)


def launch_winner_add(idx: Tensor, blocks, n_slots: int) -> list:
    """One launch of crt_winner_add: idx int32[N] (negative: no winner),
    1 to WINNER_BLOCKS float32 row blocks [N, k] or [N] of any strides,
    read in place -> one view per block of the float32 [n_slots, K] sums
    (``winner_add``); the ordered form under PyTorch's deterministic
    algorithms."""
    n = idx.shape[0]
    dev = idx.device
    _check_cuda("idx", idx, torch.int32, (n,), dev)
    if not 1 <= len(blocks) <= WINNER_BLOCKS:
        raise ValueError(f"{len(blocks)} row blocks; a winner sum takes 1 "
                         f"to {WINNER_BLOCKS}")
    if n >= 2 ** 31:
        raise ValueError(f"{n} rays exceed one launch")
    ptrs, strides, cols = [], [], []
    for j, b in enumerate(blocks):
        b2 = b[:, None] if b.dim() == 1 else b
        if (not b2.is_cuda or b2.dtype != torch.float32 or b2.dim() != 2
                or b2.shape[0] != n):
            raise ValueError(f"row block {j} must be a float32 CUDA tensor "
                             f"[{n}, k] or [{n}]; got {b.dtype} "
                             f"{tuple(b.shape)} on {b.device}")
        if b2.device != dev:
            raise ValueError(f"row block {j} is on {b2.device}, idx on {dev}")
        ptrs.append(b2.data_ptr())
        strides += b2.stride()
        cols.append(b2.shape[1])
    out = torch.empty(n_slots, sum(cols), dtype=torch.float32, device=dev)
    scratch, n_scratch = None, 0
    if torch.are_deterministic_algorithms_enabled() and out.numel():
        n_scratch = max(1, min(WINNER_ORDERED_BLOCKS, -(-n // 32),
                               WINNER_ORDERED_BYTES // (4 * out.numel())))
        scratch = torch.empty(n_scratch, *out.shape, dtype=torch.float32,
                              device=dev)
    form = ctypes.c_int(-1)
    lib = _library()
    with torch.cuda.device(dev):
        code = lib.crt_winner_add(
            idx.data_ptr(), (ctypes.c_void_p * len(ptrs))(*ptrs),
            (ctypes.c_longlong * len(strides))(*strides),
            (ctypes.c_int * len(cols))(*cols), len(cols), out.data_ptr(),
            n, n_slots, _ptr(scratch), n_scratch, ctypes.byref(form),
            torch.cuda.current_stream().cuda_stream)
    _check(lib, code, "winner_add")
    if form.value >= 0:
        LAUNCHES["winner_add"] += 1
        LAUNCH_KINDS["winner_add"][WINNER_FORMS[form.value]] += 1
    return _winner_views(out, blocks)


def winner_add(idx: Tensor, blocks, n_slots: int) -> list:
    """The winner sum: row i of each block added into slot idx[i], lanes
    with idx < 0 skipped -> one view per block ([n_slots, k] of a block
    [N, k], [n_slots] of a block [N]), all of one [n_slots, K] tensor.  A
    CUDA idx launches crt_winner_add (float32) or raises; a CPU idx runs
    winner_add_plain."""
    if idx.device.type == "cpu":
        return winner_add_plain(idx, blocks, n_slots)
    return launch_winner_add(idx, blocks, n_slots)


# ---------------------------------------------------------------------------
# Differentiable sweeps: kernel forward, winner-only backward
# ---------------------------------------------------------------------------

def _dot(a: Tensor, b: Tensor) -> Tensor:
    """x * x' + y * y' + z * z' in the kernels' order, as elementwise ops:
    each rounds alike on every device, where a reduction's order does not.
    A grazing ray's t gradient scales as 1 / sqrt(disc), so an ulp of disc
    moves it visibly."""
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def _cross(a: Tensor, b: Tensor) -> Tensor:
    """a x b as elementwise ops, in the kernels' order (see _dot)."""
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=1)


def _sphere_t_of(origin, direction, center, radius, pick_first):
    """Differentiable t for a known winning sphere per ray
    (pallas_intersect.py:926)."""
    oc = origin - center
    a = _dot(direction, direction)
    b = _dot(oc, direction)
    cc = _dot(oc, oc) - radius * radius
    sq = torch.sqrt(torch.clamp(b * b - a * cc, min=1e-20))
    return torch.where(pick_first, (-b - sq) / a, (-b + sq) / a)


def _sphere_grads(origin, direction, c_w, r_w, hit, g_t, t_min, t_max):
    """Gradients of sum(t * g_t) over hit lanes w.r.t. the rays and the
    winners' center and radius.  The root is re-chosen by the sweep's
    exact rule (take t0 iff it lies in (t_min, t_max)), not by a tolerance
    on t (pallas_intersect.py:958-969)."""
    oc = origin - c_w
    a = _dot(direction, direction)
    b = _dot(oc, direction)
    cc = _dot(oc, oc) - r_w * r_w
    disc = b * b - a * cc
    t0 = (-b - torch.sqrt(torch.clamp(disc, min=0.0))) / a
    pick_first = (disc > 0.0) & (t0 < t_max) & (t0 > t_min)
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_() for x in (origin, direction,
                                                        c_w, r_w)]
        t = _sphere_t_of(*leaves, pick_first)
        total = (t * torch.where(hit, g_t, 0.0)).sum()
        g_o, g_d, g_c, g_r = torch.autograd.grad(total, leaves)
    h3 = hit[:, None]
    return (torch.where(h3, g_o, 0.0), torch.where(h3, g_d, 0.0),
            torch.where(h3, g_c, 0.0), torch.where(hit, g_r, 0.0))


class _SphereBestHit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, origin, direction, center, radius, t_min, t_max, cull,
                alive, tables):
        t, idx = sphere_best_hit_raw(origin, direction, center, radius,
                                     t_min, t_max, cull, alive, tables)
        ctx.save_for_backward(origin, direction, center, radius, idx)
        ctx.bounds = (_f32(t_min), _f32(t_max))
        ctx.mark_non_differentiable(idx)
        return t, idx

    @staticmethod
    def backward(ctx, g_t, _g_idx):
        origin, direction, center, radius, idx = ctx.saved_tensors
        hit = idx >= 0
        safe = idx.clamp(min=0).long()
        g_o, g_d, g_c, g_r = _sphere_grads(origin, direction, center[safe],
                                           radius[safe], hit, g_t,
                                           *ctx.bounds)
        g_center, g_radius = winner_add(idx, (g_c, g_r), center.shape[0])
        return g_o, g_d, g_center, g_radius, None, None, None, None, None


class _SphereBestHitAttrs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, origin, direction, center, radius, attr_tbl, t_min,
                t_max, cull, alive, tables, rows):
        t, idx, attrs = sphere_best_hit_attrs_raw(
            origin, direction, center, radius, attr_tbl, t_min, t_max, cull,
            alive, tables, rows)
        ctx.save_for_backward(origin, direction, idx, attrs)
        ctx.bounds = (_f32(t_min), _f32(t_max))
        ctx.tbl_shape = tuple(attr_tbl.shape)
        ctx.mark_non_differentiable(idx)
        return t, idx, attrs

    @staticmethod
    def backward(ctx, g_t, _g_idx, g_attrs):
        origin, direction, idx, attrs = ctx.saved_tensors
        hit = idx >= 0
        # miss lanes carry prim 0's row (finite geometry); every term is
        # masked by hit, and the winner sum skips them
        # (pallas_intersect.py:1015-1050)
        g_o, g_d, g_c, g_r = _sphere_grads(origin, direction, attrs[:, 0:3],
                                           attrs[:, 3], hit, g_t,
                                           *ctx.bounds)
        g_center, g_radius, g_rows = winner_add(idx, (g_c, g_r, g_attrs),
                                                ctx.tbl_shape[1])
        return (g_o, g_d, g_center, g_radius, g_rows.t(), None, None, None,
                None, None, None)


def _tri_t_of(origin, direction, v0, v1, v2, mask):
    """Differentiable t for a known winning triangle per ray.  Miss lanes
    pair with triangle 0, whose determinant may be 0: the double-where
    keeps 1/a finite there (pallas_intersect.py:1056-1070)."""
    e1 = v1 - v0
    e2 = v2 - v0
    q = _cross(origin - v0, e1)
    h = _cross(direction, e2)
    a = _dot(e1, h)
    a_safe = torch.where(mask, a, 1.0)
    return torch.where(mask, _dot(e2, q) / a_safe, 0.0)


class _TriangleBestHit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, origin, direction, v0, v1, v2, normal, t_min, t_max,
                quirks, alive, tables):
        t, idx = triangle_best_hit_raw(origin, direction, v0, v1, v2, normal,
                                       t_min, t_max, quirks, alive=alive,
                                       tables=tables)
        ctx.save_for_backward(origin, direction, v0, v1, v2, idx)
        ctx.mark_non_differentiable(idx)
        return t, idx

    @staticmethod
    def backward(ctx, g_t, _g_idx):
        origin, direction, v0, v1, v2, idx = ctx.saved_tensors
        hit = idx >= 0
        safe = idx.clamp(min=0).long()
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() for x in (
                origin, direction, v0[safe], v1[safe], v2[safe])]
            t = _tri_t_of(*leaves, hit)
            total = (t * torch.where(hit, g_t, 0.0)).sum()
            g_o, g_d, g0, g1, g2 = torch.autograd.grad(total, leaves)
        z = hit[:, None]
        grads = winner_add(idx, (g0, g1, g2), v0.shape[0])
        return (torch.where(z, g_o, 0.0), torch.where(z, g_d, 0.0), *grads,
                None, None, None, None, None, None)


def sphere_best_hit(origin: Tensor, direction: Tensor, center: Tensor,
                    radius: Tensor, t_min: float, t_max: float,
                    cull: bool = False, alive: Optional[Tensor] = None,
                    tables: Optional[tuple] = None) -> Tuple[Tensor, Tensor]:
    """Differentiable K3 (pallas_intersect.py:938): t carries gradients to
    the rays and to the winners' center and radius (a winner sum,
    ``winner_add``); idx carries none.  tables: as sphere_best_hit_raw
    (the backward reads the spheres, never the tables)."""
    return _SphereBestHit.apply(origin, direction, center, radius, t_min,
                                t_max, cull, alive, tables)


def sphere_best_hit_attrs(origin: Tensor, direction: Tensor, center: Tensor,
                          radius: Tensor, attr_tbl: Tensor, t_min: float,
                          t_max: float, cull: bool = False,
                          alive: Optional[Tensor] = None,
                          tables: Optional[tuple] = None,
                          rows: Optional[Tensor] = None):
    """Differentiable K5 (pallas_intersect.py:989): t flows to the rays
    and to center/radius (winner's center/radius read from attrs); attrs
    flow to attr_tbl at the winners' columns; the three gradients come
    from one winner sum (``winner_add``, one launch on the card).  The
    caller builds attr_tbl from center/radius, so the two paths are
    disjoint.
    tables, rows: as sphere_best_hit_attrs_raw."""
    return _SphereBestHitAttrs.apply(origin, direction, center, radius,
                                     attr_tbl, t_min, t_max, cull, alive,
                                     tables, rows)


def triangle_best_hit(origin: Tensor, direction: Tensor, v0: Tensor,
                      v1: Tensor, v2: Tensor, normal: Tensor, t_min: float,
                      t_max: float, quirks: Quirks,
                      alive: Optional[Tensor] = None,
                      tables: Optional[tuple] = None):
    """Differentiable K4 (pallas_intersect.py:1074): t carries gradients to
    the rays and to the winners' vertices (a winner sum, ``winner_add``,
    the three vertices in one launch on the card); the normal gets none.
    tables: as triangle_best_hit_raw."""
    return _TriangleBestHit.apply(origin, direction, v0, v1, v2, normal,
                                  t_min, t_max, quirks, alive, tables)
