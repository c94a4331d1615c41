"""Fused path tracer: the whole bounce loop of a ray in one CUDA thread.

The wrapper around ``csrc/megakernel.cu`` (the port of the JAX package's
``ops/megakernel.py::_mega_kernel``) and its plain PyTorch version, in the
kernel's modes ported so far:
  * K1, the main-path form: spheres and triangles, three integrators;
  * K8: rects and runtime-TRS spheres and triangles, tested through the
    reference TransformRay after the sphere and triangle sweeps, a class of
    XFORM_CULL_MIN rows and more in culled chunks (``_xform_chunks``);
  * K7: the path integrator records each bounce's winner in the scene's
    prim ids, for the replay backward of ``engine='mega_diff'``
    (``trace_path_mega_diff``);
  * K9: image textures, the texel fetched in the bounce loop at the
    winner's (u, v).  The JAX package dumps ten planes per bounce and
    multiplies the texels back in outside its kernel (deferred texturing,
    ``trace_path_mega_tex``), because a TPU kernel cannot gather texels; a
    CUDA thread loads them, so the port has no plane dump and no
    reconstruction pass;
  * K6: above MAX_VMEM_PRIMS spheres or triangles the tables get a third,
    top box level, one box per SEG_T prims (the JAX kernel streams such
    tables from HBM segment by segment; a GPU thread reads them from
    global memory, so only the segment cull is left);
  * K10: the path integrator in a window of global bounces over the path
    state's planes in ray-id order, updated in place, each thread serving
    the ray of its position in an order and keying its draws by that ray's
    id, and writing the ray's key for the next window's order: the
    compaction drivers ``trace_path_mega_phased`` and
    ``trace_path_mega_compact`` (one sort between windows), chosen by
    ``select_mega`` as JAX chooses them;
  * K11: ``cfg.mega_f2b_shells``, the triangle sweep's top-level boxes
    visited front to back in distance shells;
  * K12: ``cfg.mega_mxu`` on streamed triangle tables, the triangle sweep
    as bilinear forms of 10 per-ray features Phi = [d, o, d x o, 1],
    evaluated from the coefficients ``tri_coef`` one 256-triangle super at
    a time (``_use_mxu`` routes it as JAX's ``_mega_call`` does).
The path integrator above MAX_VMEM_PRIMS triangles (K6, and K10 and K11
over it) and every K12 launch sweep the triangles warp-cooperatively: each
lane makes its own ray's box tests, and the lanes split the (ray,
triangle) tests of a box that any of their rays reached; the tests, their
arithmetic and every decision are those of the one-thread-per-ray sweep
(``_launch_mega(per_thread=True)`` for measurement), which the lambert and
normal integrators keep (camera rays only, coherent).

Tables.  ``build_mega_tables`` keeps the contract of the JAX tables: the same
prims in the same (optionally Morton) order, the same per-prim columns,
chunk boxes (16 prims) and super boxes (256 prims) over the same prims,
pad rows that repeat the last prim, so first-prim-wins survives padding,
and the row -> scene maps ``sph_map`` / ``tri_map``.  It drops the TPU
layout and adds what the kernel needs:
  * rows are 16 (sphere), 24 (triangle), 8 (box), 28 (rect, TRS sphere) and
    40 (TRS triangle) floats wide, not 128 lanes: a CUDA thread loads what
    it needs, it needs no components-on-lanes slicing; a sphere or
    triangle row carries its scene id in a pad column (S_ID, T_ID, what K7
    records);
  * every box is JAX's exact box widened by a margin (``_levels``:
    ops/sweeps.py TRI_MARGIN, SPH_MARGIN), as the kernel widens it by the
    ray origin's share, so that no box culls a hit its test accepts;
  * box tables get no extra padding to a multiple of 8 rows (a TPU sublane
    tile), and the rect / TRS tables no padding at all, in scene order,
    with no 1024-per-class cap; a class of XFORM_CULL_MIN rows or more
    gets K8's chunk boxes and the order its chunks hold its rows in;
  * K12's coefficients ``tri_coef`` (``mxu=True``) hold JAX's values but
    only the non-zero ones, N_COEF = 24 floats per triangle (96 B; JAX's
    128-lane rows take 2,560 B, 2.7 GB at a million), laid out per super as
    N_COEF planes of SUPER_T floats, so that a warp reads one coefficient of
    32 neighbouring triangles in one coalesced load (``dense_tri_coef``
    unpacks them into JAX's row order);
  * no texture info table: an image material's block carries its image id,
    w and h in the colour slots it does not use, and the kernel reads the
    scene's packed images in place (``MegaTables.images``).
Masks are bools, not f32; the sweep carries no attributes (the winner's row
is loaded after it).

Dispatch.  A CUDA tensor launches the kernel or raises; a CPU tensor runs
``trace_path_mega_plain``.  Nothing falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import RenderConfig, check_supported
from ..core import rng as _rng
from ..core import vec as v3
from ..core.rays import Rays
from ..models import materials as _mat
from ..models import textures as _tex
from ..models.scene import Scene
from ..models.transform import rotate_rows, transform_arrays
from ..utils import profiling
from ..utils.convert import to_numpy
from . import _cuda
from .sweeps import (BIG, BOX_COLS, PRIM_CHUNK, SPH_MARGIN, TRI_EPSILON,
                     TRI_MARGIN, group_boxes, morton_argsort, pad_rows,
                     sphere_candidates_t, triangle_candidates_t, widen,
                     widen_boxes)

Tensor = torch.Tensor

BIG_CUT = 1e37              # t >= BIG_CUT is a miss (megakernel.py:84-88)
SUPER_T = 256               # prims per super box (16 chunks)
SEG_T = 2048                # prims per segment box (8 supers, K6)
SPH_SUPER_MIN = 1024        # spheres get the super level above this count
# Above this many spheres or triangles a type's table gets the segment
# level (kernel mode K6); the fused engine serves up to MAX_STREAM_PRIMS.
MAX_VMEM_PRIMS = 8192
MAX_STREAM_PRIMS = 1 << 20
# The path integrator on a scene with at least this many spheres or
# triangles takes the phased octant route under cfg.compact_auto
# (select_mega).  Module constants, so tests can lower them.
AUTO_COMPACT_TRIS = 1 << 16
# K12: per-ray features Phi = [d | o | c = d x o | 1], and the quantities
# per triangle, one block of SUPER_T coefficient rows each per super:
# a = -d.n2 (n2 = e1 x e2), t_num = o.n2 - v0.n2, u_num = d.(v0 x e2) - c.e2,
# v_num = -d.(v0 x e1) + c.e1, d.n (the backface quirk)
N_FEAT = 10
N_Q = 5
# The features each quantity's coefficients are non-zero on, in feature
# order: the sum of these terms, left to right, is its value (JAX's matmul
# adds JAX's zero coefficients too, which changes at most the sign of a 0).
Q_A, Q_T, Q_U, Q_V, Q_DN = range(N_Q)
Q_TERMS = ((0, 1, 2), (3, 4, 5, 9), (0, 1, 2, 6, 7, 8), (0, 1, 2, 6, 7, 8),
           (0, 1, 2))
# tri_coef keeps those terms only: quantity q's at planes Q_OFF[q] + j of a
# super's block, N_COEF planes (22 used, 2 zero) of SUPER_T floats
Q_OFF = (0, 3, 7, 13, 19)
N_COEF = 24
# K10: the path state's planes [rad rgb | o | d | thr rgb | alive], one
# column per ray id; the regrouping keys of the next window's order
# (regroup_keys): alive first, the octant key (Morton bits above
# _OCT_COARSE_SHIFT form the coarse origin cell, then 3 direction-octant
# bits, then fine Morton) or the Morton code of the origin; a dead ray's key
# sorts last.
N_PLANES = 13
PL_ALIVE = 12
KEY_ALIVE, KEY_OCTANT, KEY_MORTON = 0, 1, 2
_OCT_COARSE_SHIFT = 18
DEAD_KEY = 2 ** 31 - 2
# K11: the cooperative sweep keeps a ray's shell of a box in one byte; a
# launch with more shells sweeps one thread per ray
MAX_SHELLS = 256

# Table columns (the JAX lane layout, cut to the used width)
S_CX, S_CY, S_CZ, S_R2, S_INVR, S_MAT = 0, 1, 2, 3, 4, 5
T_V0, T_E1, T_E2, T_N, T_MAT = 0, 3, 6, 9, 12
N_MAT_COMPS = 9             # kind, tex kind, aux, color0 rgb, color1 rgb
# an image material's block: image id, w, h in the color0 slots
M_IMG, M_W, M_H = 3, 4, 5
SPH_COLS, TRI_COLS = 16, 24
# a sphere or triangle row's scene id, as a float (exact below 2^24), in a
# pad column: what K7 records for a winner
S_ID, T_ID = 15, 21
# Rect and runtime-TRS rows share a head: position, scale, the row-major
# rotation matrix (vec3.h:200-217), the material block.
X_POS, X_SCL, X_ROT, X_MAT = 0, 3, 6, 15
RECT_SGN, RECT_NRM = 24, 25          # +-1 object normal z, world normal
TSPH_R2, TSPH_INVR = 24, 25
TTRI_V0, TTRI_E1, TTRI_E2, TTRI_NOBJ, TTRI_NW = 24, 27, 30, 33, 36
RECT_COLS, TSPH_COLS, TTRI_COLS = 28, 28, 40
# winner classes, in the order of the prim id space
C_SPH, C_TRI, C_RECT, C_TSPH, C_TTRI = 0, 1, 2, 3, 4
# K8's chunks (``_xform_chunks``): a class of at least XFORM_CULL_MIN rows
# is walked in chunks of XFORM_CHUNK rows in the Morton order of their world
# boxes, each chunk's box row: its world box lo.xyz hi.xyz widened by
# XFORM_MARGIN x its largest |coordinate|, the rows' scale range a.xyz
# b.xyz, max b, 3 pad.  Below XFORM_CULL_MIN the rows are walked in table
# order, every row tested (both sizes chosen by measurement on an H100,
# PERF.md; not knobs).
XBOX_COLS, XB_BMAX = 16, 12
XFORM_CHUNK = 8
XFORM_CULL_MIN = 64
# The margin of K8's boxes.  A row's hit is a point of its object space,
# which is the world point o + t normalize(d / s) on the row's world object
# M^T (S + p) (M the row's rotation, p its position: the scale bends the
# ray, not the object).  The rect test divides once and interpolates
# (errors of a few u (|o| + |p| + t)), and TransformRay and the transpose
# standing in for M's inverse add some tens of u of the same, far inside
# the margin.  A TRS sphere's root is the sphere sweeps' (ops/sweeps.py
# SPH_MARGIN) in object space, where |oc| = |M o - p| <= sqrt(3) (|o| +
# R) with R the world box's largest |coordinate|: SPH_MARGIN's own bound.
# A TRS triangle's hit is Moller-Trumbore's (TRI_MARGIN) in object space,
# where |M o - p| + the vertices' largest |coordinate| is at most sqrt(3)
# |o| + 4.5 R when the vertices lie within R of the object's origin (a
# modelled prim's do): with |a| >= 2 TRI_WELL |x.d| |e1| |e2| (infinity
# norms, object space) the hit lies within 0.34 XFORM_MARGIN (|o| + R) of
# its box, and a sliver grazed below that may lose its hit, as K4's.  So
# every chunk box is widened by XFORM_MARGIN = SPH_MARGIN x its largest
# |coordinate|, and by the same share of the ray origin's in the kernel;
# with the slack the margin leaves, the chunk test's bound on t (its entry
# over max b, below) stays under every covered hit's rounded t.
XFORM_MARGIN = SPH_MARGIN

INTEGRATOR_IDS = {"path": 0, "lambert": 1, "normal": 2}
F_BACKFACE_ONLY, F_NO_T_CLIP, F_BACK_CULLING = 1, 2, 4
F_DIE_REF_COSINE, F_LAMBERT_UNNORM, F_INJECTED = 8, 16, 32
F_LAMBERT_ZERO_UV = 64
# get_sphere_uv's constants as float32 products (the fused paths multiply by
# the reciprocals, so that the kernel and its plain version round alike on
# the card, where PyTorch turns a division by a scalar into a multiply)
PI, HALF_PI = math.pi, math.pi / 2.0
INV_PI, INV_TWO_PI = 1.0 / math.pi, 1.0 / (2.0 * math.pi)
# tests counted by the counting variant: chunk and super boxes, spheres,
# triangles, rects, TRS spheres, TRS triangles (the rows tested), segment
# boxes (K6), the top-level boxes ranked by the shells, once per ray and
# sweep (K11), K8's chunk boxes
N_COUNTS = 9
COUNT_NAMES = ("box", "sph", "tri", "rect", "tsph", "ttri", "seg", "dist",
               "xbox")
# the counting variant's schedule counters (``work``): bounces taken, warp
# steps run (the iterations of a warp's loop in which some lane bounced)
# and draws made in the kernel; bounce / (32 * warp_step) is the lanes' use
N_WORK = 3
WORK_NAMES = ("bounce", "warp_step", "draw")

# Launches of each kernel since the last reset_launch_counts(): the fused
# kernel in its main-path form (K1: none of the modes below), a launch
# adding one to each mode it runs: the rect / TRS sweeps (K8), the winner
# recording (K7), the texel fetch (K9), the segment level (K6), a bounce
# window (K10), front-to-back shells (K11), the bilinear triangle sweep
# (K12); and the draws (K2).  ``mega_regroup`` counts the compaction
# drivers' sorts of the keys between windows (``_next_order``), on either
# device.
LAUNCHES = {"mega_trace": 0, "mega_trace_xform": 0, "mega_winners": 0,
            "mega_trace_tex": 0, "mega_stream": 0, "mega_window": 0,
            "mega_f2b": 0, "mega_mxu": 0, "scatter_draws": 0,
            "mega_regroup": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class MegaTables(NamedTuple):
    sph: Tensor        # float32[S_pad, 16]
    sph_box: Tensor    # float32[S_pad / 16, 8] chunk boxes lo.xyz, hi.xyz
    sph_super: Tensor  # float32[S_pad / 256, 8], or [0, 8] (one level)
    tri: Tensor        # float32[T_pad, 24]
    tri_box: Tensor    # float32[T_pad / 16, 8]
    tri_super: Tensor  # float32[T_pad / 256, 8]
    rect: Tensor       # float32[R, 28]
    tsph: Tensor       # float32[TS, 28]
    ttri: Tensor       # float32[TT, 40]
    sph_seg: Tensor    # float32[S_pad / 2048, 8] above MAX_VMEM_PRIMS
                       # spheres (K6), else [0, 8]
    tri_seg: Tensor    # float32[T_pad / 2048, 8] likewise for triangles
    tri_coef: Tensor   # float32[T_pad / SUPER_T * N_COEF, SUPER_T] K12's
                       # coefficients (built with mxu=True), else
                       # [0, SUPER_T]
    sph_map: Tensor    # int32[S_pad] table row -> scene sphere id
    tri_map: Tensor    # int32[T_pad] table row -> scene triangle id
    rect_box: Tensor   # float32[ceil(R / XFORM_CHUNK), XBOX_COLS] K8's
                       # chunks of the rects (from XFORM_CULL_MIN rows),
                       # else [0, XBOX_COLS]
    tsph_box: Tensor   # likewise for the TRS spheres
    ttri_box: Tensor   # and the TRS triangles
    rect_ord: Tensor   # int32[R] the rects in their chunks' order (Morton
                       # of their world boxes), else [0]
    tsph_ord: Tensor
    ttri_ord: Tensor
    key_bounds: Tensor  # float32[2, 3] the box K10's keys quantize over
                        # (lo, span: _key_bounds)
    images: Tensor     # uint8[I, H, W, 3]: the scene's packed images, held
                       # by reference (I = 1: none registered, the dummy)
    n_spheres: int     # the scene's counts (the id offsets of the winners)
    n_triangles: int


FLOAT_TABLES = ("sph", "sph_box", "sph_super", "tri", "tri_box",
                "tri_super", "rect", "tsph", "ttri", "sph_seg", "tri_seg",
                "rect_box", "tsph_box", "ttri_box")
XFORM_CLASSES = ("rect", "tsph", "ttri")


def float_tables(tables: MegaTables) -> list:
    return [getattr(tables, k) for k in FLOAT_TABLES]


def table_bytes(tables: MegaTables) -> int:
    """Bytes of every table the kernel reads, the images aside (the texels
    a launch fetches are counted by the caller), and the key bounds aside
    (24 bytes, read by a window that writes keys)."""
    return sum(t.numel() * t.element_size() for t in tables
               if isinstance(t, torch.Tensor)
               and t is not tables.images and t is not tables.key_bounds)


def has_images(tables: MegaTables) -> bool:
    """The scene registers an image texture: launches take kernel mode K9
    (the normal integrator aside, which reads no texture)."""
    return tables.images.shape[0] > 1


def _unsupported(scene: Scene) -> Optional[str]:
    """Why the fused engine does not serve the scene, or None.  Above the
    ceiling ``integrators.integrate`` renders on the wavefront, as JAX's
    does; the fused entry points themselves raise."""
    if max(scene.n_spheres, scene.n_triangles) > MAX_STREAM_PRIMS:
        return (f"more than MAX_STREAM_PRIMS = {MAX_STREAM_PRIMS} spheres or "
                "triangles: the fused engine serves scenes up to this "
                "ceiling (integrate renders larger ones on the wavefront)")
    return None


def megakernel_supported(scene: Scene) -> bool:
    """Scenes the ported kernel modes serve: spheres and triangles (up to
    MAX_STREAM_PRIMS each, with the segment level above MAX_VMEM_PRIMS),
    rects and runtime-TRS prims (any count), constant, checker and image
    textures."""
    return _unsupported(scene) is None


def morton_order(v0, v1, v2) -> np.ndarray:
    """Host-side order of triangles by the 30-bit Morton code of their
    centroids (stable), so each chunk of 16 is spatially compact."""
    c = (np.asarray(v0) + np.asarray(v1) + np.asarray(v2)) / 3.0
    lo = c.min(axis=0)
    span = np.maximum(c.max(axis=0) - lo, 1e-20)
    q = np.clip(((c - lo) / span * 1023.0), 0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    code = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    return np.argsort(code, kind="stable").astype(np.int32)


def mega_sphere_order(centers) -> np.ndarray:
    """Host-side Morton order of sphere centers."""
    c = np.asarray(centers)
    return morton_order(c, c, c)


def mega_orders(host) -> tuple:
    """(triangle order, sphere order) of a scene whose fields hold numpy
    arrays (``to_numpy(scene)``, or a JAX scene's), None for a type the
    scene lacks."""
    tr, sp = host.triangles, host.spheres
    tri = morton_order(tr.v0, tr.v1, tr.v2) if len(tr.v0) else None
    sph = mega_sphere_order(sp.center) if len(sp.center) else None
    return tri, sph


def mxu_wanted(scene: Scene, cfg: RenderConfig) -> bool:
    """Whether renders of ``scene`` under ``cfg`` can take kernel mode K12,
    so that their tables need the coefficients: cfg.mega_mxu on a scene
    with streamed triangles (JAX :2754)."""
    return bool(cfg.mega_mxu) and scene.n_triangles > MAX_VMEM_PRIMS


def morton_tables(scene: Scene, mxu: bool = False) -> MegaTables:
    """``build_mega_tables`` with both prim types in Morton order: the
    tables every entry point renders from."""
    return build_mega_tables(scene, *mega_orders(to_numpy(scene)), mxu=mxu)


def _mat_lanes(scene: Scene, mat_id: Tensor) -> Tensor:
    """float32[N, 9] per-prim material block: kind, texture kind, aux
    (metal fuzz | dielectric ref_idx), color0, color1.  Metal's attenuation
    is its albedo, folded into color0 with a constant texture kind
    (megakernel.py:259-287): a metal ignores textures, also when its
    default tex_id points at an image.  An image texture uses neither
    colour, so its block carries the image id, w and h in color0."""
    m, t = scene.materials, scene.textures
    mat_id = mat_id.long()
    kind = m.kind[mat_id]
    tex_id = m.tex_id[mat_id].long()
    is_metal = kind == _mat.METAL
    img = t.image_id[tex_id].long()
    img_block = torch.cat([img[:, None], t.image_wh[img]], 1).to(
        torch.float32)
    is_img = (t.kind[tex_id] == _tex.IMAGE) & ~is_metal
    c0 = torch.where(is_metal[:, None], m.albedo[mat_id], t.color0[tex_id])
    c0 = torch.where(is_img[:, None], img_block, c0)
    tex_kind = torch.where(is_metal, _tex.CONSTANT, t.kind[tex_id])
    aux = torch.where(is_metal, m.fuzz[mat_id], m.ref_idx[mat_id])
    return torch.cat([kind.to(torch.float32)[:, None],
                      tex_kind.to(torch.float32)[:, None], aux[:, None], c0,
                      t.color1[tex_id]], dim=1)


def _xform_head(scene: Scene, trs, mat: Tensor):
    """(rotation matrices float32[K, 3, 3], the rows' shared head
    float32[K, 24]: position, scale, row-major rotation, material)."""
    R = v3.rotation_matrix_euler_deg(trs.rotation)
    return R, torch.cat([trs.position, trs.scale, R.reshape(-1, 9),
                         _mat_lanes(scene, mat)], dim=1)


@torch.no_grad()
def build_mega_tables(scene: Scene, tri_order: Optional[np.ndarray] = None,
                      sph_order: Optional[np.ndarray] = None,
                      mxu: bool = False,
                      xform_orders: Optional[dict] = None) -> MegaTables:
    """Pack the scene into the kernel's tables, on the scene's device (no
    autograd: the tables are a packing of the scene, and gradients reach
    the scene through the replay, ``trace_path_mega_diff``).

    tri_order / sph_order: optional host permutations (morton_order,
    mega_sphere_order) that make each chunk's box spatially compact, so
    that the box culling prunes.

    Above MAX_VMEM_PRIMS of a type (megakernel.py:339-393 of the JAX
    package): its rows are padded (repeat-last) to a SEG_T multiple, it
    gets one segment box per SEG_T rows, and spheres get the super level
    whatever their count.

    mxu: also build K12's coefficient rows ``tri_coef`` (``_tri_coef``).

    xform_orders: optional {"rect" | "tsph" | "ttri": permutation} in place
    of the Morton order of a class's rows in K8's chunks
    (``_xform_chunks``); any order gives the same result."""
    with profiling.span("mega.tables", spheres=scene.n_spheres,
                        triangles=scene.n_triangles):
        return _pack_tables(scene, tri_order, sph_order, mxu, xform_orders)


def _pack_tables(scene: Scene, tri_order, sph_order, mxu: bool,
                 xform_orders) -> MegaTables:
    """``build_mega_tables``' work."""
    reason = _unsupported(scene)
    if reason:
        raise NotImplementedError(reason)
    dev = scene.device
    n_s, n_t = scene.n_spheres, scene.n_triangles

    def perm(order):
        return torch.as_tensor(np.asarray(order), device=dev).long()

    def row_map(n, order, mult):
        m = (perm(order) if order is not None
             else torch.arange(n, device=dev))
        return pad_rows(m.to(torch.int32), mult)

    stream_sph, stream_tri = n_s > MAX_VMEM_PRIMS, n_t > MAX_VMEM_PRIMS
    sph_two_level = n_s > SPH_SUPER_MIN or stream_sph
    sph_mult = (SEG_T if stream_sph
                else SUPER_T if sph_two_level else PRIM_CHUNK)
    tri_mult = SEG_T if stream_tri else SUPER_T
    empty_box = torch.zeros(0, BOX_COLS, device=dev)
    no_map = torch.zeros(0, dtype=torch.int32, device=dev)
    no_coef = torch.zeros(0, SUPER_T, device=dev)
    if n_s:
        sp = scene.spheres
        center, radius, smat = sp.center, sp.radius, sp.mat
        if sph_order is not None:
            o = perm(sph_order)
            center, radius, smat = center[o], radius[o], smat[o]
        cols = torch.cat([center, (radius * radius)[:, None],
                          (1.0 / radius)[:, None], _mat_lanes(scene, smat)],
                         dim=1)
        sph_map = row_map(n_s, sph_order, sph_mult)
        sph = widen(pad_rows(cols, sph_mult), SPH_COLS)
        sph[:, S_ID] = sph_map.to(torch.float32)
        lo, hi = center - radius[:, None], center + radius[:, None]
        sph_box, sph_super, sph_seg = _levels(
            lo, hi, sph_mult, SPH_MARGIN,
            (PRIM_CHUNK, SUPER_T if sph_two_level else 0,
             SEG_T if stream_sph else 0))
    else:
        sph = torch.zeros(0, SPH_COLS, device=dev)
        sph_box = sph_super = sph_seg = empty_box
        sph_map = no_map
    if n_t:
        tr = scene.triangles
        v0, v1, v2, nrm, tmat = tr.v0, tr.v1, tr.v2, tr.normal, tr.mat
        if tri_order is not None:
            o = perm(tri_order)
            v0, v1, v2, nrm, tmat = v0[o], v1[o], v2[o], nrm[o], tmat[o]
        cols = torch.cat([v0, v1 - v0, v2 - v0, nrm, _mat_lanes(scene, tmat)],
                         dim=1)
        tri_map = row_map(n_t, tri_order, tri_mult)
        tri = widen(pad_rows(cols, tri_mult), TRI_COLS)
        tri[:, T_ID] = tri_map.to(torch.float32)
        lo = torch.minimum(torch.minimum(v0, v1), v2)
        hi = torch.maximum(torch.maximum(v0, v1), v2)
        tri_box, tri_super, tri_seg = _levels(
            lo, hi, tri_mult, TRI_MARGIN,
            (PRIM_CHUNK, SUPER_T, SEG_T if stream_tri else 0))
        tri_coef = (_tri_coef(v0, v1 - v0, v2 - v0, nrm, tri_mult) if mxu
                    else no_coef)
    else:
        tri = torch.zeros(0, TRI_COLS, device=dev)
        tri_box = tri_super = tri_seg = empty_box
        tri_map = no_map
        tri_coef = no_coef
    rect = torch.zeros(0, RECT_COLS, device=dev)
    tsph = torch.zeros(0, TSPH_COLS, device=dev)
    ttri = torch.zeros(0, TTRI_COLS, device=dev)
    xchunks = {}
    orders = xform_orders or {}
    if scene.n_rects:
        rc = scene.rects
        R, head = _xform_head(scene, rc.trs, rc.mat)
        sgn = torch.where(rc.flip, -1.0, 1.0)
        # world normal = R (0, 0, sgn): the rotation's third column
        rect = torch.cat([head, sgn[:, None], R[:, :, 2] * sgn[:, None]], 1)
        corners = torch.tensor([[-0.5, -0.5, 0.0], [0.5, -0.5, 0.0],
                                [-0.5, 0.5, 0.0], [0.5, 0.5, 0.0]],
                               device=dev)
        xchunks["rect"] = _xform_chunks(
            _world(R, rc.trs.position, corners[None].expand(
                len(R), 4, 3)), 0.0, rc.trs.scale, orders.get("rect"))
    if scene.n_t_spheres:
        ts = scene.t_spheres
        R, head = _xform_head(scene, ts.trs, ts.mat)
        tsph = widen(torch.cat([head, (ts.radius * ts.radius)[:, None],
                                (1.0 / ts.radius)[:, None]], 1), TSPH_COLS)
        xchunks["tsph"] = _xform_chunks(
            _world(R, ts.trs.position, torch.zeros(len(R), 1, 3,
                                                   device=dev)),
            ts.radius.abs(), ts.trs.scale, orders.get("tsph"))
    if scene.n_t_triangles:
        tt = scene.t_triangles
        R, head = _xform_head(scene, tt.trs, tt.mat)
        n = tt.normal
        n_w = torch.stack(rotate_rows(
            [R[:, i, j] for i in range(3) for j in range(3)],
            n[:, 0], n[:, 1], n[:, 2]), 1)
        ttri = widen(torch.cat([head, tt.v0, tt.v1 - tt.v0, tt.v2 - tt.v0,
                                n, n_w], 1), TTRI_COLS)
        xchunks["ttri"] = _xform_chunks(
            _world(R, tt.trs.position, torch.stack([tt.v0, tt.v1, tt.v2],
                                                   1)), 0.0, tt.trs.scale,
            orders.get("ttri"))
    no_xbox = torch.zeros(0, XBOX_COLS, device=dev)
    no_ord = torch.zeros(0, dtype=torch.int32, device=dev)
    xbox, xord = zip(*(xchunks.get(k, (no_xbox, no_ord))
                       for k in XFORM_CLASSES))
    return MegaTables(*(x.contiguous() for x in (
        sph, sph_box, sph_super, tri, tri_box, tri_super, rect, tsph, ttri,
        sph_seg, tri_seg, tri_coef, sph_map, tri_map, *xbox, *xord,
        _key_bounds(sph_box, tri_super), scene.textures.images)), n_s, n_t)


def _levels(lo: Tensor, hi: Tensor, mult: int, margin: float,
            groups: tuple) -> list:
    """The box levels of prims padded to ``mult`` (chunk, super, segment:
    one box per ``groups[i]`` prims, or float32[0, 8] where it is 0), each
    box widened by ``margin`` x its largest |coordinate| (ops/sweeps.py
    TRI_MARGIN, SPH_MARGIN): the exact boxes of the TPU tables lose hits
    that the tests accept an ulp outside their prims' box (triangles) or
    on a line that misses the sphere by a rounding (spheres)."""
    return [widen_boxes(group_boxes(lo, hi, g, mult), margin) if g
            else lo.new_zeros(0, BOX_COLS) for g in groups]


def _world(R: Tensor, pos: Tensor, pts: Tensor) -> Tensor:
    """Points float32[K, P, 3] of each row's object space -> the world
    points M^T (q + p) where its hits lie (M the row-major rotation, p the
    position; XFORM_MARGIN)."""
    return torch.einsum("kij,kpi->kpj", R, pts + pos[:, None, :])


def _xform_chunks(world: Tensor, radius, scale: Tensor,
                  order=None) -> tuple:
    """K8's chunks of one class of K rows (``XFORM_CULL_MIN`` rows and up,
    else none): each row's world object (the points ``world`` float32[K, P,
    3], each grown by ``radius``, float32[K] or 0: a TRS sphere's centre
    and radius), ordered by the Morton code of its box's centre, cut into
    chunks of XFORM_CHUNK rows -> (boxes float32[ceil(K / XFORM_CHUNK),
    XBOX_COLS]: the chunk's world box widened by XFORM_MARGIN x its largest
    |coordinate|, its rows' scale range a, b and max b; rows int32[K] in
    that order; ``order``, a permutation of the rows, in place of the
    Morton order).  A chunk with a scale component that is not positive
    and finite gets an infinite box, which no ray culls."""
    k = world.shape[0]
    if k < XFORM_CULL_MIN:
        return (world.new_zeros(0, XBOX_COLS),
                torch.zeros(0, dtype=torch.int32, device=world.device))
    r = torch.as_tensor(radius, dtype=world.dtype, device=world.device)
    r = r.reshape(-1, 1).expand(k, 3) if r.dim() else r
    lo, hi = world.amin(1) - r, world.amax(1) + r
    order = (morton_argsort((lo + hi) * 0.5) if order is None
             else torch.as_tensor(order, device=world.device).long())
    lo, hi, sc = (pad_rows(x[order], XFORM_CHUNK).view(-1, XFORM_CHUNK, 3)
                  for x in (lo, hi, scale))
    box = widen_boxes(widen(torch.cat([lo.amin(1), hi.amax(1)], 1),
                            BOX_COLS), XFORM_MARGIN)[:, :6]
    a, b = sc.amin(1), sc.amax(1)
    ok = ((a > 0.0) & torch.isfinite(b)).all(1, keepdim=True)
    inf = torch.full_like(box, math.inf)
    box = torch.where(ok, box, torch.cat([-inf[:, :3], inf[:, 3:]], 1))
    a, b = torch.where(ok, a, 1.0), torch.where(ok, b, 1.0)
    out = torch.cat([box, a, b, b.amax(1, keepdim=True),
                     box.new_zeros(box.shape[0], XBOX_COLS - 13)], 1)
    return out, order.to(torch.int32)


def _key_bounds(sph_box: Tensor, tri_super: Tensor) -> Tensor:
    """The box over which the regrouping keys (K10) quantize origins: the
    union of the sphere chunk boxes and the triangle super boxes ->
    float32[2, 3] (lo, span), span at least 1e-20 (a unit box for a scene
    without them).  The JAX package quantizes over the alive origins' own
    range, which needs a pass over every ray before the keys; the scene's
    box holds the hit points, and changes which rays share a warp, never a
    result.  The boxes carry their margins (``_levels``), so the keys move
    with them against exact boxes': that regroups rays, and no result
    changes."""
    boxes = torch.cat([sph_box, tri_super])
    if not boxes.shape[0]:
        return torch.stack([boxes.new_zeros(3), boxes.new_ones(3)])
    lo = boxes[:, 0:3].amin(0)
    return torch.stack([lo, torch.clamp(boxes[:, 3:6].amax(0) - lo,
                                        min=1e-20)])


def _tri_coef(v0: Tensor, e1: Tensor, e2: Tensor, nrm: Tensor,
              mult: int) -> Tensor:
    """K12's coefficients (megakernel.py:394-418 of the JAX package): per
    triangle the non-zero coefficients of its N_Q quantities on Phi
    (Q_TERMS, in that order, then 2 zeros), padded (repeat last) to
    ``mult`` triangles, then per SUPER_T triangles one plane per
    coefficient -> float32[T_pad / SUPER_T * N_COEF, SUPER_T].  The cross
    products are spelled out (jnp.cross's component formulas)."""
    def cross(a, b):
        return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                            a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                            a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], 1)

    n2 = cross(e1, e2)
    v0_n2 = (v0[:, 0] * n2[:, 0] + v0[:, 1] * n2[:, 1]
             + v0[:, 2] * n2[:, 2])[:, None]
    q = torch.cat([
        -n2,                                 # a on d
        n2, -v0_n2,                          # t_num on o, 1
        cross(v0, e2), -e2,                  # u_num on d, c
        -cross(v0, e1), e1,                  # v_num on d, c
        nrm,                                 # d.n on d
        torch.zeros_like(v0[:, :N_COEF - Q_OFF[Q_DN] - 3])], 1)
    q = pad_rows(q, mult)
    return (q.reshape(-1, SUPER_T, N_COEF).transpose(1, 2)
            .reshape(-1, SUPER_T).contiguous())


def dense_tri_coef(tri_coef: Tensor) -> Tensor:
    """``tri_coef`` unpacked into JAX's dense rows (its first N_FEAT lanes):
    per SUPER_T triangles one block of SUPER_T rows per quantity ->
    float32[N_Q * T_pad, N_FEAT], zero off Q_TERMS."""
    planes = tri_coef.view(-1, N_COEF, SUPER_T)
    out = planes.new_zeros(planes.shape[0], N_Q, SUPER_T, N_FEAT)
    for q, terms in enumerate(Q_TERMS):
        for j, k in enumerate(terms):
            out[:, q, :, k] = planes[:, Q_OFF[q] + j]
    return out.reshape(-1, N_FEAT)


def draw_seed(generator: torch.Generator) -> int:
    """A 62-bit seed for the in-kernel draws, from the generator."""
    return int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device).item())


def stream_tensor(samples, n: int, steps: int) -> Tensor:
    """SampleStream -> the kernel's float32[steps, n, 4] (ball xyz, prob)."""
    ball, prob = samples
    if ball.shape != (steps, n, 3) or prob.shape != (steps, n):
        raise ValueError(f"stream shapes {tuple(ball.shape)}, "
                         f"{tuple(prob.shape)} do not fit {steps} steps x "
                         f"{n} rays")
    return torch.cat([ball, prob[..., None]], dim=-1).to(
        torch.float32).contiguous()


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------

def _library() -> ctypes.CDLL:
    lib = _cuda.load("megakernel")
    if not getattr(lib, "_crt_declared", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.crt_mega_trace.argtypes = (
            [vp] * 17 + [ci] * 11 + [cf] * 3
            + [ci, ctypes.c_uint64, vp, ci, ci]
            + [vp] * 2 + [ci] * 5 + [vp] * 3 + [ci] + [vp] * 5
            + [ci] + [vp] * 6 + [ci] * 3 + [vp])
        lib.crt_mega_trace.restype = ci
        lib.crt_mega_path_instance.argtypes = [ci] * 7 + [ctypes.POINTER(ci)]
        lib.crt_mega_path_instance.restype = ci
        lib.crt_scatter_draws.argtypes = [vp, ci, ci, ctypes.c_uint64, ci,
                                          vp]
        lib.crt_scatter_draws.restype = ci
        lib.crt_error_string.argtypes = [ci]
        lib.crt_error_string.restype = ctypes.c_char_p
        lib._crt_declared = True
    return lib


def path_instance(n: int, device=None, *, xform: bool = False,
                  shells: bool = False, count: bool = False,
                  window: bool = False, winners: bool = False,
                  tex: bool = False) -> dict:
    """The mega_path instance that a path launch of n rays one thread per
    ray takes on ``device`` (default the current card), launching nothing:
    its grid blocks, threads a block, resident blocks an SM, the card's SMs,
    the instance's registers and local memory bytes a thread, and the
    refill threshold the sources were built with.  xform: the scene has
    rects or TRS prims (K8); shells: front-to-back shells (K11); count: the
    counting variant; window: a bounce window (K10); winners: K7; tex: K9."""
    lib = _library()
    v = (ctypes.c_int * 7)()
    with torch.cuda.device(device):
        code = lib.crt_mega_path_instance(
            int(xform), int(shells), int(count), int(window), int(winners),
            int(tex), n, v)
    if code != 0:
        raise RuntimeError("path instance query failed: "
                           f"{lib.crt_error_string(code).decode()}")
    keys = ("grid_blocks", "block", "blocks_per_sm", "sms", "registers",
            "local_bytes", "refill_idle")
    return dict(zip(keys, v))


def _check(lib, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.crt_error_string(code).decode()}")


def _require_cuda(name: str, x: Tensor, dtype=torch.float32,
                  shape=None) -> None:
    if not x.is_cuda or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} CUDA tensor; "
                         f"got {x.dtype} on {x.device}")
    if x.numel() and x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")


def _require_cuda_f32(name: str, x: Tensor, shape=None) -> None:
    _require_cuda(name, x, torch.float32, shape)


class _TableArgs(NamedTuple):
    """What a launch passes the C entry from its tables, in its order."""
    head: tuple        # the 9 float tables, sph_map, tri_map (pointers)
    counts: tuple      # sphere chunks and supers, triangle supers, rects,
                       # TRS spheres, TRS triangles, the scene's counts
    images: int        # the packed images (pointer)
    image_hw: tuple
    segs: tuple        # segment tables (pointers) and their counts
    key_bounds: int
    xform: tuple       # K8's chunk boxes, row orders (pointers), chunks
    n_xform: int       # rect / TRS rows


# The tables launches have checked, by the id of their MegaTables: weak
# references to its tensors, the device, and its _TableArgs, so that the
# launches of a render check a table set once.  An entry is used only while
# every tensor of the tables is the one it checked.
_CHECKED: dict = {}
_CHECKED_MAX = 16


def _table_args(tables: MegaTables, device) -> _TableArgs:
    """The tables' _TableArgs, after checking every table is a contiguous
    16-byte aligned CUDA tensor of its dtype on ``device`` (once per table
    set, ``_CHECKED``)."""
    tensors = tables[:-2]
    hit = _CHECKED.get(id(tables))
    if (hit is not None and hit[1] == device
            and all(r() is t for r, t in zip(hit[0], tensors))):
        return hit[2]
    ints = ("sph_map", "tri_map") + tuple(k + "_ord" for k in XFORM_CLASSES)
    for name in FLOAT_TABLES + ("key_bounds",) + ints:
        t = getattr(tables, name)
        _require_cuda(name, t, torch.int32 if name in ints
                      else torch.float32)
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, rays on {device}")
    images = tables.images
    if (images.dtype != torch.uint8 or images.device != device
            or not images.is_contiguous()):
        raise ValueError(f"images must be a contiguous uint8 tensor on "
                         f"{device}; got {images.dtype} on {images.device}")
    boxes = [getattr(tables, k + "_box") for k in XFORM_CLASSES]
    args = _TableArgs(
        tuple(getattr(tables, k).data_ptr() for k in FLOAT_TABLES[:9])
        + (tables.sph_map.data_ptr(), tables.tri_map.data_ptr()),
        (tables.sph_box.shape[0], tables.sph_super.shape[0],
         tables.tri_super.shape[0], tables.rect.shape[0],
         tables.tsph.shape[0], tables.ttri.shape[0], tables.n_spheres,
         tables.n_triangles),
        tables.images.data_ptr(), tuple(tables.images.shape[1:3]),
        (tables.sph_seg.data_ptr(), tables.tri_seg.data_ptr(),
         tables.sph_seg.shape[0], tables.tri_seg.shape[0]),
        tables.key_bounds.data_ptr(),
        tuple(b.data_ptr() for b in boxes)
        + tuple(getattr(tables, k + "_ord").data_ptr()
                for k in XFORM_CLASSES)
        + tuple(b.shape[0] for b in boxes),
        sum(getattr(tables, k).shape[0] for k in XFORM_CLASSES))
    if len(_CHECKED) >= _CHECKED_MAX:
        _CHECKED.pop(next(iter(_CHECKED)))
    _CHECKED[id(tables)] = (tuple(weakref.ref(t) for t in tensors), device,
                            args)
    return args


def _use_mxu(tables: MegaTables, cfg: RenderConfig,
             want_winners: bool) -> bool:
    """Whether a launch takes kernel mode K12, as JAX's ``_mega_call``
    decides (:2605-2618): cfg.mega_mxu on streamed triangle tables (above
    MAX_VMEM_PRIMS), never while recording winners (K7) or fetching texels
    (K9; JAX's want_tex implies want_winners).  Tables without the
    coefficients raise."""
    mxu = (bool(cfg.mega_mxu) and tables.n_triangles > MAX_VMEM_PRIMS
           and not want_winners
           and not (has_images(tables) and cfg.integrator != "normal"))
    if mxu and tables.tri_coef.numel() != N_COEF * tables.tri.shape[0]:
        raise ValueError(
            "cfg.mega_mxu requires coefficient tables: rebuild with "
            "build_mega_tables(scene, ..., mxu=True)")
    return mxu


def launch_modes(tables: MegaTables, cfg: RenderConfig,
                 want_winners: bool) -> tuple:
    """(tex, mxu, f2b) of a launch on these tables: whether it fetches
    texels (K9: a scene with images, the normal integrator aside), takes
    the bilinear sweep (K12, ``_use_mxu``) and how many front-to-back
    shells order its triangle sweep (K11: none without triangles or under
    K12, JAX :2643)."""
    mxu = _use_mxu(tables, cfg, want_winners)
    f2b = cfg.mega_f2b_shells if tables.tri.shape[0] and not mxu else 0
    return has_images(tables) and cfg.integrator != "normal", mxu, f2b


def _flags(cfg: RenderConfig, injected: bool) -> int:
    q = cfg.quirks
    return ((F_BACKFACE_ONLY if q.triangle_backface_only else 0)
            | (F_NO_T_CLIP if q.triangle_no_t_clip else 0)
            | (F_BACK_CULLING if q.triangle_back_culling else 0)
            | (F_DIE_REF_COSINE if q.dielectric_reference_cosine else 0)
            | (F_LAMBERT_UNNORM if q.lambert_unnormalized_dot else 0)
            | (F_LAMBERT_ZERO_UV if q.lambertian_zero_uv else 0)
            | (F_INJECTED if injected else 0))


class Window(NamedTuple):
    """A bounce window of the path integrator (kernel mode K10): global
    steps [step_lo, step_lo + n_steps).

    planes: the path state float32[N_PLANES, N] [rad rgb | o | d | thr rgb |
    alive], one column per ray id, updated in place: a window at step 0
    starts each ray from its camera ray and writes the column; a later one
    resumes the rays alive in their columns, adds its radiance to rad and
    writes o, d, thr and alive back, and leaves a dead ray's column as it
    is.  Without planes a window at step 0 returns the radiance of its
    steps.  order: int32[N], position i serves ray order[i] (a
    permutation; None: ray i); the draws are keyed by (seed, ray, step) and
    the injected stream is read at the ray's row, so any order gives the
    same planes.  key: int32[N], filled at each resumed or started ray's
    column with its key for the next window's order (``regroup_keys`` in
    ``key_mode``, quantized over ``MegaTables.key_bounds``); a dead ray
    keeps the DEAD_KEY its last window wrote."""
    step_lo: int = 0
    n_steps: Optional[int] = None
    planes: Optional[Tensor] = None
    order: Optional[Tensor] = None
    key: Optional[Tensor] = None
    key_mode: int = KEY_ALIVE

    def steps(self, cfg: RenderConfig) -> int:
        return (self.n_steps if self.n_steps is not None
                else cfg.max_depth + 1 - self.step_lo)

    def partial(self, cfg: RenderConfig) -> bool:
        """Whether this is more than the whole path from scratch."""
        return (self.planes is not None or self.step_lo != 0
                or self.steps(cfg) != cfg.max_depth + 1)


WHOLE = Window()


def _check_window(win: Window, cfg: RenderConfig, n: int,
                  want_winners: bool) -> int:
    """Validate a window against the config and the ray count -> its step
    count."""
    steps = win.steps(cfg)
    if win.step_lo < 0 or steps < 1 or win.step_lo + steps > cfg.max_depth + 1:
        raise ValueError(f"window [{win.step_lo}, {win.step_lo + steps}) "
                         f"outside the {cfg.max_depth + 1} bounce steps")
    if win.partial(cfg) and (cfg.integrator != "path" or want_winners):
        raise ValueError("a bounce window needs the path integrator and "
                         "records no winners")
    if win.planes is None and (win.step_lo > 0 or win.order is not None
                               or win.key is not None):
        raise ValueError("a window after step 0, an order and keys need the "
                         "state's planes")
    for name, shape in (("planes", (N_PLANES, n)), ("order", (n,)),
                        ("key", (n,))):
        x = getattr(win, name)
        if x is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name} of shape {tuple(x.shape)}, expected "
                             f"{shape}")
    if win.key is not None and win.key_mode not in (KEY_ALIVE, KEY_OCTANT,
                                                    KEY_MORTON):
        raise ValueError(f"key mode {win.key_mode}")
    return steps


def _launch_mega(tables: MegaTables, origin: Tensor, direction: Tensor,
                 cfg: RenderConfig, stream: Optional[Tensor], seed: int,
                 counts: Optional[Tensor] = None,
                 want_winners: bool = False, window: Window = WHOLE,
                 touched: Optional[Tensor] = None, per_thread: bool = False,
                 work: Optional[Tensor] = None):
    """One launch of the CUDA kernel -> radiance float32[N, 3] (with
    ``window.planes`` the planes, updated in place), and with want_winners
    (path only) the winners int32[max_depth + 1, N] in scene prim ids, -1
    for a miss or a dead lane.

    stream: optional injected draws float32[max_depth + 1, N, 4], read at
    the row of the ray a thread serves.  The triangle sweep visits its
    top-level boxes in cfg.mega_f2b_shells shells (K11; the cooperative
    sweep ranks at most MAX_SHELLS, more run one thread per ray), or under
    ``_use_mxu`` evaluates the coefficient rows in table order with no
    shells (K12).

    counts: optional int64[N_COUNTS] CUDA tensor that the kernel adds its
    tests to (COUNT_NAMES), and the optional ``touched`` uint8[max(sphere
    chunks + triangle chunks, 1)] that it sets to 1 for each chunk whose
    prims it tested (measurement only: given, a separately compiled counting variant runs;
    the production variants count nothing).  The counting variant fetches
    no texel: textures never change a path (every material's scatter and
    its end are independent of the colour), so it makes the tests of the
    launch it stands for, and its radiance is not the scene's.  It also
    adds its schedule to the optional ``work`` int64[N_WORK] (WORK_NAMES;
    a scratch tensor when not given).

    The path integrator one thread per ray runs on persistent warps that
    take their rays from an int32 counter, which this wrapper allocates and
    its C entry zeroes on the launch's stream right before a launch that
    reads it (``csrc/megakernel.cuh``, mega_path).

    A scene with images takes kernel mode K9 (the normal integrator, which
    reads no texture, aside).

    per_thread: where the launch would sweep its triangles cooperatively
    (the path integrator above MAX_VMEM_PRIMS triangles; K12, counting
    only), sweep them one thread per ray instead: the same tests and
    results, for holding the cooperative sweeps against."""
    n = origin.shape[0]
    steps = _check_window(window, cfg, n, want_winners)
    _require_cuda_f32("origin", origin, (n, 3))
    _require_cuda_f32("direction", direction, (n, 3))
    targs = _table_args(tables, origin.device)
    tex, mxu, f2b = launch_modes(tables, cfg, want_winners)
    if stream is not None:
        _require_cuda_f32("stream", stream, (cfg.max_depth + 1, n, 4))
    for name, dtype in (("planes", torch.float32), ("order", torch.int32),
                        ("key", torch.int32)):
        x = getattr(window, name)
        if x is not None:
            _require_cuda(name, x, dtype)
            if x.device != origin.device:
                raise ValueError(f"{name} is on {x.device}, rays on "
                                 f"{origin.device}")
    if counts is not None:
        n_chunks = max(tables.sph_box.shape[0] + tables.tri_box.shape[0], 1)
        _require_cuda("counts", counts, torch.int64, (N_COUNTS,))
        if touched is None:
            touched = torch.zeros(n_chunks, dtype=torch.uint8,
                                  device=origin.device)
        _require_cuda("touched", touched, torch.uint8, (n_chunks,))
        if work is None:
            work = torch.zeros(N_WORK, dtype=torch.int64,
                               device=origin.device)
        _require_cuda("work", work, torch.int64, (N_WORK,))
    if want_winners and (cfg.integrator != "path" or counts is not None):
        raise ValueError("winners are recorded by the path integrator's "
                         "production variant only")
    if n >= 2 ** 31:
        raise ValueError(f"{n} rays exceed one launch")
    # mega_path's int32 counter passes n by at most 32 a warp, 128 a block,
    # on at most ceil(n / 128) blocks
    if cfg.integrator == "path" and n + 128 * -(-n // 128) >= 2 ** 31:
        raise ValueError(f"{n} rays exceed one path launch's counter")
    planes = window.planes
    out = (planes if planes is not None else
           torch.empty((n, 3), dtype=torch.float32, device=origin.device))
    winners = (torch.empty((cfg.max_depth + 1, n), dtype=torch.int32,
                           device=origin.device) if want_winners else None)
    if mxu and per_thread and counts is None:
        raise ValueError("K12's one-thread-per-ray sweep has a counting "
                         "instance only")
    if mxu:
        _require_cuda_f32("tri_coef", tables.tri_coef,
                          (N_COEF * tables.tri.shape[0] // SUPER_T, SUPER_T))
        if tables.tri_coef.device != origin.device:
            raise ValueError(f"tri_coef is on {tables.tri_coef.device}, "
                             f"rays on {origin.device}")
    def ptr(x):
        return x.data_ptr() if x is not None else None

    lib = _library()
    with torch.cuda.device(origin.device):
        cuda_stream = torch.cuda.current_stream().cuda_stream
        counter = (torch.empty(1, dtype=torch.int32, device=origin.device)
                   if cfg.integrator == "path" else None)
        code = lib.crt_mega_trace(
            *targs.head, origin.data_ptr(), direction.data_ptr(),
            ptr(stream), ptr(out) if planes is None else None, ptr(winners),
            ptr(counts), n, *targs.counts, INTEGRATOR_IDS[cfg.integrator],
            cfg.max_depth, float(np.float32(cfg.t_min)),
            float(np.float32(cfg.t_max)),
            float(cfg.quirks.ambient_on_absorb),
            _flags(cfg, stream is not None), seed & (2 ** 64 - 1),
            targs.images if tex and counts is None else None,
            *targs.image_hw, *targs.segs, f2b,
            window.step_lo, steps, ptr(planes), ptr(window.order),
            ptr(window.key), window.key_mode, targs.key_bounds,
            tables.tri_coef.data_ptr() if mxu else None,
            ptr(touched), ptr(work), ptr(counter), int(per_thread),
            *targs.xform, cuda_stream)
    _check(lib, code, "megakernel")
    if counts is None:
        modes = [k for k, on in (("mega_trace_xform", targs.n_xform),
                                 ("mega_winners", want_winners),
                                 ("mega_trace_tex", tex),
                                 ("mega_stream", targs.segs[2]
                                  + targs.segs[3]),
                                 ("mega_window", window.partial(cfg)),
                                 ("mega_f2b", f2b),
                                 ("mega_mxu", mxu)) if on]
        for k in modes or ["mega_trace"]:
            LAUNCHES[k] += 1
    return (out, winners) if want_winners else out


def scatter_draws(out: Tensor, seed: int, step: int = 0) -> Tensor:
    """Fill ``out`` with the kernel's draws (unit-ball xyz, uniform) for ray
    indices 0..n-1: float32[n, 4] at bounce ``step``, or float32[S, n, 4] at
    bounces step .. step + S - 1 (one launch for every bounce of a trace:
    S x n x 16 bytes, 37.7 MB for 2^18 rays and 9 bounces).  The CUDA
    kernel for a CUDA tensor, ``scatter_draws_plain`` for a CPU tensor."""
    steps = out.shape[0] if out.dim() == 3 else None
    n = out.shape[-2]
    if step < 0:
        raise ValueError(f"step {step} is negative")
    if out.device.type == "cpu":
        out.copy_(scatter_draws_plain(n, seed, step, out.device, steps))
        return out
    _require_cuda_f32("out", out, (n, 4) if steps is None else (steps, n, 4))
    if n > 2 ** 30:
        raise ValueError(f"{n} rays exceed one draws launch")
    lib = _library()
    with torch.cuda.device(out.device):
        code = lib.crt_scatter_draws(
            out.data_ptr(), n, steps or 1, seed & (2 ** 64 - 1), step,
            torch.cuda.current_stream().cuda_stream)
    _check(lib, code, "scatter_draws")
    LAUNCHES["scatter_draws"] += 1
    return out


def scatter_draws_plain(n: int, seed: int, step: int, device,
                        steps: Optional[int] = None) -> Tensor:
    """Plain version of the scatter_draws kernel: float32[n, 4] at bounce
    ``step``, or with ``steps`` float32[steps, n, 4] at bounces step ..
    step + steps - 1, every (ray, bounce) counter in one pass."""
    index = torch.arange(n, device=device)
    if steps is None:
        ball, prob = _rng.counter_draws(seed, index, step)
        return torch.cat([ball, prob[:, None]], dim=1)
    bounce = torch.arange(step, step + steps, device=device)
    ball, prob = _rng.counter_draws(seed, index.repeat(steps),
                                    bounce.repeat_interleave(n))
    return torch.cat([ball, prob[:, None]], dim=1).view(steps, n, 4)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _resolve_seed(cfg: RenderConfig, injected: bool, seed: Optional[int],
                  generator: Optional[torch.Generator]) -> int:
    """The in-kernel draws' seed: given, or drawn from the generator (the
    path integrator without an injected stream); 0 where nothing draws."""
    if cfg.integrator == "path" and not injected and seed is None:
        if generator is None:
            raise ValueError("the path integrator needs samples, a seed or "
                             "a generator")
        seed = draw_seed(generator)
    return 0 if seed is None else seed


def _trace(tables: MegaTables, o: Tensor, d: Tensor, cfg: RenderConfig,
           stream: Optional[Tensor], seed: int, want_winners: bool = False,
           window: Window = WHOLE):
    """The kernel on CUDA rays, its plain version on CPU rays; either in a
    ``mega.window`` span (a monolithic launch is one window of every
    step)."""
    with profiling.span("mega.window", device=o.device,
                        step_lo=window.step_lo, steps=window.steps(cfg),
                        rays=o.shape[0]):
        if o.device.type == "cpu":
            return trace_path_mega_plain(tables, Rays(o, d, o.new_zeros(0)),
                                         cfg, stream, seed, want_winners,
                                         window)
        return _launch_mega(tables, o.contiguous(), d.contiguous(), cfg,
                            stream, seed, want_winners=want_winners,
                            window=window)


def trace_path_mega(scene: Scene, rays: Rays, cfg: RenderConfig,
                    tables: Optional[MegaTables] = None, samples=None,
                    generator: Optional[torch.Generator] = None,
                    seed: Optional[int] = None, want_winners: bool = False,
                    window: Window = WHOLE):
    """Fused integrator (cfg.integrator: path / lambert / normal) ->
    radiance float32[N, 3].

    samples: optional injected SampleStream (ball [D+1, N, 3], prob [D+1,
    N], row r for ray r); otherwise the path integrator draws in-kernel
    from ``seed``, itself drawn from ``generator`` when not given.  lambert
    and normal draw nothing.  want_winners (path only): return (radiance,
    winners int32[max_depth + 1, N]), each bounce's winner in the scene's
    prim ids [spheres | triangles | rects | t_spheres | t_triangles], -1
    for a miss or a dead lane (megakernel.py:2731-2793).  window (path
    only, kernel mode K10): a bounce window; with its planes, the planes
    (updated in place) are returned in place of the radiance.
    cfg.mega_f2b_shells orders the triangle sweep's top-level boxes (K11);
    cfg.mega_mxu takes kernel mode K12 on streamed triangles
    (``_use_mxu``), the tables built here with the coefficients when none
    are given (JAX :2754)."""
    check_supported(cfg)
    if want_winners and cfg.integrator != "path":
        raise ValueError("want_winners needs the path integrator")
    if tables is None:
        tables = build_mega_tables(
            scene, mxu=mxu_wanted(scene, cfg) and not want_winners)
    n = rays.origin.shape[0]
    injected = samples is not None and cfg.integrator == "path"
    seed = _resolve_seed(cfg, injected, seed, generator)
    stream = None
    if injected:
        stream = stream_tensor(samples, n, cfg.max_depth + 1)
    return _trace(tables, rays.origin, rays.direction, cfg, stream, seed,
                  want_winners, window)


def _leaves(record) -> list:
    """The tensors of a NamedTuple tree, depth first."""
    out = []
    for x in record:
        out.extend([x] if isinstance(x, torch.Tensor) else _leaves(x))
    return out


def _rebuild(record, it):
    return type(record)(*(next(it) if isinstance(x, torch.Tensor)
                          else _rebuild(x, it) for x in record))


@dataclasses.dataclass
class _DiffCall:
    """What the replay backward needs beside the scene's grad leaves."""
    scene: Scene
    rays: Rays
    cfg: RenderConfig
    tables: MegaTables
    samples: object
    seed: Optional[int]
    grad_at: list          # positions of the grad leaves in _leaves(scene)
    mesh: object = None    # the replay's mesh under cfg.grad_sync_axes


class _MegaDiff(torch.autograd.Function):
    """The fused forward and the replay backward of engine='mega_diff'
    (megakernel.py:2025-2070)."""

    @staticmethod
    def forward(ctx, call: _DiffCall, *leaves):
        replay = call.cfg.mega_replay_bwd
        out = trace_path_mega(call.scene, call.rays, call.cfg,
                              tables=call.tables, samples=call.samples,
                              seed=call.seed, want_winners=replay)
        rad, ctx.winners = out if replay else (out, None)
        ctx.call = call
        ctx.save_for_backward(*leaves)
        return rad

    @staticmethod
    def backward(ctx, g):
        from . import integrators as _integ
        from .render import sweep_intersector_pair
        call = ctx.call
        cfg = dataclasses.replace(call.cfg, engine="wavefront",
                                  wavefront_tpu_prng=True)
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() for x in ctx.saved_tensors]
            all_leaves = [x.detach() for x in _leaves(call.scene)]
            for k, x in zip(call.grad_at, leaves):
                all_leaves[k] = x
            scene = _rebuild(call.scene, iter(all_leaves))
            rays = Rays(*(x.detach() for x in call.rays))
            isect = (None if ctx.winners is not None
                     else sweep_intersector_pair(cfg))
            rad = _integ.trace_path(scene, rays, cfg, intersect_fn=isect,
                                    samples=call.samples, seed=call.seed,
                                    winners=ctx.winners, mesh=call.mesh)
            grads = torch.autograd.grad(rad, leaves, g, allow_unused=True)
        return (None,) + tuple(torch.zeros_like(x) if gx is None else gx
                               for x, gx in zip(leaves, grads))


def trace_path_mega_diff(scene: Scene, rays: Rays, cfg: RenderConfig,
                         tables: Optional[MegaTables] = None, samples=None,
                         generator: Optional[torch.Generator] = None,
                         seed: Optional[int] = None, mesh=None) -> Tensor:
    """The differentiable fused path integrator (engine='mega_diff',
    megakernel.py:2073) -> radiance float32[N, 3].

    Forward: one launch of the fused kernel.  When gradients are asked (grad
    mode on and some scene tensor requires grad) it records each bounce's
    winner (K7), and the backward re-runs the wavefront ``trace_path`` on
    those winners only (``intersect.replay_hits``), or with
    cfg.mega_replay_bwd False on the full sweeps.  Both sides read the same
    draws: the injected ``samples``, or the counter draws of one ``seed``
    (in the kernel, and through the draws kernel K2 in the replay), so no
    stream is materialized.  The tables get no gradient; pass tables
    rebuilt from the current scene (a fit moves it).  Gradients reach the
    scene's tensors, not the rays.  mesh: the replay's mesh under
    cfg.grad_sync_axes (its bounces average the cotangents)."""
    check_supported(cfg)
    if cfg.integrator != "path":
        raise ValueError("engine='mega_diff' pairs only the path integrator")
    leaves = _leaves(scene)
    grad_at = [k for k, x in enumerate(leaves) if x.requires_grad]
    grad = torch.is_grad_enabled() and bool(grad_at)
    if tables is None:
        # a recording forward never runs K12 (JAX :2609)
        tables = build_mega_tables(scene, mxu=mxu_wanted(scene, cfg) and not (
            grad and cfg.mega_replay_bwd))
    if samples is None and seed is None:
        if generator is None:
            raise ValueError("the path integrator needs samples, a seed or "
                             "a generator")
        seed = draw_seed(generator)
    if not grad:
        return trace_path_mega(scene, rays, cfg, tables=tables,
                               samples=samples, seed=seed)
    call = _DiffCall(scene, rays, cfg, tables, samples, seed, grad_at, mesh)
    return _MegaDiff.apply(call, *(leaves[k] for k in grad_at))


# ---------------------------------------------------------------------------
# The compaction drivers (kernel mode K10) and their routing
# ---------------------------------------------------------------------------

def _spread10(v: Tensor) -> Tensor:
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


def regroup_keys(o: Tensor, d: Tensor, alive: Tensor, mode: int,
                 bounds: Tensor) -> Tensor:
    """Plain version of the kernel's regrouping keys (K10) of rays at the
    end of a window, origins and directions float32[N, 3] -> int32[N]:
    DEAD_KEY for a dead ray, else by ``mode`` 0 (KEY_ALIVE: alive first),
    the 30-bit Morton code of the origin quantized to 1024 cells an axis
    over ``bounds`` (``MegaTables.key_bounds``) (KEY_MORTON, as
    trace_path_mega_compact sorts, megakernel.py:1779), or (coarse origin
    cell, direction octant, fine origin Morton) (KEY_OCTANT,
    megakernel.py:1962-1976).  A sort of the keys, stable, is the next
    window's order."""
    dead = torch.full(alive.shape, DEAD_KEY, dtype=torch.int32,
                      device=o.device)
    if mode == KEY_ALIVE:
        return torch.where(alive, 0, dead)
    q = (o - bounds[0]) / bounds[1] * 1023.0
    q = torch.where(q > 0.0, q, 0.0)                # fmaxf drops a NaN
    q = torch.where(q < 1023.0, q, 1023.0).to(torch.int32)
    code = ((_spread10(q[:, 0]) << 2) | (_spread10(q[:, 1]) << 1)
            | _spread10(q[:, 2]))
    if mode == KEY_OCTANT:
        neg = (d < 0.0).to(torch.int32)
        oct_ = (neg[:, 0] << 2) | (neg[:, 1] << 1) | neg[:, 2]
        cs = _OCT_COARSE_SHIFT
        code = (((code >> cs) << cs) | (oct_ << (cs - 3))
                | ((code >> 3) & ((1 << (cs - 3)) - 1)))
    return torch.where(alive, code, dead)


def _next_order(key: Tensor) -> Tensor:
    """The next window's order: the ray ids sorted by key, stable (one
    device sort, no host sync), in a ``mega.regroup`` span and counted in
    ``LAUNCHES["mega_regroup"]``."""
    LAUNCHES["mega_regroup"] += 1
    with profiling.span("mega.regroup", device=key.device,
                        rays=key.shape[0]):
        return torch.sort(key, stable=True).indices.to(torch.int32)


def _driver_setup(scene: Scene, rays: Rays, cfg: RenderConfig, tables,
                  samples, generator, seed):
    """(tables, stream, seed, planes, keys) of a compaction driver."""
    check_supported(cfg)
    if cfg.integrator != "path":
        raise ValueError("the compaction drivers run the path integrator")
    if tables is None:
        tables = build_mega_tables(scene, mxu=mxu_wanted(scene, cfg))
    n = rays.origin.shape[0]
    dev = rays.origin.device
    injected = samples is not None
    stream = (stream_tensor(samples, n, cfg.max_depth + 1) if injected
              else None)
    planes = torch.empty(N_PLANES, n, dtype=torch.float32, device=dev)
    key = torch.empty(n, dtype=torch.int32, device=dev)
    return (tables, stream, _resolve_seed(cfg, injected, seed, generator),
            planes, key)


def trace_path_mega_phased(scene: Scene, rays: Rays, cfg: RenderConfig,
                           tables: Optional[MegaTables] = None,
                           compact_every: int = 1, samples=None,
                           generator: Optional[torch.Generator] = None,
                           seed: Optional[int] = None,
                           octants: Optional[bool] = None,
                           first_window: Optional[int] = None) -> Tensor:
    """The fused path in windows of ``compact_every`` bounces (the first
    ``first_window`` long when given), the wavefront regrouped between
    windows (megakernel.py:1867): alive rays first, or with ``octants``
    (default cfg.compact_octants) by (coarse origin cell, direction
    octant, fine origin Morton), dead rays last.  Each window is one launch
    of kernel mode K10 over the path state's planes, in place, which also
    writes each ray's key; one stable sort of the keys gives the next
    window's order -> radiance float32[N, 3] (the planes' rad).

    The draws are keyed by each ray's own id (the injected stream's row, or
    (seed, id, step) in the kernel), so the result is bit-identical to
    ``trace_path_mega`` for any window length and order, under injected and
    in-kernel draws alike.  (The TPU kernel keys its draws by tile and lane:
    there only the injected form is exact.)"""
    if compact_every < 1:
        raise ValueError(f"compact_every must be >= 1; got {compact_every}")
    if octants is None:
        octants = cfg.compact_octants
    tables, stream, seed, planes, key = _driver_setup(
        scene, rays, cfg, tables, samples, generator, seed)
    mode = KEY_OCTANT if octants else KEY_ALIVE
    total = cfg.max_depth + 1
    order, step_lo, phase = None, 0, 0
    while step_lo < total:
        length = (first_window if phase == 0 and first_window
                  else compact_every)
        n_steps = min(length, total - step_lo)
        last = step_lo + n_steps >= total
        _trace(tables, rays.origin, rays.direction, cfg, stream, seed,
               window=Window(step_lo, n_steps, planes, order,
                             None if last else key, mode))
        if not last:
            order = _next_order(key)
        step_lo += n_steps
        phase += 1
    return planes[:3].t().contiguous()


def trace_path_mega_compact(scene: Scene, rays: Rays, cfg: RenderConfig,
                            tables: Optional[MegaTables] = None,
                            primary_steps: int = 1, samples=None,
                            generator: Optional[torch.Generator] = None,
                            seed: Optional[int] = None) -> Tensor:
    """Two windows with one sort between them (megakernel.py:1779): the
    first ``primary_steps`` bounces, then the rest on the wavefront sorted
    dead last and alive by the Morton code of the scatter origin ->
    radiance float32[N, 3], bit-identical to ``trace_path_mega`` (the draws
    are keyed by ray id)."""
    if not 0 < primary_steps <= cfg.max_depth:
        raise ValueError(
            f"compact_after/primary_steps must be in [1, max_depth] "
            f"(= [1, {cfg.max_depth}]); got {primary_steps}: the second "
            "window needs at least one remaining bounce step")
    tables, stream, seed, planes, key = _driver_setup(
        scene, rays, cfg, tables, samples, generator, seed)
    _trace(tables, rays.origin, rays.direction, cfg, stream, seed,
           window=Window(0, primary_steps, planes, None, key, KEY_MORTON))
    _trace(tables, rays.origin, rays.direction, cfg, stream, seed,
           window=Window(primary_steps, None, planes, _next_order(key)))
    return planes[:3].t().contiguous()


def select_mega(scene: Scene, rays: Rays, cfg: RenderConfig,
                tables: Optional[MegaTables] = None, samples=None,
                generator: Optional[torch.Generator] = None,
                seed: Optional[int] = None) -> Tensor:
    """Route an engine='mega' render as the JAX package does
    (megakernel.py:1991): cfg.compact_every phasing, a cfg.compact_after
    split, or under cfg.compact_auto, for the path integrator on a scene
    with at least AUTO_COMPACT_TRIS spheres or triangles, phasing every 2
    bounces with octant regrouping and 8 front-to-back shells unless
    cfg.mega_f2b_shells is set; otherwise one monolithic launch per chunk.
    lambert and normal always run monolithic (only the path carries
    mid-path state)."""
    is_path = cfg.integrator == "path"
    compact_every, octants = cfg.compact_every, None
    if (cfg.compact_auto and not compact_every and not cfg.compact_after
            and max(scene.n_triangles, scene.n_spheres) >= AUTO_COMPACT_TRIS
            and is_path):
        compact_every, octants = 2, True
        if not cfg.mega_f2b_shells:
            cfg = dataclasses.replace(cfg, mega_f2b_shells=8)
    kw = dict(tables=tables, samples=samples, generator=generator, seed=seed)
    if compact_every > 0 and is_path:
        return trace_path_mega_phased(scene, rays, cfg,
                                      compact_every=compact_every,
                                      octants=octants, **kw)
    if cfg.compact_after > 0 and is_path:
        return trace_path_mega_compact(scene, rays, cfg,
                                       primary_steps=cfg.compact_after, **kw)
    return trace_path_mega(scene, rays, cfg, **kw)


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def _xray(rows: Tensor, o, d):
    """TransformRay of rays (3-lists of components) through table rows: [N,
    1] components against float32[C, cols] rows give [N, C] planes, [N]
    components against one gathered row per ray give [N]."""
    return transform_arrays(o, d, [rows[..., X_POS + k] for k in range(3)],
                            [rows[..., X_SCL + k] for k in range(3)],
                            [rows[..., X_ROT + k] for k in range(9)])


def _rect_test(rows, xo, xd, t_min, t_max, quirks):
    """rectangle.h:22-44 on the object-space ray -> (valid, native t)."""
    ox, oy, oz = xo
    dx, dy, dz = xd
    t = -oz / dz
    x = ox + t * dx
    y = oy + t * dy
    facing = dz * rows[..., RECT_SGN]
    valid = ((facing <= 0.0) & (t >= t_min) & (t <= t_max) & (x >= -0.5)
             & (x <= 0.5) & (y >= -0.5) & (y <= 0.5))
    return valid, t


def _tsph_roots(rows, xo, xd, t_min, t_max):
    """sphere.h:27-55 on the object-space ray, the half-b quadratic times
    1/a -> (near root in the window, far root in the window, t0, t1)."""
    ox, oy, oz = xo
    dx, dy, dz = xd
    b = ox * dx + oy * dy + oz * dz
    a = dx * dx + dy * dy + dz * dz
    c = ox * ox + oy * oy + oz * oz - rows[..., TSPH_R2]
    disc = b * b - a * c
    has = disc > 0.0
    sq = torch.sqrt(torch.where(has, disc, 0.0))
    inv_a = 1.0 / a
    t0 = (-b - sq) * inv_a
    t1 = (-b + sq) * inv_a
    return (has & (t0 < t_max) & (t0 > t_min),
            has & (t1 < t_max) & (t1 > t_min), t0, t1)


def _tsph_test(rows, xo, xd, t_min, t_max, quirks):
    """-> (valid, native t: the near root in the window, else the far)."""
    ok0, ok1, t0, t1 = _tsph_roots(rows, xo, xd, t_min, t_max)
    return ok0 | ok1, torch.where(ok0, t0, t1)


def _mt(o, d, v0, e1, e2):
    """Moller-Trumbore in the kernel's order of operations -> (determinant,
    u, v, t); every argument a 3-list of components."""
    ox, oy, oz = o
    dx, dy, dz = d
    e1x, e1y, e1z = e1
    e2x, e2y, e2z = e2
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    f = 1.0 / a
    sx, sy, sz = ox - v0[0], oy - v0[1], oz - v0[2]
    u = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    return a, u, v, t


def _cols(rows: Tensor, k0: int) -> list:
    return [rows[..., k0 + k] for k in range(3)]


def _ttri_mt(rows, xo, xd):
    return _mt(xo, xd, _cols(rows, TTRI_V0), _cols(rows, TTRI_E1),
               _cols(rows, TTRI_E2))


def _mt_valid(a, u, v, t, d, nrm, t_min, t_max, quirks):
    """The Moller-Trumbore hit test with the quirk gates (triangle.h:61-94;
    the backface gate on direction d against normal nrm, 3-lists)."""
    valid = ((a.abs() >= TRI_EPSILON) & (u >= 0.0) & (u <= 1.0)
             & (v >= 0.0) & (u + v <= 1.0))
    if quirks.triangle_back_culling:
        valid &= a >= TRI_EPSILON
    if quirks.triangle_backface_only:
        valid &= (d[0] * nrm[0] + d[1] * nrm[1] + d[2] * nrm[2]) >= 0.0
    if quirks.triangle_no_t_clip:
        valid &= t < t_max
    else:
        valid &= (t > t_min) & (t < t_max)
    return valid


def _ttri_test(rows, xo, xd, t_min, t_max, quirks):
    """Moller-Trumbore on the object-space ray with the quirk gates on the
    transformed direction against the object normal -> (valid, native
    t)."""
    a, u, v, t = _ttri_mt(rows, xo, xd)
    return _mt_valid(a, u, v, t, xd, _cols(rows, TTRI_NOBJ), t_min, t_max,
                     quirks), t


# (winner class, table field, test) of the transform-tested classes, in
# the order of the prim id space
_XFORM = ((C_RECT, "rect", _rect_test), (C_TSPH, "tsph", _tsph_test),
          (C_TTRI, "ttri", _ttri_test))


class _Winner(NamedTuple):
    t: Tensor      # float32[N] closest t (BIG on a miss)
    cls: Tensor    # int64[N] C_SPH .. C_TTRI
    idx: Tensor    # int64[N] row of the winner in its table
    p: Tensor      # float32[N, 3] hit point (object space for rect / TRS)
    n: Tensor      # float32[N, 3] normal
    m: Tensor      # float32[N, 9] material block
    uv: Optional[tuple]   # (u, v) float32[N] each, when asked


def _sphere_uv(n: Tensor) -> tuple:
    """get_sphere_uv (texture.h:45-50) of unit normals float32[N, 3], the
    z-theta form of intersect._sphere_record: phi = atan2(z, x), theta =
    asin(z) clamped (the poles +-pi/2, a NaN z gives 0), the divisions
    written as products by float32 reciprocals."""
    z = torch.clamp(n[:, 2], -1.0, 1.0)
    pole = torch.where(z > 0.0, HALF_PI, torch.where(z < 0.0, -HALF_PI, 0.0))
    theta = torch.where(z.abs() < 1.0, torch.asin(z), pole)
    phi = torch.atan2(n[:, 2], n[:, 0])
    return 1.0 - (phi + PI) * INV_TWO_PI, (theta + HALF_PI) * INV_PI


def _sweep_plain(tables: MegaTables, o: Tensor, d: Tensor, inv_raw: Tensor,
                 cfg: RenderConfig, want_uv: bool = False,
                 mxu: bool = False) -> _Winner:
    """Brute-force closest hit over the same tables with the same formulas
    and the same order: spheres, then triangles (a triangle wins only when
    strictly nearer), then rects, TRS spheres and TRS triangles, each
    compared as native t times 1 / |raw d| and winning only when strictly
    nearer; min returns the first row on ties.  Then the winner's record,
    with want_uv its texture (u, v): the sphere z-theta of the normal,
    Moller-Trumbore (u, v) for triangles, the object-space (x, y) + 0.5 for
    rects (intersect.finalize_hits' definitions).  mxu: the triangles by
    ``_tri_sweep_mxu_plain`` (K12)."""
    n = o.shape[0]
    # the kernel takes t_min / t_max as float32
    t_min, t_max = float(np.float32(cfg.t_min)), float(np.float32(cfg.t_max))
    big = torch.full((n,), BIG, dtype=torch.float32, device=o.device)
    zero = torch.zeros(n, dtype=torch.int64, device=o.device)
    s_t, t_t, s_i, t_i = big, big, zero, zero
    if tables.sph.shape[0]:
        s = tables.sph
        s_t, s_i = sphere_candidates_t(o, d, s[:, S_CX:S_CZ + 1], s[:, S_R2],
                                       t_min, t_max).min(dim=1)
    if tables.tri.shape[0] and mxu:
        t_t, t_i = _tri_sweep_mxu_plain(tables, o, d, s_t, cfg)
    elif tables.tri.shape[0]:
        tr = tables.tri
        t_t, t_i = triangle_candidates_t(
            o, d, tr[:, T_V0:T_V0 + 3], tr[:, T_E1:T_E1 + 3],
            tr[:, T_E2:T_E2 + 3], tr[:, T_N:T_N + 3], t_min, t_max,
            cfg.quirks).min(dim=1)
    tri_w = t_t < s_t
    t = torch.where(tri_w, t_t, s_t)
    cls = torch.where(tri_w, C_TRI, C_SPH)
    idx = torch.where(tri_w, t_i, s_i)
    oc = [o[:, k:k + 1] for k in range(3)]
    dc = [d[:, k:k + 1] for k in range(3)]
    for c, name, test in _XFORM:
        rows = getattr(tables, name)
        if not rows.shape[0]:
            continue
        valid, tn = test(rows, *_xray(rows, oc, dc), t_min, t_max,
                         cfg.quirks)
        x_t, x_i = torch.where(valid, tn * inv_raw[:, None], BIG).min(dim=1)
        w = x_t < t
        t = torch.where(w, x_t, t)
        cls = torch.where(w, c, cls)
        idx = torch.where(w, x_i, idx)
    return _record(tables, o, d, t, cls, idx, cfg, want_uv)


def xchunk_plain(box: Tensor, o: Tensor, inv: Tensor, best: Tensor,
                 same: Tensor, lo_ok: bool) -> Tensor:
    """K8's chunk test (csrc/megakernel.cuh ``xchunk``) of rays float32[N,
    3] (origins and 1 / d) against one chunk row float32[XBOX_COLS], the
    box widened by XFORM_MARGIN x the origin's largest |coordinate| ->
    bool[N]: the chunk may hold a hit that beats ``best`` (same: the best
    so far is of the chunk's class, so a tie at its bound may still win;
    lo_ok: the class's window starts at or above 0).  NaN keeps it."""
    m = o.abs().amax(1, keepdim=True) * XFORM_MARGIN
    t0 = (box[0:3] - (o + m)) * inv
    t1 = (box[3:6] - (o - m)) * inv
    near, far = torch.minimum(t0, t1), torch.maximum(t0, t1)
    a, b = box[6:9], box[9:12]
    en_k = torch.minimum(near * a, near * b)
    ex_k = torch.maximum(far * a, far * b)
    en = torch.maximum(torch.maximum(en_k[:, 0], en_k[:, 1]), en_k[:, 2])
    ex = torch.minimum(torch.minimum(ex_k[:, 0], ex_k[:, 1]), ex_k[:, 2])
    bt = best * box[XB_BMAX]
    cull = ((ex < en) | ((ex < 0.0) & lo_ok)
            | ((en >= 0.0) & ((en > bt) | ((en == bt) & ~same))))
    return ~cull


def xform_walk_plain(tables: MegaTables, o: Tensor, d: Tensor,
                     cfg: RenderConfig) -> tuple:
    """Plain version of K8's culled walk (csrc/megakernel.cuh
    ``xform_class``), for holding the cull and its tie rule to the brute
    force (``_sweep_plain``; the fused plain version stays brute force):
    after the sphere and triangle sweeps, each class's rows in table order
    when it has no chunks, else its chunks in their order, a chunk's rows
    tested on the rays whose ``xchunk_plain`` holds, a row taking a ray when
    nearer, or as near with a lower row of the same class (the key (t,
    class, row), so a chunk's rows are taken together) -> (t float32[N],
    class int64[N], row int64[N], {"xbox": chunk tests, "rect" / "tsph" /
    "ttri": rows tested}), the counts as the counting instance makes
    them."""
    t_min, t_max = float(np.float32(cfg.t_min)), float(np.float32(cfg.t_max))
    empty = {k: getattr(tables, k)[:0] for k in XFORM_CLASSES}
    inv_raw = _inv_len(d)
    first = _sweep_plain(tables._replace(**empty), o, d, inv_raw, cfg)
    t, cls, idx = first.t.clone(), first.cls.clone(), first.idx.clone()
    inv = 1.0 / d
    every = torch.arange(o.shape[0], device=o.device)
    counts = {"xbox": 0}

    def take(c, rows, test, ks, r):
        """Rows ``ks`` of class c on rays ``r``, taken by (t, class, row)."""
        sel = rows[ks]
        valid, tn = test(sel, *_xray(sel, [o[r, k:k + 1] for k in range(3)],
                                     [d[r, k:k + 1] for k in range(3)]),
                         t_min, t_max, cfg.quirks)
        tk = tn * inv_raw[r, None]
        valid = valid & ~torch.isnan(tk)
        tm = torch.where(valid, tk, math.inf).amin(1)
        row = torch.where(valid & (tk == tm[:, None]), ks[None, :],
                          rows.shape[0]).amin(1)
        won = (row < rows.shape[0]) & ((tm < t[r]) | (
            (tm == t[r]) & (cls[r] == c) & (row < idx[r])))
        w = r[won]
        t[w], cls[w], idx[w] = tm[won], c, row[won]

    for c, name, test in _XFORM:
        rows, box = getattr(tables, name), getattr(tables, name + "_box")
        order = getattr(tables, name + "_ord").long()
        lo_ok = t_min >= 0.0 and not (c == C_TTRI
                                      and cfg.quirks.triangle_no_t_clip)
        counts[name] = 0
        if not box.shape[0]:
            for k in range(0, rows.shape[0], SUPER_T):
                ks = torch.arange(k, min(k + SUPER_T, rows.shape[0]),
                                  device=o.device)
                counts[name] += ks.numel() * o.shape[0]
                take(c, rows, test, ks, every)
            continue
        for j in range(box.shape[0]):
            counts["xbox"] += o.shape[0]
            at = xchunk_plain(box[j], o, inv, t, cls == c, lo_ok)
            ks = order[j * XFORM_CHUNK:(j + 1) * XFORM_CHUNK]
            r = torch.nonzero(at)[:, 0]
            counts[name] += ks.numel() * r.numel()
            if r.numel():
                take(c, rows, test, ks, r)
    return t, cls, idx, counts


def _slab_plain(box: Tensor, o: Tensor, inv: Tensor, best: Tensor,
                lo_cut: float) -> Tensor:
    """The kernel's negated slab test of rays float32[N, 3] (origins and 1
    / d) against one triangle box float32[8], widened by TRI_MARGIN x the
    origin's largest |coordinate| as the kernel's slab_ray widens it ->
    bool[N]: reachable unless it lies behind lo_cut or starts at or beyond
    ``best``; NaN keeps it."""
    m = o.abs().amax(1, keepdim=True) * TRI_MARGIN
    t0 = (box[0:3] - (o + m)) * inv
    t1 = (box[3:6] - (o - m)) * inv
    lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
    near = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
    far = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
    return ~((far < near) | (far < lo_cut) | (near >= best))


def _bilinear(coef: Tensor, phi: Tensor, q: int) -> Tensor:
    """Quantity q of every triangle of a super's coefficient block coef
    float32[N_COEF, SUPER_T] on rays' features phi float32[M, N_FEAT] ->
    float32[M, SUPER_T]: the sum of its non-zero terms in feature order,
    each product rounded, as the kernel adds them (no matmul: cuBLAS would
    sum in its own order, or in TF32)."""
    out = None
    for j, k in enumerate(Q_TERMS[q]):
        term = coef[Q_OFF[q] + j] * phi[:, k:k + 1]
        out = term if out is None else out + term
    return out


def _tri_sweep_mxu_plain(tables: MegaTables, o: Tensor, d: Tensor,
                         best: Tensor, cfg: RenderConfig) -> tuple:
    """Plain version of K12's triangle sweep: the segments and, inside a
    reached segment, its supers in table order, each slab-tested against
    the ray's running best t (from ``best``, the spheres' result), every
    reached super evaluated whole from its coefficient rows; the epilogue
    of megakernel.py:1032-1041; the lowest row wins a tie and a super's
    winner takes the ray only when strictly nearer -> (t float32[N], BIG
    where no triangle took the ray; row int64[N])."""
    n = o.shape[0]
    q = cfg.quirks
    t_min, t_max = float(np.float32(cfg.t_min)), float(np.float32(cfg.t_max))
    lo_cut = -BIG if q.triangle_no_t_clip else t_min
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    phi = torch.stack([dx, dy, dz, ox, oy, oz, dy * oz - dz * oy,
                       dz * ox - dx * oz, dx * oy - dy * ox,
                       torch.ones_like(dx)], 1)
    inv = 1.0 / d
    best = best.clone()
    row = torch.zeros(n, dtype=torch.int64, device=o.device)
    won = torch.zeros(n, dtype=torch.bool, device=o.device)
    coef = tables.tri_coef.view(-1, N_COEF, SUPER_T)
    per_seg = SEG_T // SUPER_T
    for g in range(tables.tri_seg.shape[0]):
        at = torch.nonzero(_slab_plain(tables.tri_seg[g], o, inv, best,
                                       lo_cut))[:, 0]
        for s in range(g * per_seg, (g + 1) * per_seg):
            if not at.numel():
                break
            r = at[_slab_plain(tables.tri_super[s], o[at], inv[at], best[at],
                               lo_cut)]
            if not r.numel():
                continue
            c, f = coef[s], phi[r]
            a = _bilinear(c, f, Q_A)
            inv_a = 1.0 / a
            u = _bilinear(c, f, Q_U) * inv_a
            v = _bilinear(c, f, Q_V) * inv_a
            t = _bilinear(c, f, Q_T) * inv_a
            valid = ((a.abs() >= TRI_EPSILON) & (u >= 0.0) & (u <= 1.0)
                     & (v >= 0.0) & (u + v <= 1.0))
            if q.triangle_back_culling:
                valid &= a >= TRI_EPSILON
            if q.triangle_backface_only:
                valid &= _bilinear(c, f, Q_DN) >= 0.0
            if q.triangle_no_t_clip:
                valid &= t < t_max
            else:
                valid &= (t > t_min) & (t < t_max)
            t_s, k_s = torch.where(valid, t, BIG).min(dim=1)
            take = t_s < best[r]
            best[r] = torch.where(take, t_s, best[r])
            row[r] = torch.where(take, s * SUPER_T + k_s, row[r])
            won[r] |= take
    return torch.where(won, best, BIG), row


def _record(tables: MegaTables, o: Tensor, d: Tensor, t: Tensor,
            cls: Tensor, idx: Tensor, cfg: RenderConfig,
            want_uv: bool) -> _Winner:
    """The record of each ray's winner (class ``cls``, table row ``idx``,
    at ``t``): point, normal, material block and, with want_uv, (u, v)."""
    n = o.shape[0]
    t_min, t_max = float(np.float32(cfg.t_min)), float(np.float32(cfg.t_max))
    # the winner's record: sphere and triangle rows loaded after the sweep
    p = o + t[:, None] * d
    srow = (tables.sph[idx.clamp(max=tables.sph.shape[0] - 1)]
            if tables.sph.shape[0] else o.new_zeros(n, SPH_COLS))
    trow = (tables.tri[idx.clamp(max=tables.tri.shape[0] - 1)]
            if tables.tri.shape[0] else o.new_zeros(n, TRI_COLS))
    is_t = (cls == C_TRI)[:, None]
    s_n = (p - srow[:, S_CX:S_CZ + 1]) * srow[:, S_INVR:S_INVR + 1]
    nrm = torch.where(is_t, trow[:, T_N:T_N + 3], s_n)
    m = torch.where(is_t, trow[:, T_MAT:T_MAT + N_MAT_COMPS],
                    srow[:, S_MAT:S_MAT + N_MAT_COMPS])
    oc = [o[:, k] for k in range(3)]
    dc = [d[:, k] for k in range(3)]
    uv = None
    if want_uv:
        su, sv = _sphere_uv(s_n)
        _, tu, tv, _ = _mt(oc, dc, _cols(trow, T_V0), _cols(trow, T_E1),
                           _cols(trow, T_E2))
        uv = (torch.where(is_t[:, 0], tu, su), torch.where(is_t[:, 0], tv, sv))
    for c, name, test in _XFORM:
        rows = getattr(tables, name)
        win = cls == c
        if not rows.shape[0] or not bool(win.any()):
            continue
        row = rows[torch.where(win, idx, 0)]
        xo, xd = _xray(row, oc, dc)
        _, tn = test(row, xo, xd, t_min, t_max, cfg.quirks)
        xp = torch.stack([xo[k] + tn * xd[k] for k in range(3)], 1)
        if c == C_TSPH:
            inv_r = row[:, TSPH_INVR]
            xn = torch.stack(rotate_rows(
                [row[:, X_ROT + k] for k in range(9)], xp[:, 0] * inv_r,
                xp[:, 1] * inv_r, xp[:, 2] * inv_r), 1)
        else:
            k0 = RECT_NRM if c == C_RECT else TTRI_NW
            xn = row[:, k0:k0 + 3]
        w3 = win[:, None]
        p = torch.where(w3, xp, p)
        nrm = torch.where(w3, xn, nrm)
        m = torch.where(w3, row[:, X_MAT:X_MAT + N_MAT_COMPS], m)
        if want_uv:
            if c == C_RECT:
                xu, xv = xp[:, 0] + 0.5, xp[:, 1] + 0.5
            elif c == C_TSPH:
                xu, xv = _sphere_uv(xn)
            else:
                _, xu, xv, _ = _ttri_mt(row, xo, xd)
            uv = (torch.where(win, xu, uv[0]), torch.where(win, xv, uv[1]))
    return _Winner(t, cls, idx, p, nrm, m, uv)


def _winner_hits(tables: MegaTables, o: Tensor, d: Tensor, winner: Tensor,
                 inv_raw: Tensor, cfg: RenderConfig):
    """Each recorded winner (scene prim ids on tables in scene order, -1 for
    a miss) tested on its ray in the plain version's arithmetic ->
    (valid: passes the kernel's test, a miss counting as valid; t: its t,
    the far root of a sphere when neither root is in the window; cls, idx:
    its class and table row; near: a sphere's or TRS sphere's near root is
    the one in the window)."""
    t_min, t_max = float(np.float32(cfg.t_min)), float(np.float32(cfg.t_max))
    w = winner.long()
    oc = [o[:, k] for k in range(3)]
    dc = [d[:, k] for k in range(3)]
    n_s, n_t = tables.n_spheres, tables.n_triangles
    valid = w < 0
    t = torch.full(w.shape, BIG, dtype=o.dtype, device=o.device)
    cls = torch.zeros_like(w)
    idx = torch.zeros_like(w)
    near = torch.zeros_like(valid)
    if n_s:
        row = tables.sph[w.clamp(0, n_s - 1)]
        ocx, ocy, ocz = (oc[k] - row[:, S_CX + k] for k in range(3))
        dx, dy, dz = dc
        a = dx * dx + dy * dy + dz * dz
        b = ocx * dx + ocy * dy + ocz * dz
        c = ocx * ocx + ocy * ocy + ocz * ocz - row[:, S_R2]
        disc = b * b - a * c
        has = disc > 0.0
        sq = torch.sqrt(torch.where(has, disc, 0.0))
        inv_a = 1.0 / a
        t0, t1 = (-b - sq) * inv_a, (-b + sq) * inv_a
        ok0 = has & (t0 < t_max) & (t0 > t_min)
        ok1 = has & (t1 < t_max) & (t1 > t_min)
        is_s = (w >= 0) & (w < n_s)
        valid |= is_s & (ok0 | ok1)
        t = torch.where(is_s, torch.where(ok0, t0, t1), t)
        near = torch.where(is_s, ok0, near)
        idx = torch.where(is_s, w, idx)
    if n_t:
        row = tables.tri[(w - n_s).clamp(0, n_t - 1)]
        a, u, v, tt = _mt(oc, dc, _cols(row, T_V0), _cols(row, T_E1),
                          _cols(row, T_E2))
        is_t = (w >= n_s) & (w < n_s + n_t)
        valid |= is_t & _mt_valid(a, u, v, tt, dc, _cols(row, T_N), t_min,
                                  t_max, cfg.quirks)
        t = torch.where(is_t, tt, t)
        cls = torch.where(is_t, C_TRI, cls)
        idx = torch.where(is_t, w - n_s, idx)
    base = n_s + n_t
    for c, name, test in _XFORM:
        rows = getattr(tables, name)
        k = rows.shape[0]
        if k:
            row = rows[(w - base).clamp(0, k - 1)]
            xo, xd = _xray(row, oc, dc)
            is_x = (w >= base) & (w < base + k)
            ok, tn = test(row, xo, xd, t_min, t_max, cfg.quirks)
            valid |= is_x & ok
            t = torch.where(is_x, tn * inv_raw, t)
            cls = torch.where(is_x, c, cls)
            idx = torch.where(is_x, w - base, idx)
            if c == C_TSPH:
                near = torch.where(is_x, _tsph_roots(row, xo, xd, t_min,
                                                     t_max)[0], near)
        base += k
    return valid, t, cls, idx, near


def winner_valid(scene: Scene, rays: Rays, winner: Tensor,
                 cfg: RenderConfig) -> Tensor:
    """bool[N]: whether each recorded winner (scene prim ids, -1 for a
    miss, which counts as valid) passes the kernel's own test on these rays,
    in the plain version's arithmetic.  A False marks a ray whose replay
    (``intersect.replay_hits``, which follows the recorded winners without
    testing them again) has left the path the kernel traced."""
    tables = build_mega_tables(scene)          # scene order: row = id
    return _winner_hits(tables, rays.origin, rays.direction, winner,
                        _inv_len(rays.direction), cfg)[0]


class ReplayRef(NamedTuple):
    """The plain version's bounce on recorded winners (``replay_reference``),
    what the mega_diff replay takes its discrete decisions and its rays
    from."""
    valid: Tensor        # bool[N] the winner passes its test
    near: Tensor         # bool[N] a sphere's near root is the one taken
    p: Tensor            # float32[N, 3] hit point
    n: Tensor            # float32[N, 3] normal
    uv: tuple            # (u, v) float32[N] each
    ok: Tensor           # bool[N] the material scatters
    direction: Tensor    # float32[N, 3] scattered direction
    decide: _mat.ScatterDecisions


@torch.no_grad()
def replay_reference(tables: MegaTables, o: Tensor, d: Tensor,
                     winner: Tensor, cfg: RenderConfig, ball: Tensor,
                     prob: Tensor) -> ReplayRef:
    """One bounce of the plain version (the kernel's arithmetic, which the
    plain version matches bit for bit on the card) on recorded winners
    int32[N] in scene prim ids, with tables in scene order: the winner's t,
    record and scatter, O(N), no sweep."""
    with profiling.span("mega.replay"):
        inv_dlen = _inv_len(d)
        valid, t, cls, idx, near = _winner_hits(tables, o, d, winner,
                                                inv_dlen, cfg)
        win = _record(tables, o, d, torch.where(winner >= 0, t, BIG), cls,
                      idx, cfg, True)
        ok, out, decide = _scatter(d, win.n, win.m, inv_dlen, ball, prob,
                                   cfg.quirks.dielectric_reference_cosine)
        return ReplayRef(valid, near, win.p, win.n, win.uv, ok, out, decide)


def _scene_ids(tables: MegaTables, win: _Winner) -> Tensor:
    """int32[N] winner ids in the scene's prim id space."""
    n_s, n_t = tables.n_spheres, tables.n_triangles
    ids = torch.zeros_like(win.idx)
    if tables.sph_map.shape[0]:
        sid = tables.sph_map[win.idx.clamp(max=tables.sph_map.shape[0] - 1)]
        ids = torch.where(win.cls == C_SPH, sid.long(), ids)
    if tables.tri_map.shape[0]:
        tid = tables.tri_map[win.idx.clamp(max=tables.tri_map.shape[0] - 1)]
        ids = torch.where(win.cls == C_TRI, n_s + tid.long(), ids)
    base = n_s + n_t
    for c, name, _ in _XFORM:
        ids = torch.where(win.cls == c, base + win.idx, ids)
        base += getattr(tables, name).shape[0]
    return ids.to(torch.int32)


def _decode(m: Tensor, p: Tensor, images: Optional[Tensor] = None,
            uv: Optional[tuple] = None, zero_uv: bool = True):
    """(attenuation, emission) float32[N, 3] (megakernel.py:533-556).

    images (kernel mode K9): the packed images, the blocks of image
    materials holding (image id, w, h) in color0.  The attenuation reads
    the texel at (0, 0) under the lambertian_zero_uv quirk (material.h:67)
    and at the hit's (u, v) otherwise, for lights too (the lambert
    integrator's att term, scatter's lam_att); the emission always at the
    hit's (u, v)."""
    kind, c0, c1 = m[:, 0:1], m[:, 3:6], m[:, 6:9]
    odd = (m[:, 1:2] == float(_tex.CHECKER)) & (
        _tex.checker_sines(p)[:, None] < 0.0)
    tex_att = tex_em = torch.where(odd, c1, c0)
    if images is not None:
        is_img = m[:, 1] == float(_tex.IMAGE)
        img = torch.where(is_img, m[:, M_IMG], 0.0)
        w = torch.where(is_img, m[:, M_W], 1.0)
        h = torch.where(is_img, m[:, M_H], 1.0)
        u, v = uv
        real = _tex.texel(images, img, w, h, u, v)
        at = (_tex.texel(images, img, w, h, torch.zeros_like(u),
                         torch.zeros_like(v)) if zero_uv else real)
        tex_att = torch.where(is_img[:, None], at, tex_att)
        tex_em = torch.where(is_img[:, None], real, tex_em)
    att = torch.where(kind == float(_mat.DIELECTRIC), 1.0,
                      torch.where(kind == float(_mat.METAL), c0, tex_att))
    em = torch.where(kind == float(_mat.DIFFUSE_LIGHT), tex_em, 0.0)
    return att, em


def _sky(d: Tensor, inv_dlen: Tensor) -> Tensor:
    sky_t = (0.5 * (d[:, 1] * inv_dlen + 1.0))[:, None]
    top = torch.tensor([0.5, 0.7, 1.0], device=d.device)
    return (1.0 - sky_t) + sky_t * top


def _scatter(d, nrm, m, inv_dlen, ball, prob, ref_cosine: bool):
    """Branch-free scatter of the four materials (megakernel.py:1464-1531)
    -> (ok, direction, the discrete decisions)."""
    kind, aux = m[:, 0:1], m[:, 2:3]
    is_met = kind == float(_mat.METAL)
    is_die = kind == float(_mat.DIELECTRIC)
    is_light = kind == float(_mat.DIFFUSE_LIGHT)
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    nx, ny, nz = nrm[:, 0:1], nrm[:, 1:2], nrm[:, 2:3]
    il = inv_dlen[:, None]
    lam = nrm + ball
    ud = d * il
    udx, udy, udz = ud[:, 0:1], ud[:, 1:2], ud[:, 2:3]
    ud_n = udx * nx + udy * ny + udz * nz
    met = (ud - 2.0 * ud_n * nrm) + aux * ball
    met_ok = (met[:, 0:1] * nx + met[:, 1:2] * ny + met[:, 2:3] * nz) > 0.0
    d_n = dx * nx + dy * ny + dz * nz
    exiting = d_n > 0.0
    on = torch.where(exiting, -1.0, 1.0) * nrm
    ni = torch.where(exiting, aux, 1.0 / aux)
    cos_plain = torch.where(exiting, d_n, -d_n) * il
    cosine = cos_plain
    if ref_cosine:
        qv = 1.0 - aux * aux * (1.0 - cos_plain * cos_plain)
        cos_exit = torch.where(qv > 0.0,
                               torch.sqrt(torch.clamp(qv, min=0.0)), 0.0)
        cosine = torch.where(exiting, cos_exit, cos_plain)
    dtv = udx * on[:, 0:1] + udy * on[:, 1:2] + udz * on[:, 2:3]
    disc = 1.0 - ni * ni * (1.0 - dtv * dtv)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    refr = ni * (ud - on * dtv) - on * sq
    one_c = torch.clamp(1.0 - cosine, min=0.0)
    r0 = (1.0 - aux) / (1.0 + aux)
    r0 = r0 * r0
    c5 = one_c * one_c
    c5 = c5 * c5 * one_c
    refl_p = torch.where(disc > 0.0, r0 + (1.0 - r0) * c5, 1.0)
    dref = d - 2.0 * d_n * nrm
    reflect = prob[:, None] < refl_p
    die = torch.where(reflect, dref, refr)
    out = torch.where(is_met, met, lam)
    out = torch.where(is_die, die, out)
    ok = (is_met & met_ok) | (~is_met & ~is_light)
    return ok[:, 0], out, _mat.ScatterDecisions(met_ok[:, 0], exiting[:, 0],
                                                reflect[:, 0])


def _inv_len(d: Tensor) -> Tensor:
    return 1.0 / torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                            + d[:, 2] * d[:, 2])


def _plain_rays(tables, o, d, cfg, stream, seed, index,
                want_winners: bool = False, window: Window = WHOLE,
                thr: Optional[Tensor] = None, mxu: bool = False):
    """Radiance float32[N, 3] of one chunk of rays (with window.planes
    their columns' new values float32[N, N_PLANES], the rad of this window
    only; with want_winners also the winners int32[max_depth + 1, N]).
    index: the rays' ids (the draws' keys); stream: their rows of the
    injected draws; thr: the throughput of resumed rays, all alive (None:
    1); mxu: the triangle sweep of K12."""
    q = cfg.quirks
    tex = has_images(tables) and cfg.integrator != "normal"
    images = tables.images if tex else None

    def decode(win):
        return _decode(win.m, win.p, images, win.uv, q.lambertian_zero_uv)

    if cfg.integrator != "path":
        inv_dlen = _inv_len(d)
        win = _sweep_plain(tables, o, d, inv_dlen, cfg, tex, mxu)
        hit = win.t < BIG_CUT
        sky = _sky(d, inv_dlen)
        if cfg.integrator == "normal":
            return torch.where(hit[:, None], win.n, sky)
        att, em = decode(win)
        scale = 1.0 if q.lambert_unnormalized_dot else inv_dlen
        tq = torch.clamp((d[:, 0] * win.n[:, 0] + d[:, 1] * win.n[:, 1]
                          + d[:, 2] * win.n[:, 2]) * scale, min=0.0)
        lit = att * tq[:, None] * sky * 0.2 + em
        return torch.where(hit[:, None], lit, sky)

    n = o.shape[0]
    if thr is None:
        thr = torch.ones(n, 3, device=o.device)
    alive = torch.ones(n, dtype=torch.bool, device=o.device)
    rad = torch.zeros(n, 3, device=o.device)
    winners = torch.full((cfg.max_depth + 1, n), -1, dtype=torch.int32,
                         device=o.device)
    lo = window.step_lo
    for step in range(lo, lo + window.steps(cfg)):
        if not bool(alive.any()):
            break
        inv_dlen = _inv_len(d)
        win = _sweep_plain(tables, o, d, inv_dlen, cfg, tex, mxu)
        hit = win.t < BIG_CUT
        if want_winners:
            winners[step] = torch.where(alive & hit,
                                        _scene_ids(tables, win), -1)
        att, em = decode(win)
        if stream is not None:
            ball, prob = stream[step, :, 0:3], stream[step, :, 3]
        else:
            ball, prob = _rng.counter_draws(seed, index, step)
        ok, out, _ = _scatter(d, win.n, win.m, inv_dlen, ball, prob,
                              q.dielectric_reference_cosine)
        sky = _sky(d, inv_dlen)
        can_rec = step < cfg.max_depth            # render.h:57 depth > 0
        cont = alive & hit & ok & can_rec
        absorbed = (alive & hit & ~(ok & can_rec))[:, None]
        missed = (alive & ~hit)[:, None]
        contrib = (torch.where((alive & hit)[:, None], em, 0.0)
                   + torch.where(absorbed, q.ambient_on_absorb, 0.0)
                   + torch.where(missed, sky, 0.0))
        rad = rad + thr * contrib
        c3 = cont[:, None]
        thr = torch.where(c3, thr * att, thr)
        o = torch.where(c3, win.p, o)
        d = torch.where(c3, out, d)
        alive = cont
    if window.planes is not None:
        return torch.cat([rad, o, d, thr, alive[:, None].to(rad.dtype)], 1)
    return (rad, winners) if want_winners else rad


def _plain_window(tables, rays: Rays, cfg: RenderConfig, stream, seed: int,
                  window: Window, mxu: bool, chunk: int) -> Tensor:
    """The plain version of a window over the planes (K10), in place: the
    positions in chunks, position i serving ray window.order[i], as the
    kernel's threads do; a dead ray's column (and key) left as it is ->
    the planes."""
    planes, n = window.planes, rays.origin.shape[0]
    order = (window.order.long() if window.order is not None
             else torch.arange(n, device=planes.device))
    resume = window.step_lo > 0
    for lo in range(0, n, chunk):
        rid = order[lo:lo + chunk]
        if resume:
            rid = rid[planes[PL_ALIVE, rid] > 0.0]
            o, d = planes[3:6, rid].t(), planes[6:9, rid].t()
            thr = planes[9:12, rid].t()
        else:
            o, d, thr = rays.origin[rid], rays.direction[rid], None
        new = _plain_rays(tables, o, d, cfg,
                          stream[:, rid] if stream is not None else None,
                          seed, rid, window=window, thr=thr, mxu=mxu)
        if resume:
            new[:, 0:3] = planes[0:3, rid].t() + new[:, 0:3]
        planes[:, rid] = new.t()
        if window.key is not None:
            window.key[rid] = regroup_keys(new[:, 3:6], new[:, 6:9],
                                           new[:, PL_ALIVE] > 0.0,
                                           window.key_mode,
                                           tables.key_bounds)
    return planes


def trace_path_mega_plain(tables: MegaTables, rays: Rays, cfg: RenderConfig,
                          stream: Optional[Tensor] = None, seed: int = 0,
                          want_winners: bool = False,
                          window: Window = WHOLE):
    """Plain PyTorch version of the kernel on the same tables: brute-force
    sweeps with the same formulas and a Python loop over the bounces with
    alive masks -> radiance float32[N, 3] (and, with want_winners, the
    winners int32[max_depth + 1, N] as the kernel records them).  The box
    levels (K6) and the visit order (K11) change no result, so the sweep
    stays brute force.

    stream: optional float32[max_depth + 1, N, 4] injected draws, row r
    for ray r; otherwise the counter-based draws of ``seed`` keyed by the
    ray ids (the kernel's numbers).  window: the bounce window (kernel mode
    K10); with its planes they are updated in place, as the kernel does
    (``_plain_window``), and returned.  Under ``_use_mxu`` the triangles
    take K12's sweep (``_tri_sweep_mxu_plain``), whose supers are visited
    as the kernel's slab tests reach them: its forms differ from
    Moller-Trumbore in rounding, so only the same visits give the same
    winners."""
    if want_winners and cfg.integrator != "path":
        raise ValueError("want_winners needs the path integrator")
    n = rays.origin.shape[0]
    _check_window(window, cfg, n, want_winners)
    mxu = _use_mxu(tables, cfg, want_winners)
    dev = rays.origin.device
    if mxu:       # a super's [rays, SUPER_T] planes in place of [rays, T]
        width = max(tables.sph.shape[0] + SUPER_T
                    + sum(getattr(tables, k).shape[0]
                          for k in ("rect", "tsph", "ttri")), 1)
        chunk = max(256, (1 << 24) // width)
    else:
        width = max(sum(t.shape[0] for t in float_tables(tables)), 1)
        chunk = max(256, (1 << 22) // width)
    if window.planes is not None:
        return _plain_window(tables, rays, cfg, stream, seed, window, mxu,
                             chunk)
    out = []
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        index = torch.arange(lo, hi, device=dev)
        out.append(_plain_rays(
            tables, rays.origin[lo:hi], rays.direction[lo:hi], cfg,
            stream[:, lo:hi] if stream is not None else None, seed, index,
            want_winners, window, mxu=mxu))
    if not want_winners:
        return torch.cat(out) if out else rays.origin.new_zeros(0, 3)
    if not out:
        return (rays.origin.new_zeros(0, 3),
                torch.zeros(cfg.max_depth + 1, 0, dtype=torch.int32,
                            device=dev))
    return (torch.cat([r for r, _ in out]),
            torch.cat([w for _, w in out], dim=1))
