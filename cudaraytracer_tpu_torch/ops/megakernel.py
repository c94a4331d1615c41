"""Fused path tracer: the whole bounce loop of a ray in one CUDA thread.

The wrapper around ``csrc/megakernel.cu`` (the port of the JAX package's
``ops/megakernel.py::_mega_kernel`` in its main-path form) and its plain
PyTorch version.

Tables.  ``build_mega_tables`` keeps the contract of the JAX tables: the same
prims in the same (optionally Morton) order, the same per-prim columns, the
same chunk boxes (16 prims) and super boxes (256 prims), and pad rows that
repeat the last prim, so first-prim-wins survives padding.  It drops the TPU
layout:
  * rows are 16 (sphere), 24 (triangle) and 8 (box) floats wide, not 128
    lanes: a CUDA thread loads a row with float4 loads, it needs no
    components-on-lanes slicing;
  * box tables get no extra padding to a multiple of 8 rows (a TPU sublane
    tile);
  * no segment boxes, MXU coefficients, rect or runtime-TRS tables, and no
    row -> scene maps: those serve kernel modes K6-K12, later slices.
Masks are bools, not f32; the sweep carries no attributes (the winner's row
is loaded after it).

Dispatch.  A CUDA tensor launches the kernel or raises; a CPU tensor runs
``trace_path_mega_plain``.  Nothing falls back from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import RenderConfig, check_supported
from ..core import rng as _rng
from ..core.rays import Rays
from ..models import materials as _mat
from ..models import textures as _tex
from ..models.scene import Scene
from ..utils.convert import to_numpy
from . import _cuda
from .sweeps import (BIG, BOX_COLS, PRIM_CHUNK, TRI_EPSILON, group_boxes,
                     pad_rows, sphere_candidates_t, triangle_candidates_t,
                     widen)

Tensor = torch.Tensor

BIG_CUT = 1e37              # t >= BIG_CUT is a miss (megakernel.py:84-88)
SUPER_T = 256               # prims per super box (16 chunks)
SPH_SUPER_MIN = 1024        # spheres get the super level above this count
# The table-resident form (K1) serves up to this many prims per type; larger
# scenes stream (kernel mode K6, slice 6).
MAX_VMEM_PRIMS = 8192

# Table columns (the JAX lane layout, cut to the used width)
S_CX, S_CY, S_CZ, S_R2, S_INVR, S_MAT = 0, 1, 2, 3, 4, 5
T_V0, T_E1, T_E2, T_N, T_MAT = 0, 3, 6, 9, 12
N_MAT_COMPS = 9             # kind, tex kind, aux, color0 rgb, color1 rgb
SPH_COLS, TRI_COLS = 16, 24

INTEGRATOR_IDS = {"path": 0, "lambert": 1, "normal": 2}
F_BACKFACE_ONLY, F_NO_T_CLIP, F_BACK_CULLING = 1, 2, 4
F_DIE_REF_COSINE, F_LAMBERT_UNNORM, F_INJECTED = 8, 16, 32

# Launches of each kernel since the last reset_launch_counts().
LAUNCHES = {"mega_trace": 0, "scatter_draws": 0}


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


def _unsupported(scene: Scene) -> Optional[str]:
    """Why the ported kernel modes cannot render the scene (naming the
    ROADMAP item that brings it), or None."""
    if scene.n_rects or scene.n_t_spheres or scene.n_t_triangles:
        return ("rects and runtime-TRS prims (kernel mode K8) are not "
                "ported yet: ROADMAP Queue 1 item 16 (slice 5)")
    if scene.textures.images.shape[0] > 1:
        return ("image textures (kernel mode K9) are not ported yet: "
                "ROADMAP Queue 1 item 17 (slice 5)")
    if max(scene.n_spheres, scene.n_triangles) > MAX_VMEM_PRIMS:
        return (f"more than {MAX_VMEM_PRIMS} prims of one type need the "
                "streamed form (kernel mode K6): ROADMAP Queue 1 item 18 "
                "(slice 6)")
    return None


def megakernel_supported(scene: Scene) -> bool:
    """Scenes the main-path kernel serves: spheres and triangles (up to
    MAX_VMEM_PRIMS each), constant and checker textures."""
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


def morton_tables(scene: Scene) -> MegaTables:
    """``build_mega_tables`` with both prim types in Morton order: the
    tables every entry point renders from."""
    return build_mega_tables(scene, *mega_orders(to_numpy(scene)))


def _mat_lanes(scene: Scene, mat_id: Tensor) -> Tensor:
    """float32[N, 9] per-prim material block: kind, texture kind, aux
    (metal fuzz | dielectric ref_idx), color0, color1.  Metal's attenuation
    is its albedo, folded into color0 with a constant texture kind
    (megakernel.py:259-287)."""
    m, t = scene.materials, scene.textures
    mat_id = mat_id.long()
    kind = m.kind[mat_id]
    tex_id = m.tex_id[mat_id].long()
    is_metal = kind == _mat.METAL
    c0 = torch.where(is_metal[:, None], m.albedo[mat_id], t.color0[tex_id])
    tex_kind = torch.where(is_metal, _tex.CONSTANT, t.kind[tex_id])
    aux = torch.where(is_metal, m.fuzz[mat_id], m.ref_idx[mat_id])
    return torch.cat([kind.to(torch.float32)[:, None],
                      tex_kind.to(torch.float32)[:, None], aux[:, None], c0,
                      t.color1[tex_id]], dim=1)


def build_mega_tables(scene: Scene, tri_order: Optional[np.ndarray] = None,
                      sph_order: Optional[np.ndarray] = None) -> MegaTables:
    """Pack the scene into the kernel's tables, on the scene's device.

    tri_order / sph_order: optional host permutations (morton_order,
    mega_sphere_order) that make each chunk's box spatially compact, so
    that the box culling prunes."""
    reason = _unsupported(scene)
    if reason:
        raise NotImplementedError(reason)
    dev = scene.device
    n_s, n_t = scene.n_spheres, scene.n_triangles

    def perm(order):
        return torch.as_tensor(np.asarray(order), device=dev).long()

    sph_two_level = n_s > SPH_SUPER_MIN
    sph_mult = SUPER_T if sph_two_level else PRIM_CHUNK
    empty_box = torch.zeros(0, BOX_COLS, device=dev)
    if n_s:
        sp = scene.spheres
        center, radius, smat = sp.center, sp.radius, sp.mat
        if sph_order is not None:
            o = perm(sph_order)
            center, radius, smat = center[o], radius[o], smat[o]
        cols = torch.cat([center, (radius * radius)[:, None],
                          (1.0 / radius)[:, None], _mat_lanes(scene, smat)],
                         dim=1)
        sph = widen(pad_rows(cols, sph_mult), SPH_COLS)
        lo, hi = center - radius[:, None], center + radius[:, None]
        sph_box = group_boxes(lo, hi, PRIM_CHUNK, sph_mult)
        sph_super = (group_boxes(lo, hi, SUPER_T, sph_mult) if sph_two_level
                     else empty_box)
    else:
        sph = torch.zeros(0, SPH_COLS, device=dev)
        sph_box = sph_super = empty_box
    if n_t:
        tr = scene.triangles
        v0, v1, v2, nrm, tmat = tr.v0, tr.v1, tr.v2, tr.normal, tr.mat
        if tri_order is not None:
            o = perm(tri_order)
            v0, v1, v2, nrm, tmat = v0[o], v1[o], v2[o], nrm[o], tmat[o]
        cols = torch.cat([v0, v1 - v0, v2 - v0, nrm, _mat_lanes(scene, tmat)],
                         dim=1)
        tri = widen(pad_rows(cols, SUPER_T), TRI_COLS)
        lo = torch.minimum(torch.minimum(v0, v1), v2)
        hi = torch.maximum(torch.maximum(v0, v1), v2)
        tri_box = group_boxes(lo, hi, PRIM_CHUNK, SUPER_T)
        tri_super = group_boxes(lo, hi, SUPER_T, SUPER_T)
    else:
        tri = torch.zeros(0, TRI_COLS, device=dev)
        tri_box = tri_super = empty_box
    return MegaTables(*(x.contiguous() for x in (
        sph, sph_box, sph_super, tri, tri_box, tri_super)))


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
            [vp] * 11 + [ci] * 6 + [cf] * 3 + [ci, ctypes.c_uint64, vp])
        lib.crt_mega_trace.restype = ci
        lib.crt_scatter_draws.argtypes = [vp, ci, ctypes.c_uint64, ci, vp]
        lib.crt_scatter_draws.restype = ci
        lib.crt_error_string.argtypes = [ci]
        lib.crt_error_string.restype = ctypes.c_char_p
        lib._crt_declared = True
    return lib


def _check(lib, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.crt_error_string(code).decode()}")


def _require_cuda_f32(name: str, x: Tensor, shape=None) -> None:
    if not x.is_cuda or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 CUDA tensor; "
                         f"got {x.dtype} on {x.device}")
    if x.numel() and x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")


def _launch_mega(tables: MegaTables, origin: Tensor, direction: Tensor,
                 cfg: RenderConfig, stream: Optional[Tensor], seed: int,
                 counts: Optional[Tensor] = None) -> Tensor:
    """One launch of the CUDA kernel -> radiance float32[N, 3].

    counts: optional uint64-sized int64[3] CUDA tensor that the kernel adds
    its box, sphere and triangle tests to (measurement only: given, a
    separately compiled counting variant runs; the production variant
    counts nothing)."""
    n = origin.shape[0]
    _require_cuda_f32("origin", origin, (n, 3))
    _require_cuda_f32("direction", direction, (n, 3))
    for name, t in zip(MegaTables._fields, tables):
        _require_cuda_f32(name, t)
        if t.device != origin.device:
            raise ValueError(f"{name} is on {t.device}, rays on "
                             f"{origin.device}")
    if stream is not None:
        _require_cuda_f32("stream", stream, (cfg.max_depth + 1, n, 4))
    if counts is not None and (counts.dtype != torch.int64
                               or tuple(counts.shape) != (3,)
                               or not counts.is_cuda):
        raise ValueError("counts must be an int64[3] CUDA tensor")
    if n >= 2 ** 31:
        raise ValueError(f"{n} rays exceed one launch")
    q = cfg.quirks
    flags = ((F_BACKFACE_ONLY if q.triangle_backface_only else 0)
             | (F_NO_T_CLIP if q.triangle_no_t_clip else 0)
             | (F_BACK_CULLING if q.triangle_back_culling else 0)
             | (F_DIE_REF_COSINE if q.dielectric_reference_cosine else 0)
             | (F_LAMBERT_UNNORM if q.lambert_unnormalized_dot else 0)
             | (F_INJECTED if stream is not None else 0))
    out = torch.empty((n, 3), dtype=torch.float32, device=origin.device)
    lib = _library()
    with torch.cuda.device(origin.device):
        cuda_stream = torch.cuda.current_stream().cuda_stream
        code = lib.crt_mega_trace(
            *(t.data_ptr() for t in tables), origin.data_ptr(),
            direction.data_ptr(),
            stream.data_ptr() if stream is not None else None,
            out.data_ptr(),
            counts.data_ptr() if counts is not None else None,
            n, tables.sph_box.shape[0], tables.sph_super.shape[0],
            tables.tri_super.shape[0], INTEGRATOR_IDS[cfg.integrator],
            cfg.max_depth, float(np.float32(cfg.t_min)),
            float(np.float32(cfg.t_max)),
            float(q.ambient_on_absorb), flags, seed & (2 ** 64 - 1),
            cuda_stream)
    _check(lib, code, "megakernel")
    LAUNCHES["mega_trace"] += 1
    return out


def scatter_draws(out: Tensor, seed: int, step: int) -> Tensor:
    """Fill float32[n, 4] with the kernel's draws (unit-ball xyz, uniform)
    for ray indices 0..n-1 at bounce ``step``: the CUDA kernel for a CUDA
    tensor, ``scatter_draws_plain`` for a CPU tensor."""
    n = out.shape[0]
    if out.device.type == "cpu":
        out.copy_(scatter_draws_plain(n, seed, step, out.device))
        return out
    _require_cuda_f32("out", out, (n, 4))
    lib = _library()
    with torch.cuda.device(out.device):
        code = lib.crt_scatter_draws(
            out.data_ptr(), n, seed & (2 ** 64 - 1), step,
            torch.cuda.current_stream().cuda_stream)
    _check(lib, code, "scatter_draws")
    LAUNCHES["scatter_draws"] += 1
    return out


def scatter_draws_plain(n: int, seed: int, step: int, device) -> Tensor:
    """Plain version of the scatter_draws kernel: float32[n, 4]."""
    ball, prob = _rng.counter_draws(
        seed, torch.arange(n, device=device), step)
    return torch.cat([ball, prob[:, None]], dim=1)


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

def trace_path_mega(scene: Scene, rays: Rays, cfg: RenderConfig,
                    tables: Optional[MegaTables] = None, samples=None,
                    generator: Optional[torch.Generator] = None,
                    seed: Optional[int] = None) -> Tensor:
    """Fused integrator (cfg.integrator: path / lambert / normal) ->
    radiance float32[N, 3].

    samples: optional injected SampleStream (ball [D+1, N, 3], prob
    [D+1, N]); otherwise the path integrator draws in-kernel from ``seed``,
    itself drawn from ``generator`` when not given.  lambert and normal draw
    nothing."""
    check_supported(cfg)
    if tables is None:
        tables = build_mega_tables(scene)
    n = rays.origin.shape[0]
    injected = samples is not None and cfg.integrator == "path"
    if cfg.integrator == "path" and not injected and seed is None:
        if generator is None:
            raise ValueError("the path integrator needs samples, a seed or "
                             "a generator")
        seed = draw_seed(generator)
    seed = 0 if seed is None else seed
    stream = (stream_tensor(samples, n, cfg.max_depth + 1) if injected
              else None)
    if rays.origin.device.type == "cpu":
        return trace_path_mega_plain(tables, rays, cfg, stream, seed)
    return _launch_mega(tables, rays.origin.contiguous(),
                        rays.direction.contiguous(), cfg, stream, seed)


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def _sweep_plain(tables: MegaTables, o: Tensor, d: Tensor,
                 cfg: RenderConfig):
    """Brute-force closest hit over the same tables with the same formulas
    -> (t, tri_wins, sphere row, triangle row).  Ties: min returns the first
    index; a triangle wins only when strictly nearer."""
    n = o.shape[0]
    # the kernel takes t_min / t_max as float32
    t_min, t_max = float(np.float32(cfg.t_min)), float(np.float32(cfg.t_max))
    big = torch.full((n,), BIG, dtype=torch.float32, device=o.device)
    s_t, t_t = big, big
    s_i = t_i = torch.zeros(n, dtype=torch.int64, device=o.device)
    if tables.sph.shape[0]:
        s = tables.sph
        s_t, s_i = sphere_candidates_t(o, d, s[:, S_CX:S_CZ + 1], s[:, S_R2],
                                       t_min, t_max).min(dim=1)
    if tables.tri.shape[0]:
        tr = tables.tri
        t_t, t_i = triangle_candidates_t(
            o, d, tr[:, T_V0:T_V0 + 3], tr[:, T_E1:T_E1 + 3],
            tr[:, T_E2:T_E2 + 3], tr[:, T_N:T_N + 3], t_min, t_max,
            cfg.quirks).min(dim=1)
    tri_w = t_t < s_t
    srow = (tables.sph[s_i] if tables.sph.shape[0]
            else o.new_zeros(n, SPH_COLS))
    trow = (tables.tri[t_i] if tables.tri.shape[0]
            else o.new_zeros(n, TRI_COLS))
    return torch.where(tri_w, t_t, s_t), tri_w, srow, trow


def _surface(tri_w, srow, trow, p):
    """Winner normal and material block."""
    s_n = (p - srow[:, S_CX:S_CZ + 1]) * srow[:, S_INVR:S_INVR + 1]
    nrm = torch.where(tri_w[:, None], trow[:, T_N:T_N + 3], s_n)
    m = torch.where(tri_w[:, None], trow[:, T_MAT:T_MAT + N_MAT_COMPS],
                    srow[:, S_MAT:S_MAT + N_MAT_COMPS])
    return nrm, m


def _decode(m: Tensor, p: Tensor):
    """(attenuation, emission) float32[N, 3] (megakernel.py:533-556)."""
    kind, c0, c1 = m[:, 0:1], m[:, 3:6], m[:, 6:9]
    odd = (m[:, 1:2] == float(_tex.CHECKER)) & (
        _tex.checker_sines(p)[:, None] < 0.0)
    tex = torch.where(odd, c1, c0)
    att = torch.where(kind == float(_mat.DIELECTRIC), 1.0,
                      torch.where(kind == float(_mat.METAL), c0, tex))
    em = torch.where(kind == float(_mat.DIFFUSE_LIGHT), tex, 0.0)
    return att, em


def _sky(d: Tensor, inv_dlen: Tensor) -> Tensor:
    sky_t = (0.5 * (d[:, 1] * inv_dlen + 1.0))[:, None]
    top = torch.tensor([0.5, 0.7, 1.0], device=d.device)
    return (1.0 - sky_t) + sky_t * top


def _scatter(d, nrm, m, inv_dlen, ball, prob, ref_cosine: bool):
    """Branch-free scatter of the four materials (megakernel.py:1464-1531)
    -> (ok, direction)."""
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
    die = torch.where(prob[:, None] < refl_p, dref, refr)
    out = torch.where(is_met, met, lam)
    out = torch.where(is_die, die, out)
    ok = (is_met & met_ok) | (~is_met & ~is_light)
    return ok[:, 0], out


def _plain_rays(tables, o, d, cfg, stream, seed, index):
    q = cfg.quirks
    if cfg.integrator != "path":
        t, tri_w, srow, trow = _sweep_plain(tables, o, d, cfg)
        hit = t < BIG_CUT
        p = o + torch.where(hit, t, 0.0)[:, None] * d
        nrm, m = _surface(tri_w, srow, trow, p)
        inv_dlen = 1.0 / torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                                    + d[:, 2] * d[:, 2])
        sky = _sky(d, inv_dlen)
        if cfg.integrator == "normal":
            return torch.where(hit[:, None], nrm, sky)
        att, em = _decode(m, p)
        scale = 1.0 if q.lambert_unnormalized_dot else inv_dlen
        tq = torch.clamp((d[:, 0] * nrm[:, 0] + d[:, 1] * nrm[:, 1]
                          + d[:, 2] * nrm[:, 2]) * scale, min=0.0)
        lit = att * tq[:, None] * sky * 0.2 + em
        return torch.where(hit[:, None], lit, sky)

    n = o.shape[0]
    thr = torch.ones(n, 3, device=o.device)
    rad = torch.zeros(n, 3, device=o.device)
    alive = torch.ones(n, dtype=torch.bool, device=o.device)
    for step in range(cfg.max_depth + 1):
        t, tri_w, srow, trow = _sweep_plain(tables, o, d, cfg)
        hit = t < BIG_CUT
        p = o + t[:, None] * d
        nrm, m = _surface(tri_w, srow, trow, p)
        att, em = _decode(m, p)
        if stream is not None:
            ball, prob = stream[step, :, 0:3], stream[step, :, 3]
        else:
            ball, prob = _rng.counter_draws(seed, index, step)
        inv_dlen = 1.0 / torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                                    + d[:, 2] * d[:, 2])
        ok, out = _scatter(d, nrm, m, inv_dlen, ball, prob,
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
        o = torch.where(c3, p, o)
        d = torch.where(c3, out, d)
        alive = cont
        if not bool(alive.any()):
            break
    return rad


def trace_path_mega_plain(tables: MegaTables, rays: Rays, cfg: RenderConfig,
                          stream: Optional[Tensor] = None,
                          seed: int = 0) -> Tensor:
    """Plain PyTorch version of the kernel on the same tables: brute-force
    sweeps with the same formulas and a Python loop over the bounces with
    alive masks -> radiance float32[N, 3].

    stream: optional float32[max_depth + 1, N, 4] injected draws; otherwise
    the counter-based draws of ``seed`` (the kernel's numbers)."""
    n = rays.origin.shape[0]
    width = max(tables.sph.shape[0] + tables.tri.shape[0], 1)
    chunk = max(256, (1 << 22) // width)
    out = []
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        index = torch.arange(lo, hi, device=rays.origin.device)
        out.append(_plain_rays(
            tables, rays.origin[lo:hi], rays.direction[lo:hi], cfg,
            stream[:, lo:hi] if stream is not None else None, seed, index))
    if not out:
        return rays.origin.new_zeros(0, 3)
    return torch.cat(out)
