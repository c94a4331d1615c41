"""Material table and branch-free scatter/emit (replaces the virtual
Material hierarchy of CudaTest/src/material/material.h).

The four kinds and their rules (the fused kernel and its plain version in
``ops/megakernel.py`` evaluate them in-kernel; ``scatter`` and ``emitted``
evaluate them as differentiable tensor ops for the wavefront engine):
  LAMBERTIAN (material.h:55-72): dir = n + unit_ball; attenuation = the
      texture at the hit point (u = v = 0 under the reference quirk, so an
      image's texel (0, 0): i = 0, j = h - 1).
  METAL (material.h:75-96): dir = reflect(unit(d), n) + fuzz * unit_ball;
      attenuation = albedo; scatters iff dot(dir, n) > 0.  fuzz <= 1.
  DIELECTRIC (material.h:99-143): attenuation 1; Schlick choice between
      reflection and refraction.
  DIFFUSE_LIGHT (material.h:146-161): never scatters; emits its texture at
      the hit's real (u, v).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core import rng as _rng
from ..core import vec as v3
from ..core.device import resolve_device
from ..core.rays import Rays
from . import textures as _tx
from .textures import TextureBuilder, TextureTable

Tensor = torch.Tensor

LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2
DIFFUSE_LIGHT = 3


class MaterialTable(NamedTuple):
    kind: Tensor     # int32[M]
    tex_id: Tensor   # int32[M] albedo (lambertian) / emit (light) texture
    albedo: Tensor   # float32[M, 3] metal albedo
    fuzz: Tensor     # float32[M]
    ref_idx: Tensor  # float32[M]


class ScatterResult(NamedTuple):
    ok: Tensor           # bool[N] did the material scatter
    scattered: Rays      # next rays
    attenuation: Tensor  # float32[N, 3]


class ScatterDecisions(NamedTuple):
    """The discrete choices of a scatter, made elsewhere and imposed (the
    mega_diff replay takes them from the plain version's arithmetic, so it
    follows the path the kernel traced)."""

    met_ok: Tensor       # bool[N] metal: dot(dir, n) > 0
    exiting: Tensor      # bool[N] dielectric: dot(d, n) > 0
    reflect: Tensor      # bool[N] dielectric: reflect, not refract


class DecodedMaterials(NamedTuple):
    """Per-lane material and texture fields, decoded by one row gather of
    ``decode_table`` (the JAX package's consolidated form; the port keeps
    only this form, since on a GPU a gather is a load).  Gradients reach
    albedo, color0 and color1 through the gather."""

    kind: Tensor      # float32[N] material kind
    fuzz: Tensor      # float32[N]
    ref_idx: Tensor   # float32[N]
    albedo: Tensor    # float32[N, 3] metal albedo
    tex_kind: Tensor  # float32[N]
    c0: Tensor        # float32[N, 3] constant color / checker even
    c1: Tensor        # float32[N, 3] checker odd
    img: Tensor       # int32[N] image row (0 = dummy)
    wh: Tensor        # int32[N, 2] image (w, h)


DEC_COLS = 16      # decode_table row width (DecodedMaterials packed)


def decode_table(mat: MaterialTable, tex: TextureTable) -> Tensor:
    """float32[M, 16]: every material's DecodedMaterials fields in one row
    (int fields round-trip exactly, values << 2^24)."""
    tid = mat.tex_id.long()
    img = tex.image_id[tid].long()
    return torch.cat([
        mat.kind.to(torch.float32)[:, None],
        mat.fuzz[:, None],
        mat.ref_idx[:, None],
        mat.albedo,
        tex.kind[tid].to(torch.float32)[:, None],
        tex.color0[tid],
        tex.color1[tid],
        img.to(torch.float32)[:, None],
        tex.image_wh[img].to(torch.float32),
    ], dim=1)


def decoded_from_rows(row: Tensor) -> DecodedMaterials:
    """Unpack gathered decode_table rows (..., 16) -> DecodedMaterials."""
    return DecodedMaterials(
        kind=row[..., 0], fuzz=row[..., 1], ref_idx=row[..., 2],
        albedo=row[..., 3:6], tex_kind=row[..., 6], c0=row[..., 7:10],
        c1=row[..., 10:13], img=row[..., 13].to(torch.int32),
        wh=row[..., 14:16].to(torch.int32))


def gather_rows(table: Tensor, idx: Tensor) -> Tensor:
    """table[idx] for a float32[K, C] table and an index per lane, as an
    embedding lookup: its backward sums the lanes of each row after a sort,
    where advanced indexing's backward (index_put with accumulate) ran one
    lane at a time on the card when a few rows take every lane (1.02 s of
    device time in one mega_diff fit step, NVIDIA H100 80GB HBM3 at
    700 W)."""
    return torch.nn.functional.embedding(idx.long(), table)


def decode_materials(mat: MaterialTable, tex: TextureTable,
                     mat_id: Tensor) -> DecodedMaterials:
    """Per-lane material/texture decode: one row gather of decode_table."""
    return decoded_from_rows(gather_rows(decode_table(mat, tex), mat_id))


def eval_texture_dec(dec: DecodedMaterials, tex: TextureTable, u: Tensor,
                     v: Tensor, p: Tensor) -> Tensor:
    """textures.eval_texture on decoded rows (texture.h:12-76) ->
    float32[N, 3]."""
    checker = torch.where((_tx.checker_sines(p) < 0.0)[..., None], dec.c1,
                          dec.c0)
    out = torch.where((dec.tex_kind == float(_tx.CHECKER))[..., None],
                      checker, dec.c0)
    if tex.images.shape[0] == 1:
        return out        # no image registered: row 0 is the dummy
    img = _tx.texel(tex.images, dec.img, dec.wh[..., 0], dec.wh[..., 1], u,
                    v)
    return torch.where((dec.tex_kind == float(_tx.IMAGE))[..., None], img,
                       out)


def emitted(mat: MaterialTable, tex: TextureTable, mat_id: Tensor,
            u: Tensor, v: Tensor, p: Tensor,
            dec: Optional[DecodedMaterials] = None) -> Tensor:
    """Material::emitted: nonzero only for DIFFUSE_LIGHT
    (material.h:153-155)."""
    if dec is None:
        dec = decode_materials(mat, tex, mat_id)
    val = eval_texture_dec(dec, tex, u, v, p)
    return torch.where((dec.kind == float(DIFFUSE_LIGHT))[..., None], val,
                       0.0)


def scatter_draws(n: int, generator: torch.Generator,
                  device=None):
    """One scatter step's draws: a unit-ball sample float32[n, 3] and a
    uniform float32[n] per ray (materials.py:188 of the JAX package), drawn
    on the generator."""
    return _rng.unit_ball(n, generator, device)


def scatter(mat: MaterialTable, tex: TextureTable, mat_id: Tensor,
            r_in: Rays, p: Tensor, normal: Tensor, u: Tensor, v: Tensor,
            ball: Tensor, prob: Tensor,
            dielectric_reference_cosine: bool = True,
            lambertian_zero_uv: bool = True,
            dec: Optional[DecodedMaterials] = None,
            decide: Optional[ScatterDecisions] = None) -> ScatterResult:
    """Branch-free scatter for a batch of hits (materials.py:199-279 of the
    JAX package): all four material models are evaluated on the same draws
    and the result is selected by the material kind.

    ball / prob: the step's draws (float32[N, 3] unit-ball sample, float32[N]
    uniform), made by the caller.  dec: optional pre-decoded rows, shared
    with ``emitted``.  decide: optional discrete choices to take in place of
    the ones these tensor ops would make."""
    if dec is None:
        dec = decode_materials(mat, tex, mat_id)
    kind = dec.kind
    d_in = r_in.direction

    lam_dir = normal + ball                      # material.h:60-68

    # METAL (material.h:81-92)
    reflected = v3.reflect(v3.unit_vector(d_in), normal)
    met_dir = reflected + dec.fuzz[..., None] * ball
    met_ok = (v3.dot(met_dir, normal) > 0.0 if decide is None
              else decide.met_ok)

    # DIELECTRIC (material.h:104-141)
    ri = dec.ref_idx
    d_dot_n = v3.dot(d_in, normal)
    d_len = v3.length(d_in)
    exiting = d_dot_n > 0.0 if decide is None else decide.exiting
    outward_normal = torch.where(exiting[..., None], -normal, normal)
    ni_over_nt = torch.where(exiting, ri, 1.0 / ri)
    cos_plain = torch.where(exiting, d_dot_n / d_len, -d_dot_n / d_len)
    if dielectric_reference_cosine:
        # material.h:116-117: exit side uses sqrt(1 - ri^2 (1 - cos^2)),
        # double-where for a finite backward where the operand is <= 0
        q = 1.0 - ri * ri * (1.0 - cos_plain * cos_plain)
        cos_exit = torch.where(q > 0.0,
                               torch.sqrt(torch.where(q > 0.0, q, 1.0)), 0.0)
        cosine = torch.where(exiting, cos_exit, cos_plain)
    else:
        cosine = cos_plain
    refr_ok, refracted = v3.refract(d_in, outward_normal, ni_over_nt)
    reflect_prob = torch.where(refr_ok, v3.schlick(cosine, ri), 1.0)
    die_reflected = v3.reflect(d_in, normal)   # material.h:107, raw dir
    reflect = prob < reflect_prob if decide is None else decide.reflect
    die_dir = torch.where(reflect[..., None], die_reflected, refracted)

    kindc = kind[..., None]
    out_dir = torch.where(kindc == float(METAL), met_dir, lam_dir)
    out_dir = torch.where(kindc == float(DIELECTRIC), die_dir, out_dir)
    ok = ((kind != float(METAL)) | met_ok) & (kind != float(DIFFUSE_LIGHT))
    att = attenuation(dec, tex, u, v, p, lambertian_zero_uv)
    return ScatterResult(ok, Rays(p, out_dir, r_in.time), att)


def attenuation(dec: DecodedMaterials, tex: TextureTable, u: Tensor,
                v: Tensor, p: Tensor, lambertian_zero_uv: bool = True):
    """Attenuation float32[N, 3] of each kind: the texture (lambertian;
    material.h:67 samples it at u = v = 0 under the reference quirk), the
    albedo (metal), 1 (dielectric)."""
    if lambertian_zero_uv:
        u, v = torch.zeros_like(u), torch.zeros_like(v)
    kindc = dec.kind[..., None]
    att = torch.where(kindc == float(METAL), dec.albedo,
                      eval_texture_dec(dec, tex, u, v, p))
    return torch.where(kindc == float(DIELECTRIC), 1.0, att)


class MaterialBuilder:
    """Host-side accumulation mirroring the reference constructors."""

    def __init__(self, textures: Optional[TextureBuilder] = None):
        self.textures = textures if textures is not None else TextureBuilder()
        self._kind = []
        self._tex = []
        self._albedo = []
        self._fuzz = []
        self._ref_idx = []

    def _add(self, kind, tex=0, albedo=(0, 0, 0), fuzz=0.0,
             ref_idx=1.0) -> int:
        self._kind.append(kind)
        self._tex.append(tex)
        self._albedo.append(np.asarray(albedo, np.float32))
        self._fuzz.append(float(fuzz))
        self._ref_idx.append(float(ref_idx))
        return len(self._kind) - 1

    def lambertian(self, tex_id: Optional[int] = None, color=None) -> int:
        if tex_id is None:
            tex_id = self.textures.constant(
                color if color is not None else (0.5, 0.5, 0.5))
        return self._add(LAMBERTIAN, tex=tex_id)

    def metal(self, albedo, fuzz: float = 0.0) -> int:
        return self._add(METAL, albedo=albedo, fuzz=min(float(fuzz), 1.0))

    def dielectric(self, ref_idx: float) -> int:
        return self._add(DIELECTRIC, ref_idx=ref_idx)

    def diffuse_light(self, tex_id: Optional[int] = None, color=None) -> int:
        if tex_id is None:
            tex_id = self.textures.constant(
                color if color is not None else (1.0, 1.0, 1.0))
        return self._add(DIFFUSE_LIGHT, tex=tex_id)

    def build(self, device=None) -> MaterialTable:
        device = resolve_device(device)
        m = max(len(self._kind), 1)
        kind = np.zeros(m, np.int32)
        tex = np.zeros(m, np.int32)
        albedo = np.zeros((m, 3), np.float32)
        fuzz = np.zeros(m, np.float32)
        ref_idx = np.ones(m, np.float32)
        if self._kind:
            kind[:] = self._kind
            tex[:] = self._tex
            albedo[:] = np.stack(self._albedo)
            fuzz[:] = self._fuzz
            ref_idx[:] = self._ref_idx
        return MaterialTable(*(torch.from_numpy(a).to(device)
                               for a in (kind, tex, albedo, fuzz, ref_idx)))
