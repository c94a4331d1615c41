"""Render configuration and reference-quirk flags (the port's own copy).

Same fields and defaults as the JAX package's ``config.py``, so a config
written for one reads the same in the other.  The reference renderer has no
config system: everything is a compile-time constant (kernel.cu:44-51) or a
commented-out line acting as a menu (render.h:119-121).

``Quirks.reference()`` matches the CUDA reference in its deterministic parts;
``Quirks.fixed()`` is the physically corrected profile.

The port runs ``engine='mega'`` (the fused kernel), ``engine='wavefront'``
(the differentiable per-bounce engine, the default) and ``engine='mega_diff'``
(the fused forward with the replay backward, ``mega_replay_bwd``).
``check_supported`` rejects knob values the port does not run; every knob
of the JAX package's config is ported.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Quirks:
    """Reference-compat switches (SURVEY.md 'Reference quirks')."""

    # triangle.h:61 - only faces whose normal points AWAY from the ray hit.
    triangle_backface_only: bool = True
    # triangle.h:92-94 - Moller-Trumbore t is never clipped to [t_min, t_max);
    # only the closest-so-far test applies (negative t can hit).
    triangle_no_t_clip: bool = True
    # render.h:61 - absorbed paths return emitted + vec3(0.1).
    ambient_on_absorb: float = 0.1
    # render.h:80 - LambertShade dots the UNNORMALIZED camera direction.
    lambert_unnormalized_dot: bool = True
    # createScene.h:99-109 - skinning never recomputes stored face normals.
    fixed_face_normals: bool = True
    # material.h dielectric: exit-side cosine sqrt(1 - ri^2 (1 - cos^2)).
    dielectric_reference_cosine: bool = True
    # material.h:67 - lambertian samples its texture at u = v = 0.
    lambertian_zero_uv: bool = True
    # triangle.h:74 - reject front-determinant rays when backCulling is set.
    triangle_back_culling: bool = False

    @staticmethod
    def reference() -> "Quirks":
        return Quirks()

    @staticmethod
    def fixed() -> "Quirks":
        return Quirks(
            triangle_backface_only=False,
            triangle_no_t_clip=False,
            ambient_on_absorb=0.0,
            lambert_unnormalized_dot=False,
            fixed_face_normals=False,
            dielectric_reference_cosine=False,
            lambertian_zero_uv=False,
            triangle_back_culling=False,
        )


# 'path' == shade(), 'lambert' == LambertShade(), 'normal' == shade_normal()
# (render.h:119-121).
INTEGRATORS = ("path", "lambert", "normal")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Equivalent of the constants at kernel.cu:44-51."""

    width: int = 1024
    height: int = 512
    samples: int = 4
    max_depth: int = 8
    integrator: str = "path"
    t_min: float = 1e-3
    t_max: float = 3.4028235e38  # FLT_MAX
    gamma: bool = True
    clip: bool = True
    quirks: Quirks = dataclasses.field(default_factory=Quirks.reference)
    # pixels * samples per chunk
    ray_chunk: int = 1 << 18
    dtype: str = "float32"
    # 'wavefront' (default), 'mega' or 'mega_diff'
    engine: str = "wavefront"
    wavefront_compact: bool = False
    wavefront_sphere_cull: str = "morton"
    wavefront_kernel_attrs: bool = False
    wavefront_tpu_prng: bool = True
    compact_after: int = 0
    compact_every: int = 0
    compact_octants: bool = False
    compact_auto: bool = True
    mega_f2b_shells: int = 0
    mega_mxu: bool = False
    mega_replay_bwd: bool = True
    grad_sync_axes: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.integrator not in INTEGRATORS:
            raise ValueError(f"integrator must be one of {INTEGRATORS}")
        if self.engine not in ("wavefront", "mega", "mega_diff"):
            raise ValueError(
                "engine must be 'wavefront', 'mega', or 'mega_diff'")
        if self.samples < 1 or self.width < 1 or self.height < 1:
            raise ValueError(
                f"width/height/samples must be >= 1; got {self.width}x"
                f"{self.height} samples={self.samples}")
        if self.max_depth < 0:
            raise ValueError(f"max_depth must be >= 0; got {self.max_depth}")

    @property
    def aspect(self) -> float:
        return float(self.width) / float(self.height)

    @property
    def resolution(self) -> Tuple[int, int]:
        return (self.height, self.width)


def check_supported(cfg: RenderConfig) -> None:
    """Raise for a knob value the port does not run (every knob of the
    JAX package's config is ported)."""
    if cfg.wavefront_sphere_cull not in ("morton", "primary", "off"):
        raise ValueError(
            f"wavefront_sphere_cull={cfg.wavefront_sphere_cull!r}: expected "
            "'morton', 'primary', or 'off'")
    bad = [a for a in cfg.grad_sync_axes if a not in ("dp", "tp")]
    if bad:
        raise ValueError(f"grad_sync_axes={cfg.grad_sync_axes}: unknown "
                         f"axes {bad}; expected 'dp' and 'tp'")
    if cfg.dtype != "float32":
        raise NotImplementedError("the port renders in float32 only")
