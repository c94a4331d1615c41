"""Render configuration and reference-quirk flags (the port's own copy).

Same fields and defaults as the JAX package's ``config.py``, so a config
written for one reads the same in the other.  The reference renderer has no
config system: everything is a compile-time constant (kernel.cu:44-51) or a
commented-out line acting as a menu (render.h:119-121).

``Quirks.reference()`` matches the CUDA reference in its deterministic parts;
``Quirks.fixed()`` is the physically corrected profile.

This slice of the port runs only ``engine='mega'``.  ``check_supported``
rejects every knob whose engine or mode has not been ported yet, naming the
ROADMAP item that brings it.
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
    # 'mega' is the only engine of this slice (see check_supported).
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
    """Raise NotImplementedError for any engine or knob this slice of the
    port does not run, naming the ROADMAP item that brings it.

    ``wavefront_tpu_prng`` (default True, as in the JAX package) selects the
    draws of the wavefront engine only, so it is rejected together with that
    engine; under ``engine='mega'`` the JAX package ignores it too."""
    if cfg.engine == "wavefront":
        raise NotImplementedError(
            "engine='wavefront' (and its wavefront_tpu_prng draws) is not "
            "ported yet: ROADMAP Queue 1 item 13 (slice 3). Pass "
            "engine='mega'.")
    if cfg.engine == "mega_diff":
        raise NotImplementedError(
            "engine='mega_diff' is not ported yet: ROADMAP Queue 1 item 15 "
            "(slice 4)")
    if cfg.compact_after > 0 or cfg.compact_every > 0:
        raise NotImplementedError(
            "compact_after / compact_every (octant compaction, kernel mode "
            "K10) are not ported yet: ROADMAP Queue 1 item 19 (slice 6)")
    if cfg.mega_f2b_shells > 0:
        raise NotImplementedError(
            "mega_f2b_shells (kernel mode K11) is not ported yet: ROADMAP "
            "Queue 2 K11")
    if cfg.mega_mxu:
        raise NotImplementedError(
            "mega_mxu (kernel mode K12) is not ported: ROADMAP Queue 2 K12")
    if cfg.dtype != "float32":
        raise NotImplementedError("the port renders in float32 only")
