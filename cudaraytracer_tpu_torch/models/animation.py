"""Keyframe TRS animation, parity with hitable/animationData.h (the port of
the JAX package's ``models/animation.py``).

The reference's keyframe system (KeyFrame / KeyFrameList / AnimationData) is
not used by its active pipeline, but is part of its components.
``AnimationData::Get_NextTransform`` (animationData.h:68-90) lerps position,
rotation and scale between the current keyframe and the next (its SLerp
variants are commented out; both are provided here).

Keyframes are tensors (frames int32[K], TRS stacked float32[K, 3]); a frame
(scalar or batched) is evaluated by a searchsorted and a lerp, and is
differentiable.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import vec as v3
from ..core.device import resolve_device
from .transform import TRS

Tensor = torch.Tensor


class KeyframeTrack(NamedTuple):
    frames: Tensor     # int32[K], ascending
    position: Tensor   # float32[K, 3]
    rotation: Tensor   # float32[K, 3] Euler degrees
    scale: Tensor      # float32[K, 3]

    @property
    def n_keys(self) -> int:
        return self.frames.shape[0]


def make_track(keyframes, device=None) -> KeyframeTrack:
    """keyframes: iterable of (frame, position, rotation, scale)."""
    device = resolve_device(device)
    ks = sorted(keyframes, key=lambda k: k[0])

    def t(i, dtype):
        return torch.as_tensor(np.asarray([k[i] for k in ks], dtype),
                               device=device)

    return KeyframeTrack(t(0, np.int32), t(1, np.float32), t(2, np.float32),
                         t(3, np.float32))


def evaluate(track: KeyframeTrack, frame, slerp: bool = False) -> TRS:
    """The transform at ``frame`` (scalar or batched): linear interpolation
    between the surrounding keyframes, clamped at the ends (past the last
    key the reference returns the current keyframe's transform,
    animationData.h:70-74)."""
    frames = track.frames.to(torch.float32)
    frame = torch.as_tensor(frame, dtype=torch.float32, device=frames.device)
    idx = torch.searchsorted(frames, frame, right=True) - 1
    i0 = torch.clamp(idx, 0, track.n_keys - 1)
    i1 = torch.clamp(idx + 1, 0, track.n_keys - 1)
    f0, f1 = frames[i0], frames[i1]
    denom = torch.where(f1 > f0, f1 - f0, 1.0)
    t = torch.clamp((frame - f0) / denom, 0.0, 1.0)   # animationData.h:79
    interp = _slerp_guarded if slerp else (lambda a, b, s: v3.lerp(s, a, b))
    return TRS(interp(track.position[i0], track.position[i1], t),
               interp(track.rotation[i0], track.rotation[i1], t),
               interp(track.scale[i0], track.scale[i1], t))


def _slerp_guarded(a: Tensor, b: Tensor, t) -> Tensor:
    """v3.slerp (vec3.h:219-232) wherever it is defined, lerp where it is
    degenerate: identical keys (sin theta = 0, every held pose) or a
    (near-)zero key such as the default (0, 0, 0) rotation, where the raw
    formula divides by 0.  The double-where keeps values and gradients
    finite."""
    t = torch.as_tensor(t, dtype=a.dtype, device=a.device)
    sa = (a * a).sum(-1)
    sb = (b * b).sum(-1)
    ok_len = (sa > 1e-16) & (sb > 1e-16)
    # the sqrt's input double-where'd too: its derivative at 0 is inf
    la = torch.sqrt(torch.where(ok_len, sa, 1.0))
    lb = torch.sqrt(torch.where(ok_len, sb, 1.0))
    na = a / la[..., None]
    nb = b / lb[..., None]
    theta = torch.arccos(torch.clamp((na * nb).sum(-1), -1.0, 1.0))
    sin_theta = torch.sin(theta)
    ok = ok_len & (sin_theta > 1e-6)
    safe_sin = torch.where(ok, sin_theta, 1.0)
    direction = (torch.sin((1.0 - t) * theta)[..., None] * na
                 + torch.sin(t * theta)[..., None] * nb) / safe_sin[..., None]
    mag = (lb - la) * t + la
    return torch.where(ok[..., None], mag[..., None] * direction,
                       v3.lerp(t, a, b))
