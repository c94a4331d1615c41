"""Batched 3-vector math on ``float32[..., 3]`` tensors.

Replaces the reference's ``vec3`` class (CudaTest/src/core/vec3.h).  Every
function maps over arbitrary leading batch axes.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def vec3(x, y, z, device=None) -> Tensor:
    """Build a float32[..., 3] from components (broadcasting)."""
    parts = torch.broadcast_tensors(
        *(torch.as_tensor(c, dtype=torch.float32, device=device)
          for c in (x, y, z)))
    return torch.stack(parts, dim=-1)


def dot(a: Tensor, b: Tensor) -> Tensor:
    """vec3.h:109 - returns float32[...] (no keepdim)."""
    return (a * b).sum(dim=-1)


def vdot(a: Tensor, b: Tensor) -> Tensor:
    """dot with keepdim, for throughput math."""
    return (a * b).sum(dim=-1, keepdim=True)


def cross(a: Tensor, b: Tensor) -> Tensor:
    """vec3.h:113."""
    return torch.linalg.cross(a, b, dim=-1)


def length(v: Tensor) -> Tensor:
    return torch.sqrt(dot(v, v))


def squared_length(v: Tensor) -> Tensor:
    return dot(v, v)


def unit_vector(v: Tensor) -> Tensor:
    """vec3.h:191 - v / |v| (no epsilon, like the reference)."""
    return v / length(v)[..., None]


def normalize_safe(v: Tensor, eps: float = 1e-20) -> Tensor:
    """Normalize without a NaN at |v| = 0."""
    n2 = torch.clamp(dot(v, v), min=eps)
    return v * torch.sqrt(1.0 / n2)[..., None]


def lerp(t, a: Tensor, b: Tensor) -> Tensor:
    """vec3.h:196 - a + t * (b - a); a per-vector t broadcasts over the
    component axis (trailing axes are added until t aligns with a's batch
    axes)."""
    t = torch.as_tensor(t, dtype=a.dtype, device=a.device)
    while t.dim() < a.dim():
        t = t[..., None]
    return a + t * (b - a)


def clip01(v: Tensor) -> Tensor:
    """vec3.h:119-131 clip to [0, 1]."""
    return torch.clamp(v, 0.0, 1.0)


def rotation_matrix_euler_deg(rotation) -> Tensor:
    """The exact rotation of vec3.h:200-217 as a row matrix ``R[..., 3, 3]``:
    out[i] = dot(v, R[i]).  The negated Z angle (vec3.h:206) is kept."""
    rotation = torch.as_tensor(rotation, dtype=torch.float32)
    k = math.pi / 180.0
    rx = k * rotation[..., 0]
    ry = k * rotation[..., 1]
    rz = -k * rotation[..., 2]
    sx, cx = torch.sin(rx), torch.cos(rx)
    sy, cy = torch.sin(ry), torch.cos(ry)
    sz, cz = torch.sin(rz), torch.cos(rz)
    row0 = torch.stack([cy * cz, -cy * sz, sy], dim=-1)
    row1 = torch.stack([sx * sy * cz + cx * sz, -sx * sy * sz + cx * cz,
                        -sx * cy], dim=-1)
    row2 = torch.stack([-cx * sy * cz + sx * sz, cx * sy * sz + sx * cz,
                        cx * cy], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def rotate(v: Tensor, rotation) -> Tensor:
    """Euler rotate matching vec3.h:200-217 (degrees, negated-Z quirk)."""
    R = rotation_matrix_euler_deg(rotation).to(v.device)
    return torch.einsum("...ij,...j->...i", R, v)


def slerp(a: Tensor, b: Tensor, t) -> Tensor:
    """vec3.h:219-232 - spherical lerp with magnitude lerp."""
    na = unit_vector(a)
    nb = unit_vector(b)
    theta = torch.arccos(torch.clamp(dot(na, nb), -1.0, 1.0))
    sin_theta = torch.sin(theta)
    t = torch.as_tensor(t, dtype=torch.float32, device=a.device)
    sin_from = torch.sin((1.0 - t) * theta)
    sin_to = torch.sin(t * theta)
    mag = (length(b) - length(a)) * t + length(a)
    direction = (sin_from[..., None] * na + sin_to[..., None] * nb) \
        / sin_theta[..., None]
    return mag[..., None] * direction


def reflect(v: Tensor, n: Tensor) -> Tensor:
    """material.h reflect - v - 2 dot(v, n) n."""
    return v - 2.0 * vdot(v, n) * n


def refract(v: Tensor, n: Tensor, ni_over_nt):
    """material.h refract -> (ok mask, refracted direction) on unit(v)."""
    uv = unit_vector(v)
    dt = vdot(uv, n)
    ni_over_nt = torch.as_tensor(ni_over_nt, dtype=v.dtype, device=v.device)
    if ni_over_nt.dim() < uv.dim():
        ni_over_nt = ni_over_nt[..., None]
    disc = 1.0 - ni_over_nt * ni_over_nt * (1.0 - dt * dt)
    ok = disc[..., 0] > 0.0
    sq = torch.where(disc > 0.0,
                     torch.sqrt(torch.where(disc > 0.0, disc, 1.0)), 0.0)
    refracted = ni_over_nt * (uv - n * dt) - n * sq
    return ok, refracted


def schlick(cosine: Tensor, ref_idx: Tensor) -> Tensor:
    """material.h Schlick approximation (1 - cosine clamped at 0)."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * torch.pow(torch.clamp(1.0 - cosine, min=0.0),
                                       5.0)
