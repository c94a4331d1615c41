"""Random draws on an explicit ``torch.Generator``, and the counter-based
Philox stream of the fused kernel.

The reference seeds one ``curandState`` per pixel (deviceManage.h:120-128)
and draws inside each thread with rejection loops.  The port draws the same
distributions without loops:

- ``uniform``, ``unit_disk`` and ``unit_ball`` draw on a ``torch.Generator``
  (the camera, and streams injected into a render);
- ``counter_draws`` is the plain twin of the kernel's in-thread draws:
  Philox4x32-10 keyed by the seed, counted by (ray index, bounce), so the
  numbers do not depend on the launch shape or on which version runs.

Both turn six uniforms into a unit-ball sample and one more uniform with the
transform of the JAX megakernel (``ops/megakernel.py`` draw_samples): a
Box-Muller direction times a cube-root radius.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor

TWO_PI = 2.0 * math.pi
_MASK32 = 0xFFFFFFFF
# Philox4x32 multipliers and Weyl key increments (Salmon et al., SC'11)
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
PHILOX_ROUNDS = 10


def uniform(shape, generator: torch.Generator, device=None) -> Tensor:
    """U[0, 1) float32 draws."""
    device = generator.device if device is None else device
    return torch.rand(shape, generator=generator, dtype=torch.float32,
                      device=device)


def unit_disk(n: int, generator: torch.Generator, device=None) -> Tensor:
    """Uniform in the unit disk, z = 0 (camera.h:6-13 distribution)
    -> float32[n, 3]."""
    u = uniform((n, 2), generator, device)
    return disk_from_uniforms(u)


def disk_from_uniforms(u: Tensor) -> Tensor:
    """float32[n, 2] uniforms -> unit-disk points float32[n, 3]."""
    theta = u[:, 0] * TWO_PI
    r = torch.sqrt(u[:, 1])
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta),
                        torch.zeros_like(r)], dim=-1)


def ball_from_uniforms(u: Tensor):
    """float32[n, 6] uniforms -> (unit-ball sample float32[n, 3], uniform
    float32[n]): Box-Muller direction x cube-root radius, the transform of
    the JAX megakernel's draw_samples and of the CUDA kernel's draws."""
    r1 = torch.sqrt(-2.0 * torch.log(torch.clamp(u[:, 0], min=1e-12)))
    ang1 = TWO_PI * u[:, 1]
    g0 = r1 * torch.cos(ang1)
    g1 = r1 * torch.sin(ang1)
    r2 = torch.sqrt(-2.0 * torch.log(torch.clamp(u[:, 2], min=1e-12)))
    g2 = r2 * torch.cos(TWO_PI * u[:, 3])
    inv_norm = 1.0 / torch.clamp(torch.sqrt(g0 * g0 + g1 * g1 + g2 * g2),
                                 min=1e-12)
    rad = torch.exp(torch.log(torch.clamp(u[:, 4], min=1e-30)) * (1.0 / 3.0))
    s = inv_norm * rad
    return torch.stack([g0 * s, g1 * s, g2 * s], dim=-1), u[:, 5]


def unit_ball(n: int, generator: torch.Generator, device=None):
    """(unit-ball sample float32[n, 3], uniform float32[n]) from the
    generator."""
    return ball_from_uniforms(uniform((n, 6), generator, device))


def _mulhilo(a: Tensor, m: int):
    """(hi, lo) 32-bit halves of a * m for a uint32 held in int64, without
    overflowing int64."""
    x = m * (a & 0xFFFF)
    y = m * (a >> 16) + (x >> 16)
    return y >> 16, ((y & 0xFFFF) << 16) | (x & 0xFFFF)


def philox4x32(ctr, key0: int, key1: int):
    """Philox4x32-10 on four int64 tensors holding uint32 counters."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key0 & _MASK32, key1 & _MASK32
    for r in range(PHILOX_ROUNDS):
        if r:
            k0 = (k0 + PHILOX_W0) & _MASK32
            k1 = (k1 + PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(c0, PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def counter_uniforms(seed: int, index: Tensor, step) -> Tensor:
    """Six U[0, 1) draws per index, float32[n, 6]: the high 24 bits of
    Philox4x32-10 at counters (index, step, 0, 0) and (index, step, 1, 0)
    under key (seed low word, seed high word).  step: one bounce, or a
    tensor of one bounce per index."""
    idx = index.to(torch.int64) & _MASK32
    s = (torch.full_like(idx, step & _MASK32) if isinstance(step, int)
         else (step.to(torch.int64) & _MASK32).expand_as(idx))
    z = torch.zeros_like(idx)
    a = philox4x32((idx, s, z, z), seed, seed >> 32)
    b = philox4x32((idx, s, z + 1, z), seed, seed >> 32)
    bits = torch.stack(list(a) + list(b[:2]), dim=-1)
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)


def counter_draws(seed: int, index: Tensor, step):
    """The kernel's draws for rays ``index`` at bounce ``step`` (one, or one
    per index): (unit-ball float32[n, 3], uniform float32[n])."""
    return ball_from_uniforms(counter_uniforms(seed, index, step))
