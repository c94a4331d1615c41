"""Philox4x32-10 (Salmon et al., SC'11) on int64 tensors holding uint32
words, and the draws the renderer keys with it: six U[0, 1) numbers per
(ray, bounce), turned into a unit-ball sample and one uniform by a
Box-Muller direction times a cube-root radius (the transform of the JAX
megakernel's ``draw_samples``)."""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor

TWO_PI = 2.0 * math.pi
MASK32 = 0xFFFFFFFF
M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
ROUNDS = 10


def _mulhilo(a: Tensor, m: int):
    x = m * (a & 0xFFFF)
    y = m * (a >> 16) + (x >> 16)
    return y >> 16, ((y & 0xFFFF) << 16) | (x & 0xFFFF)


def philox4x32(ctr, key0: int, key1: int):
    c0, c1, c2, c3 = ctr
    k0, k1 = key0 & MASK32, key1 & MASK32
    for r in range(ROUNDS):
        if r:
            k0 = (k0 + W0) & MASK32
            k1 = (k1 + W1) & MASK32
        hi0, lo0 = _mulhilo(c0, M0)
        hi1, lo1 = _mulhilo(c2, M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def counter_uniforms(seed, index: Tensor, step: int) -> Tensor:
    """float32[n, 6]: the high 24 bits of Philox4x32-10 at counters
    (index, step, 0, 0) and (index, step, 1, 0) under the key (seed low
    word, seed high word); seed: an int, or an int64 tensor of one seed
    per index."""
    idx = index.to(torch.int64) & MASK32
    s = torch.full_like(idx, step & MASK32)
    z = torch.zeros_like(idx)
    a = philox4x32((idx, s, z, z), seed, seed >> 32)
    b = philox4x32((idx, s, z + 1, z), seed, seed >> 32)
    bits = torch.stack(list(a) + list(b[:2]), dim=-1)
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)


def ball_from_uniforms(u: Tensor):
    """float[n, 6] uniforms -> (unit-ball sample float[n, 3], uniform
    float[n])."""
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


def counter_draws(seed, index: Tensor, step: int, dtype=torch.float32):
    """The draws of rays ``index`` at bounce ``step`` under ``seed``, in
    ``dtype``: (unit-ball float[n, 3], uniform float[n])."""
    return ball_from_uniforms(counter_uniforms(seed, index, step).to(dtype))

