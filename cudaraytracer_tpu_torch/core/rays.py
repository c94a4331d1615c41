"""Ray batches as SoA tensors (replaces CudaTest/src/core/ray.h)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .device import resolve_device

Tensor = torch.Tensor


class Rays(NamedTuple):
    """origin float32[N, 3], direction float32[N, 3], time float32[N]
    (ray.h:7-21).  Directions are not normalized."""

    origin: Tensor
    direction: Tensor
    time: Tensor

    @property
    def batch_shape(self):
        return self.origin.shape[:-1]

    def point_at(self, t: Tensor) -> Tensor:
        """ray.h:18 point_at_t - origin + t * direction."""
        return self.origin + t[..., None] * self.direction


def make_rays(origin, direction, time=None, device=None) -> Rays:
    """Rays on ``device``; None keeps a tensor origin's device and otherwise
    means the CUDA card (core/device.py)."""
    if device is None and not isinstance(origin, torch.Tensor):
        device = resolve_device(None)
    origin = torch.as_tensor(origin, dtype=torch.float32, device=device)
    direction = torch.as_tensor(direction, dtype=torch.float32,
                                device=origin.device)
    if time is None:
        time = torch.zeros(origin.shape[:-1], dtype=torch.float32,
                           device=origin.device)
    return Rays(origin, direction,
                torch.as_tensor(time, dtype=torch.float32,
                                device=origin.device))
