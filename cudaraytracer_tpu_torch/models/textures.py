"""Texture table (replaces CudaTest/src/material/texture.h).

Kinds:
  CONSTANT (texture.h:12-21): color0.
  CHECKER  (texture.h:25-42): sin(10x) sin(10y) sin(10z) at the hit point;
           negative -> color1 (odd), else color0 (even).
  IMAGE    (texture.h:54-76): nearest texel, i = int(u * nx),
           j = int((1 - v) * ny - 0.001), each clamped to the image's own
           size; bytes / 255.

All images are packed into one uint8[I, max_h, max_w, 3] tensor (row 0 a
dummy) with each image's (w, h), as the JAX package packs them.  The fused
kernel fetches texels in its bounce loop (kernel mode K9,
``ops/megakernel.py``); the wavefront and the kernels' plain versions use
``texel`` below.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.device import resolve_device

Tensor = torch.Tensor

CONSTANT = 0
CHECKER = 1
IMAGE = 2


class TextureTable(NamedTuple):
    kind: Tensor      # int32[K]
    color0: Tensor    # float32[K, 3] constant color / checker even
    color1: Tensor    # float32[K, 3] checker odd
    image_id: Tensor  # int32[K]
    images: Tensor    # uint8[I, H, W, 3] (I >= 1; row 0 is a dummy)
    image_wh: Tensor  # int32[I, 2] = (w, h)


def checker_sines(p: Tensor) -> Tensor:
    """texture.h:30-38 - sin(10x) sin(10y) sin(10z) of float32[..., 3]."""
    return (torch.sin(10.0 * p[..., 0]) * torch.sin(10.0 * p[..., 1])
            * torch.sin(10.0 * p[..., 2]))


def _texel_index(x: Tensor, n: Tensor) -> Tensor:
    """int(x) clamped to [0, n - 1] (int64): truncation toward zero, as
    ``astype(int32)`` does, written as a clamp of the float first so that a
    NaN or an out-of-range x lands on a clamped texel on every device
    (NaN -> 0, as XLA converts it)."""
    x = torch.where(x > 0.0, x, 0.0)
    return torch.minimum(x, (n - 1).to(x.dtype)).long()


def texel(images: Tensor, img: Tensor, w: Tensor, h: Tensor, u: Tensor,
          v: Tensor) -> Tensor:
    """The nearest texel of image ``img`` (size w x h inside the padded
    uint8[I, H, W, 3]) at (u, v), texture.h:65-76 -> float32[N, 3]."""
    i = _texel_index(u * w.to(u.dtype), w)
    j = _texel_index((1.0 - v) * h.to(v.dtype) - 0.001, h)
    px = images[img.long(), j, i].to(torch.float32)
    # byte / 255 rounded once, as the reference's int(data) / 255.0
    # (texture.h:72).  The divisor is a tensor on the images' device: PyTorch
    # on the card turns a division by a Python scalar into a multiply by its
    # reciprocal, which differs in the last place for about half the bytes.
    return px / px.new_full((), 255.0)


def image_texel(tex: TextureTable, tex_id: Tensor, u: Tensor,
                v: Tensor) -> Tensor:
    """The IMAGE branch of eval_texture alone: the nearest texel of the
    texture's image at (u, v) -> float32[N, 3]."""
    img = tex.image_id[tex_id.long()].long()
    wh = tex.image_wh[img]
    return texel(tex.images, img, wh[..., 0], wh[..., 1], u, v)


def eval_texture(tex: TextureTable, tex_id: Tensor, u: Tensor, v: Tensor,
                 p: Tensor) -> Tensor:
    """value(u, v, p) of a batch of texture ids -> float32[N, 3]."""
    tex_id = tex_id.long()
    kind = tex.kind[tex_id]
    c0 = tex.color0[tex_id]
    odd = (kind == CHECKER) & (checker_sines(p) < 0.0)
    out = torch.where(odd[..., None], tex.color1[tex_id], c0)
    if tex.images.shape[0] == 1:
        return out        # no image registered: row 0 is the dummy
    return torch.where((kind == IMAGE)[..., None],
                       image_texel(tex, tex_id, u, v), out)


class TextureBuilder:
    """Host-side accumulation of textures into a TextureTable."""

    def __init__(self):
        self._kind = []
        self._c0 = []
        self._c1 = []
        self._img = []
        self._images = []

    def constant(self, color) -> int:
        self._kind.append(CONSTANT)
        self._c0.append(np.asarray(color, np.float32))
        self._c1.append(np.zeros(3, np.float32))
        self._img.append(0)
        return len(self._kind) - 1

    def checker(self, even, odd) -> int:
        self._kind.append(CHECKER)
        self._c0.append(np.asarray(even, np.float32))
        self._c1.append(np.asarray(odd, np.float32))
        self._img.append(0)
        return len(self._kind) - 1

    def image(self, pixels: np.ndarray) -> int:
        """pixels: uint8[H, W, 3]."""
        pixels = np.asarray(pixels, np.uint8)
        if pixels.ndim != 3 or pixels.shape[-1] != 3:
            raise ValueError(f"image must be uint8[H, W, 3]; got "
                             f"{pixels.shape}")
        self._kind.append(IMAGE)
        self._c0.append(np.zeros(3, np.float32))
        self._c1.append(np.zeros(3, np.float32))
        self._images.append(pixels)
        self._img.append(len(self._images))  # slot 0 is the dummy
        return len(self._kind) - 1

    def image_from_png(self, path: str) -> int:
        """An image texture from a PNG file (8- or 16-bit, any colour type;
        alpha dropped)."""
        from ..utils.image import read_png
        return self.image(read_png(path)[..., :3])

    def build(self, device=None) -> TextureTable:
        device = resolve_device(device)
        k = max(len(self._kind), 1)
        kind = np.zeros(k, np.int32)
        c0 = np.zeros((k, 3), np.float32)
        c1 = np.zeros((k, 3), np.float32)
        img = np.zeros(k, np.int32)
        if self._kind:
            kind[:] = self._kind
            c0[:] = np.stack(self._c0)
            c1[:] = np.stack(self._c1)
            img[:] = self._img
        max_h = max([1] + [im.shape[0] for im in self._images])
        max_w = max([1] + [im.shape[1] for im in self._images])
        images = np.zeros((1 + len(self._images), max_h, max_w, 3), np.uint8)
        image_wh = np.ones((1 + len(self._images), 2), np.int32)
        for n, im in enumerate(self._images):
            images[n + 1, :im.shape[0], :im.shape[1]] = im
            image_wh[n + 1] = (im.shape[1], im.shape[0])
        return TextureTable(*(torch.from_numpy(a).to(device)
                              for a in (kind, c0, c1, img, images, image_wh)))
