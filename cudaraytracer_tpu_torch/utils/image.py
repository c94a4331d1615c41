"""PNG output (the port's own copy of the JAX package's writer; replaces
stb_image_write, WritePng render.h:135-157).

  * colorBuffer row 0 is the BOTTOM scanline; the writer flips rows
    (render.h:139-141).
  * byte = char(255.99 * c) (render.h:142-144).
  * RGBA with alpha 255 by default (RGBColor, render.h:32-38).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def to_rgba_bytes(color_buffer: np.ndarray, flip: bool = True) -> np.ndarray:
    """float32[H, W, 3] in [0, 1] (row 0 = bottom) -> uint8[H, W, 4]
    (row 0 = top)."""
    arr = np.asarray(color_buffer, np.float32)
    rgb = (255.99 * arr).astype(np.uint8)      # render.h:142-144
    if flip:
        rgb = rgb[::-1]
    alpha = np.full(rgb.shape[:2] + (1,), 255, np.uint8)
    return np.concatenate([rgb, alpha], axis=-1)


def encode_png(pixels: np.ndarray) -> bytes:
    """uint8[H, W, 3|4] -> PNG bytes (8-bit, RGB/RGBA, filter 0)."""
    pixels = np.asarray(pixels, np.uint8)
    h, w, c = pixels.shape
    color_type = {3: 2, 4: 6}[c]

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          pixels.reshape(h, w * c)], axis=1).tobytes()
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_png(path: str, color_buffer, flip: bool = True,
              rgba: bool = True) -> None:
    """Float color buffer (numpy or a tensor on any device) -> PNG file.
    Written to a temporary name and renamed, so a crash never leaves a torn
    file."""
    if hasattr(color_buffer, "detach"):
        color_buffer = color_buffer.detach().cpu().numpy()
    pix = to_rgba_bytes(color_buffer, flip)
    if not rgba:
        pix = pix[..., :3]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(encode_png(pix))
    os.replace(tmp, path)
