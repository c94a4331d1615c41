"""PNG output and input (the port's own copy of the JAX package's writer and
reader; replaces stb_image_write, WritePng render.h:135-157, and the
stb_image load behind the ImageTexture, texture.h:54-76).

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


def _unfilter(raw: np.ndarray, h: int, bpp: int, stride: int) -> np.ndarray:
    """Reverse PNG scanline filters 0-4 (incl. Paeth) -> uint8[h, stride].

    None/Up are whole-row numpy ops; Sub is a modular cumsum over pixel
    columns (uint8 accumulate wraps — exactly the & 0xFF recurrence); only
    the genuinely sequential Average/Paeth rows fall back to a tight
    python-int loop (lists, not per-element numpy indexing — ~10-20x faster
    per row, and libpng-encoded photos are mostly Sub/Up/Paeth)."""
    out = np.zeros((h, stride), np.uint8)
    raw = raw.reshape(h, stride + 1)
    zero = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype = int(raw[y, 0])
        line = raw[y, 1:]
        prev = out[y - 1] if y else zero
        if ftype == 0:                       # None
            out[y] = line
        elif ftype == 1:                     # Sub: cumsum over pixels wraps
            out[y] = np.cumsum(line.reshape(-1, bpp), axis=0,
                               dtype=np.uint8).reshape(-1)
        elif ftype == 2:                     # Up (uint8 add wraps)
            out[y] = line + prev
        elif ftype == 3:                     # Average (left-dependent)
            cur = line.tolist()
            pv = prev.tolist()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                cur[x] = (cur[x] + ((a + pv[x]) >> 1)) & 0xFF
            out[y] = cur
        elif ftype == 4:                     # Paeth (left-dependent)
            cur = line.tolist()
            pv = prev.tolist()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = pv[x]
                c = pv[x - bpp] if x >= bpp else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                cur[x] = (cur[x] + (a if (pa <= pb and pa <= pc)
                                    else (b if pb <= pc else c))) & 0xFF
            out[y] = cur
        else:
            raise ValueError(f"unknown PNG filter {ftype} on row {y}")
    return out


# Adam7 pass grid: (x_start, y_start, x_step, y_step) per pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _deinterlace_adam7(raw: np.ndarray, w: int, h: int,
                       bpp: int) -> np.ndarray:
    """Adam7: seven independently-filtered sub-images, scattered onto the
    full pixel grid -> uint8[h, w*bpp] reshaped by the caller."""
    out = np.zeros((h, w, bpp), np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        pw = (w - x0 + dx - 1) // dx
        ph = (h - y0 + dy - 1) // dy
        if pw <= 0 or ph <= 0:
            continue
        stride = pw * bpp
        n = ph * (stride + 1)
        sub = _unfilter(raw[pos:pos + n], ph, bpp, stride)
        pos += n
        out[y0::dy, x0::dx] = sub.reshape(ph, pw, bpp)
    return out.reshape(h, w * bpp)


def read_png(path: str) -> np.ndarray:
    """General PNG reader (stb_image analog for the ImageTexture path,
    texture.h:54-76): 8/16-bit, greyscale / RGB / palette / grey+alpha /
    RGBA, all scanline filters 0-4, Adam7 interlaced or not.  Returns
    uint8[H, W, 3|4] (16-bit downsampled to 8 like stb; grey expanded to
    RGB; palette resolved)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    idat = b""
    plte = None
    w = h = depth = color_type = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, depth, color_type, _, _, interlace = struct.unpack(
                ">IIBBBBB", body[:13])
            if interlace not in (0, 1):
                raise ValueError(f"{path}: unknown interlace {interlace}")
            if depth not in (8, 16):
                raise ValueError(f"{path}: bit depth {depth} unsupported")
        elif tag == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
        pos += 12 + length
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    nbytes = depth // 8
    bpp = channels * nbytes
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    px = (_deinterlace_adam7(raw, w, h, bpp) if interlace
          else _unfilter(raw, h, bpp, stride))
    if depth == 16:   # high byte == stb's 16->8 reduction
        px = px.reshape(h, w, channels, 2)[..., 0]
    else:
        px = px.reshape(h, w, channels)
    if color_type == 3:                      # palette
        if plte is None:
            raise ValueError(f"{path}: palette PNG missing PLTE")
        return plte[px[..., 0]]
    if color_type == 0:                      # greyscale
        return np.repeat(px, 3, axis=-1)
    if color_type == 4:                      # grey + alpha
        return np.concatenate([np.repeat(px[..., :1], 3, axis=-1),
                               px[..., 1:]], axis=-1)
    return px                                # RGB / RGBA
