"""Framebuffer -> image conversion and PNG IO on the standard library.

- `pack_rgba`: int32/float32 (H, W, 4) framebuffer, or a packed (H, W) int32
  word framebuffer -> contiguous uint8 RGBA, clamped to [0, 255].
- `write_png` / `read_png`: an 8-bit RGBA PNG codec on `zlib` + `struct`
  (lodepng's role in the reference). It needs no PIL and no native build, so
  it runs wherever Python does. The decoder reads 8-bit RGB and RGBA images
  with any of the five scanline filters, non-interlaced (as the JAX
  package's native codec).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {2: 3, 6: 4}  # PNG colour type (RGB, RGBA) -> samples per pixel


def _to_numpy(framebuffer) -> np.ndarray:
    if isinstance(framebuffer, torch.Tensor):
        return framebuffer.detach().cpu().numpy()
    return np.asarray(framebuffer)


def unpack_words(words) -> np.ndarray:
    """(H, W) packed int32 RGBA words -> (H, W, 4) uint8.

    The packed framebuffer (RenderConfig.framebuffer_dtype='packed') stores
    R|G<<8|B<<16|A<<24 per pixel, the little-endian RGBA byte stream, so
    unpacking is a byte view, not arithmetic."""
    w = np.ascontiguousarray(_to_numpy(words), dtype="<i4")
    return w.view(np.uint8).reshape(w.shape + (4,))


def pack_rgba(framebuffer) -> np.ndarray:
    """(H, W, 4) int32/float32 -> (H, W, 4) uint8, clamped; a 2-D (H, W)
    int32 packed framebuffer is already the clamped byte stream."""
    fb = _to_numpy(framebuffer)
    if fb.ndim == 2 and fb.dtype == np.int32:
        return unpack_words(fb)
    return np.clip(fb, 0, 255).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def write_png(path: str, framebuffer) -> None:
    """Encode the framebuffer as an 8-bit RGBA PNG (filter 0 on every row)."""
    rgba = pack_rgba(framebuffer)
    h, w = rgba.shape[:2]
    raw = np.zeros((h, 1 + 4 * w), np.uint8)
    raw[:, 1:] = rgba.reshape(h, 4 * w)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(data: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    stride = w * bpp
    rows = np.frombuffer(data, np.uint8)[: h * (stride + 1)].reshape(
        h, stride + 1
    )
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:].copy()
        if ftype == 1 or ftype == 3 or ftype == 4:
            # left-neighbour filters run byte by byte: each byte depends on
            # the reconstructed one bpp to its left
            for i in range(stride):
                left = int(line[i - bpp]) if i >= bpp else 0
                up = int(prev[i])
                upleft = int(prev[i - bpp]) if i >= bpp else 0
                if ftype == 1:
                    pred = left
                elif ftype == 3:
                    pred = (left + up) // 2
                else:
                    pred = _paeth(left, up, upleft)
                line[i] = (int(line[i]) + pred) & 0xFF
        elif ftype == 2:
            line = (line.astype(np.uint16) + prev).astype(np.uint8)
        elif ftype != 0:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = line
        prev = line
    return out


def read_png(path: str) -> np.ndarray:
    """Decode a PNG to (H, W, 4) uint8 (golden-image tests, fit targets)."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat = 8, []
    w = h = depth = ctype = interlace = None
    while pos + 8 <= len(buf):
        (length,) = struct.unpack(">I", buf[pos : pos + 4])
        kind = buf[pos + 4 : pos + 8]
        data = buf[pos + 8 : pos + 8 + length]
        if kind == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(
                ">IIBBBBB", data
            )
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if w is None or depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(
            f"{path}: only 8-bit non-interlaced RGB/RGBA PNGs are read"
        )
    bpp = _CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w, bpp).reshape(
        h, w, bpp
    )
    if bpp == 4:
        return px
    rgba = np.full((h, w, 4), 255, np.uint8)
    rgba[..., :3] = px
    return rgba
