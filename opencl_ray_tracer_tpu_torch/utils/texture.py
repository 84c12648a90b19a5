"""Texture — framebuffer compositing (the reference's Texture wrapper role).

The reference wraps SDL_Texture with draw-at-position, rotated draw,
scaled draw and colour tinting (Texture.cpp:30-195; SURVEY.md §2 #10), used
to composite the rendered image and UI labels onto the screen. This build
is headless — the "screen" is an (H, W, 4) framebuffer tensor — so the same
surface is provided as torch compositing ops on the framebuffer's device:
alpha-blended blit, nearest-neighbour scaled blit, rotated blit about a
pivot, and a multiplicative colour tint, so UI composition on the card
costs no host round-trip. Blit positions may be host ints (a sliced update
touching only the overlap) or tensors (a masked full-framebuffer blend that
reads no position back to the host).

Values are in the framebuffer's 0..255 domain (int32 or float32); alpha is
the blend weight exactly as SDL's SDL_BLENDMODE_BLEND treats it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch


def _as_f32(img, device=None) -> torch.Tensor:
    return torch.as_tensor(img).to(device=device, dtype=torch.float32)


@dataclasses.dataclass
class Texture:
    """An (H, W, 4) RGBA image plus the reference wrapper's draw surface.

    Mirrors Texture.{h,cpp}: `dimensions`, `set_colour_tint`
    (Texture.cpp:188-195), `draw` (:82-118 incl. rotation about a pivot),
    `draw_scaled` (:120-176). Draw calls return a NEW destination
    framebuffer instead of mutating a renderer.
    """

    pixels: torch.Tensor                    # (H, W, 4) float32, 0..255
    tint: Tuple[float, float, float] = (1.0, 1.0, 1.0)

    def __init__(self, pixels, tint: Sequence[float] = (1.0, 1.0, 1.0)):
        self.pixels = _as_f32(pixels)
        if self.pixels.ndim != 3 or self.pixels.shape[-1] != 4:
            raise ValueError("Texture expects an (H, W, 4) RGBA array")
        self.tint = tuple(float(c) for c in tint)

    # -- reference API parity ------------------------------------------------
    @property
    def dimensions(self) -> Tuple[int, int]:
        """(width, height) like Texture::getDimensions."""
        return (self.pixels.shape[1], self.pixels.shape[0])

    def set_colour_tint(self, r: float, g: float, b: float) -> "Texture":
        """Multiplicative tint (SDL_SetTextureColorMod semantics where
        255 = identity when called with 0..255 ints; accepts 0..1 floats)."""
        scale = 1.0 / 255.0 if max(r, g, b) > 1.0 else 1.0
        return Texture(self.pixels, (r * scale, g * scale, b * scale))

    def _tinted(self) -> torch.Tensor:
        t = torch.tensor(self.tint + (1.0,), dtype=torch.float32,
                         device=self.pixels.device)
        return self.pixels * t

    def draw(self, dest, pos: Tuple[int, int], rotation_degrees: float = 0.0,
             pivot: Optional[Tuple[float, float]] = None):
        """Alpha-blend this texture onto `dest` at integer (x, y), optionally
        rotated about `pivot` (texture-local coords; defaults to the
        centre, as the reference's rotated draw overloads do)."""
        src = self._tinted()
        if rotation_degrees:
            src = _rotate_rgba(src, rotation_degrees, pivot)
        return blit(dest, src, pos)

    def draw_scaled(self, dest, pos: Tuple[int, int],
                    size: Tuple[int, int]):
        """Nearest-neighbour scaled alpha blit (Texture::drawScaled)."""
        w, h = int(size[0]), int(size[1])
        return blit(dest, resize_nearest(self._tinted(), h, w), pos)


def resize_nearest(img, out_h: int, out_w: int) -> torch.Tensor:
    """Nearest-neighbour resample of an (H, W, C) image (SDL's default
    texture scale mode)."""
    img = _as_f32(img)
    h, w = img.shape[:2]
    ar = lambda n: torch.arange(n, dtype=torch.float32, device=img.device)  # noqa: E731
    ys = torch.clamp((ar(out_h) + 0.5) * (h / out_h), 0, h - 1)
    xs = torch.clamp((ar(out_w) + 0.5) * (w / out_w), 0, w - 1)
    return img[ys.long()][:, xs.long()]


def blit(dest, src, pos) -> torch.Tensor:
    """Alpha-blend `src` onto `dest` with its top-left corner at (x, y).

    out.rgb = src.rgb * a + dest.rgb * (1 - a), a = src.alpha / 255
    (SDL_BLENDMODE_BLEND). Off-framebuffer regions are clipped. Returns a
    new tensor in dest's dtype, on dest's device.

    Positions may be host ints (a sliced update touching only the overlap)
    OR tensors (a masked full-framebuffer blend: a position computed on the
    card is never read back to the host)."""
    dest = torch.as_tensor(dest)
    dest_f = _as_f32(dest)
    src = _as_f32(src, dest.device)
    hd, wd = dest_f.shape[:2]
    hs, ws = src.shape[:2]
    x, y = pos[0], pos[1]

    if isinstance(x, int) and isinstance(y, int):
        # python-level clip (positions are host ints, like the reference's)
        sy0, sx0 = max(0, -y), max(0, -x)
        dy0, dx0 = max(0, y), max(0, x)
        dy1, dx1 = min(hd, y + hs), min(wd, x + ws)
        if dy1 <= dy0 or dx1 <= dx0:
            return dest.clone()
        sub = src[sy0 : sy0 + (dy1 - dy0), sx0 : sx0 + (dx1 - dx0)]
        region = dest_f[dy0:dy1, dx0:dx1]
        a = torch.clamp(sub[..., 3:4] * (1.0 / 255.0), 0.0, 1.0)
        rgb = sub[..., :3] * a + region[..., :3] * (1.0 - a)
        out = dest_f.clone()
        out[dy0:dy1, dx0:dx1] = torch.cat([rgb, region[..., 3:4]], dim=-1)
        return out.to(dest.dtype)

    # tensor positions: per-dest-pixel source lookup with an inside mask —
    # identical clip semantics, no host sync.
    x = torch.as_tensor(x, dtype=torch.int64, device=dest.device)
    y = torch.as_tensor(y, dtype=torch.int64, device=dest.device)
    yy = torch.arange(hd, device=dest.device)[:, None] - y
    xx = torch.arange(wd, device=dest.device)[None, :] - x
    inside = (yy >= 0) & (yy < hs) & (xx >= 0) & (xx < ws)
    sub = src[yy.clamp(0, hs - 1), xx.clamp(0, ws - 1)]
    a = torch.clamp(sub[..., 3:4] * (1.0 / 255.0), 0.0, 1.0)
    a = a * inside[..., None].to(torch.float32)
    rgb = sub[..., :3] * a + dest_f[..., :3] * (1.0 - a)
    return torch.cat([rgb, dest_f[..., 3:4]], dim=-1).to(dest.dtype)


def _rotate_rgba(img, degrees: float, pivot=None) -> torch.Tensor:
    """Rotate an RGBA image about a pivot (texture-local), exposing
    transparent (alpha 0) pixels outside the source — the SDL_RenderCopyEx
    role. Nearest-neighbour sampling on the inverse map."""
    img = _as_f32(img)
    h, w = img.shape[:2]
    cy, cx = (
        (h / 2.0, w / 2.0) if pivot is None else (float(pivot[1]), float(pivot[0]))
    )
    th = torch.deg2rad(torch.tensor(degrees, dtype=torch.float32))
    cos, sin = torch.cos(th).to(img.device), torch.sin(th).to(img.device)
    yy = torch.arange(h, dtype=torch.float32, device=img.device)[:, None] - cy
    xx = torch.arange(w, dtype=torch.float32, device=img.device)[None, :] - cx
    # inverse rotation: destination pixel -> source pixel
    sx = cos * xx + sin * yy + cx
    sy = -sin * xx + cos * yy + cy
    ix = torch.round(sx).long()
    iy = torch.round(sy).long()
    inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
    sampled = img[iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
    return torch.where(inside[..., None], sampled, 0.0)
