"""Terminal framebuffer display — the headless stand-in for the reference's
SDL window blit (states/MainState.cpp:241-254 draws the rendered Texture
every frame; main.cpp:55-81 presents it).

This build has no window system, but a modern terminal is a perfectly good
framebuffer: `render_ansi` downsamples the image and emits 24-bit-colour
half-block characters (each '▀' cell shows two vertical pixels via
foreground + background colour), so `cli app --display` and the interactive
shell can SHOW the image they trace, not just report timings. A frame on
the card is copied to the host first (numpy does the drawing)."""

from __future__ import annotations

import sys

import numpy as np

from opencl_ray_tracer_tpu_torch.utils.image import pack_rgba

HALF_BLOCK = "▀"  # upper half block: fg = top pixel, bg = bottom pixel


def _downsample(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """Nearest sampling of an (H, W, C) uint8 image (display only — goldens
    use the real framebuffer)."""
    h, w = img.shape[:2]
    ys = np.clip(((np.arange(out_h) + 0.5) * (h / out_h)).astype(int), 0, h - 1)
    xs = np.clip(((np.arange(out_w) + 0.5) * (w / out_w)).astype(int), 0, w - 1)
    return img[ys][:, xs]


def render_ansi(
    framebuffer,
    max_width: int = 100,
    max_height: int = 56,
) -> str:
    """(H, W, 4) framebuffer (or (H, W) packed words; numpy or a tensor on
    any device) -> ANSI string of 24-bit half-block cells.

    Each text row encodes two image rows; the aspect ratio of a terminal
    cell (~1:2) makes the result roughly isotropic."""
    img = pack_rgba(framebuffer)[..., :3]
    h, w = img.shape[:2]
    scale = min(max_width / w, (2 * max_height) / h, 1.0)
    out_w = max(2, int(w * scale))
    out_h = max(2, int(h * scale)) & ~1  # even: rows pair up
    small = _downsample(img, out_w, out_h)

    lines = []
    for y in range(0, out_h, 2):
        top, bot = small[y], small[y + 1]
        cells = []
        for x in range(out_w):
            tr, tg, tb = (int(v) for v in top[x])
            br, bg_, bb = (int(v) for v in bot[x])
            cells.append(
                f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg_};{bb}m"
                f"{HALF_BLOCK}"
            )
        lines.append("".join(cells) + "\x1b[0m")
    return "\n".join(lines)


def show(framebuffer, file=None, **kw) -> None:
    """Print the framebuffer to the terminal (the SDL_RenderPresent role)."""
    print(render_ansi(framebuffer, **kw), file=file or sys.stdout)
