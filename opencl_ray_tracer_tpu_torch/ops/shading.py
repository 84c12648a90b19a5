"""Shading models (plain torch, any device).

- `shade_legacy`: the reference's exact depth-fog shading
  (rayTracer.cl:186-196 + Utility.cpp:109-116 normaliseFloat):
      miss => (0, 0, 0, 255)
      hit  => colour * (255 - 255 * t / 180), alpha forced to 255.
  QUIRKS preserved: t > 180 drives the scalar negative (colours go negative
  before the int cast), and the int framebuffer truncates toward zero
  (C-style int cast, rayTracer.cl:198-201).
- `shade_lambert` / `shade_phong`: point lights, Lambertian diffuse, Phong
  specular, optional hard shadows, in the same 0..255 float RGBA domain.
"""

from __future__ import annotations

import torch

from opencl_ray_tracer_tpu_torch.ops.intersect import Hit, any_hit

LEGACY_FOG_MAX = 180.0  # rayTracer.cl:193 normaliseFloat(closest, 180, 0)
ALPHA_BITS = -16777216  # 0xFF000000 as int32: alpha=255 in packed RGBA words


def _with_alpha(rgb: torch.Tensor, hit: Hit) -> torch.Tensor:
    """rgb (..., 3) -> RGBA with alpha 255; misses become (0, 0, 0, 255)."""
    rgb = torch.where(hit.hit[..., None], rgb, torch.zeros_like(rgb))
    alpha = torch.full(rgb.shape[:-1] + (1,), 255.0, dtype=rgb.dtype,
                       device=rgb.device)
    return torch.cat([rgb, alpha], dim=-1)


def shade_legacy(hit: Hit) -> torch.Tensor:
    """Depth-fog shading -> float RGBA in the reference's 0..255 domain."""
    scalar = 255.0 - (hit.t / LEGACY_FOG_MAX) * 255.0
    return _with_alpha(scalar[..., None] * hit.colour[..., :3], hit)


def _light_terms(hit: Hit, scene, shadows: bool):
    """Per-light (l_dir, visibility)."""
    lights = scene.lights
    p = hit.point                                    # (..., 3)
    to_l = lights.position - p[..., None, :]         # (..., L, 3)
    dist = torch.linalg.vector_norm(to_l, dim=-1)    # (..., L)
    l_dir = to_l / torch.clamp(dist[..., None], min=1e-20)

    if shadows:
        # One shadow ray per (pixel, light): offset along the normal to avoid
        # self-intersection, any-hit within the light distance.
        origin = p + 1e-2 * hit.normal
        vis = torch.stack(
            [
                ~any_hit(origin, l_dir[..., li, :], scene, dist[..., li])
                for li in range(lights.position.shape[0])
            ],
            dim=-1,
        ).to(torch.float32)                          # (..., L)
    else:
        vis = torch.ones_like(dist)
    return l_dir, vis


def shade_lambert(hit: Hit, d, scene, shadows: bool = False) -> torch.Tensor:
    """Ambient + Lambertian diffuse from point lights; 0..255 float RGBA."""
    lights = scene.lights
    l_dir, vis = _light_terms(hit, scene, shadows)
    n = hit.normal[..., None, :]                     # (..., 1, 3)
    ndotl = torch.clamp(torch.sum(n * l_dir, dim=-1), min=0.0)   # (..., L)
    li = lights.intensity * ndotl * vis              # (..., L)
    diffuse = torch.sum(li[..., None] * lights.colour, dim=-2)  # (..., 3)
    rgb = hit.colour[..., :3] * (lights.ambient + diffuse)
    return _finalize(rgb, hit)


def shade_phong(hit: Hit, d, scene, shadows: bool = False) -> torch.Tensor:
    """Phong: ambient + diffuse + specular; 0..255 float RGBA."""
    lights = scene.lights
    l_dir, vis = _light_terms(hit, scene, shadows)
    n = hit.normal[..., None, :]
    d_b = d.expand(hit.point.shape)
    view = -d_b / torch.clamp(
        torch.linalg.vector_norm(d_b, dim=-1, keepdim=True), min=1e-20
    )
    ndotl = torch.clamp(torch.sum(n * l_dir, dim=-1), min=0.0)
    # Reflect l about n: r = 2(n.l)n - l
    r = 2.0 * torch.sum(n * l_dir, dim=-1, keepdim=True) * n - l_dir
    rdotv = torch.clamp(torch.sum(r * view[..., None, :], dim=-1), min=0.0)
    spec = lights.spec_strength * rdotv ** lights.shininess

    li_diff = lights.intensity * ndotl * vis
    li_spec = lights.intensity * spec * vis * (ndotl > 0.0)
    diffuse = torch.sum(li_diff[..., None] * lights.colour, dim=-2)
    specular = torch.sum(li_spec[..., None] * lights.colour, dim=-2)

    rgb = hit.colour[..., :3] * (lights.ambient + diffuse) + specular
    return _finalize(rgb, hit)


def _finalize(rgb, hit: Hit) -> torch.Tensor:
    """[0,1] linear RGB -> reference 0..255 float RGBA; miss stays black."""
    return _with_alpha(torch.clamp(rgb, 0.0, 1.0) * 255.0, hit)


def to_int_framebuffer(rgba: torch.Tensor) -> torch.Tensor:
    """Float 0..255 RGBA -> int32, truncating toward zero like the C cast at
    rayTracer.cl:198-201 (legacy values can be negative when t > 180)."""
    return torch.trunc(rgba).to(torch.int32)


def pack_framebuffer_words(rgba: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 4) 0..255 RGBA (int or float) -> (..., H, W) packed int32
    words R|G<<8|B<<16|255<<24, channels clamped to [0, 255] — the plain
    twin of the tiled kernel's packed output. Alpha is forced opaque."""
    ch = torch.clamp(rgba, 0, 255).to(torch.int32)
    return ch[..., 0] + ch[..., 1] * 256 + ch[..., 2] * 65536 + ALPHA_BITS
