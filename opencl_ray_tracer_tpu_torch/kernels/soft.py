"""Soft differentiable render entry and the row helpers the tiled soft path
shares.

The JAX package's module of this name also holds the brute soft kernels
(B6/B7 in ROADMAP), its tiled path's overflow fallback. The port does not
need them on this path: `soft_tiled.soft_bins_for_config` re-bins with K
doubled until no tile overflows, so the tiled kernels never see a truncated
candidate list. They are still to be ported (ROADMAP B6/B7).
"""

from __future__ import annotations

import torch

from opencl_ray_tracer_tpu_torch.camera import Camera
from opencl_ray_tracer_tpu_torch.config import RenderConfig

NEG_BIG = -1e30


def _safe_norm_rows(v):
    """Row norms with ZERO gradient at exactly-zero rows (padded prims): a
    plain sqrt has an infinite derivative at 0, and 0 * inf puts NaN into
    the padded lanes of the scene-parameter gradients."""
    s2 = torch.sum(v * v, dim=-1)
    pos = s2 > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, s2, torch.ones_like(s2))),
                       torch.zeros_like(s2))


def _safe_unit_rows(v):
    mag = _safe_norm_rows(v)[..., None]
    pos = mag > 0
    return torch.where(pos, v / torch.where(pos, mag, torch.ones_like(mag)),
                       torch.zeros_like(v))


def render_soft_pallas(scene, camera: Camera, config: RenderConfig) -> torch.Tensor:
    """Soft differentiable render through the tiled soft kernels, forward
    AND backward (kernels/soft_tiled.py): CUDA on the card, their plain
    twin on the CPU. Legacy / lambert / phong, soft shadows when
    config.shadows, both camera families. Output float32 (H, W, 4), 0..255
    domain. (The name is the JAX package's entry point this ports.)"""
    from opencl_ray_tracer_tpu_torch.kernels.soft_tiled import render_soft_tiled

    return render_soft_tiled(scene, camera, config)
