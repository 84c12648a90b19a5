"""Cameras as ray bundles, from their parameters alone.

legacy ortho (the reference app's camera, MainState.cpp:34-50): the ray of
pixel (x, y) starts at (x, y, 0) and runs along (0, 0, -1), unnormalised.
pinhole: rays from one position through an image plane one unit in front,
x to the right and y down the image, through pixel centres, normalised; the
basis in float32 numpy as the project defines it (camera.py
`pinhole_camera`)."""

from __future__ import annotations

import numpy as np
import torch


def pinhole_basis(position, look_at, up, fov_degrees, width, height):
    """(origin, d00, ddx, ddy) float32 numpy vectors: the direction of pixel
    (x, y) is d00 + x ddx + y ddy, before normalising."""
    position = np.asarray(position, np.float32)
    look_at = np.asarray(look_at, np.float32)
    up = np.asarray(up, np.float32)
    fwd = look_at - position
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, fwd)
    half_h = float(np.tan(np.radians(fov_degrees) / 2.0))
    half_w = half_h * (width / height)
    ddx = right * (2.0 * half_w / width)
    ddy = -true_up * (2.0 * half_h / height)
    d00 = fwd - right * half_w + true_up * half_h + 0.5 * ddx + 0.5 * ddy
    return position, d00, ddx, ddy


def rays(cam: dict, rows: slice, width: int, device, dtype=torch.float32):
    """(o, d) of the rows `rows` of the frame, each (R, W, 3): `cam` is
    {"kind": "ortho"} or {"kind": "pinhole", "position", "look_at", "up",
    "fov_degrees", "width", "height"}."""
    f32 = dict(dtype=torch.float32, device=device)
    y = torch.arange(rows.start, rows.stop, **f32)[:, None, None]
    x = torch.arange(width, **f32)[None, :, None]
    if cam["kind"] == "ortho":
        zero = torch.zeros_like(y + x)
        o = torch.cat([x + zero, y + zero, zero], dim=-1)
        d = torch.tensor([0.0, 0.0, -1.0], **f32).expand(o.shape)
    elif cam["kind"] == "pinhole":
        pos, d00, ddx, ddy = (torch.from_numpy(np.array(v, np.float32)).to(device)
                              for v in pinhole_basis(
                                  cam["position"], cam["look_at"], cam["up"],
                                  cam["fov_degrees"], cam["width"], cam["height"]))
        d = d00 + x * ddx + y * ddy
        d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        o = pos.expand(d.shape)
    else:
        raise ValueError(f"unknown camera kind {cam['kind']!r}")
    return o.to(dtype), d.to(dtype)
