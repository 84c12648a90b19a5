"""Cameras as affine ray bundles.

The reference generates one ray per pixel with origin (x, y, 0) and a single
shared direction (0, 0, -1): an orthographic camera marching down -z in
image-space units (states/MainState.cpp:34-50). A camera here is six (3,)
float32 tensors, an *affine ray bundle*:

    origin(x, y) = o0 + x * dox + y * doy
    dir(x, y)    = normalize?(d0 + x * ddx + y * ddy)

The CUDA kernel rebuilds rays in registers from the pixel index, so no
per-pixel ray buffer is ever materialised; the oracle calls `rays`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Camera:
    """Affine ray bundle. All fields are (3,) float32 tensors on one device,
    except the `normalize` flag (shared-direction cameras keep the
    reference's unnormalised direction semantics)."""

    o0: torch.Tensor   # origin at pixel (0, 0)
    dox: torch.Tensor  # d(origin)/dx
    doy: torch.Tensor  # d(origin)/dy
    d0: torch.Tensor   # direction at pixel (0, 0)
    ddx: torch.Tensor  # d(direction)/dx
    ddy: torch.Tensor  # d(direction)/dy
    normalize: bool = False

    @property
    def device(self) -> torch.device:
        return self.o0.device

    @property
    def shared_dir(self) -> bool:
        """True when every pixel shares one direction (legacy ortho mode)."""
        return not self.normalize

    def shift_subpixel(self, dx: float, dy: float) -> "Camera":
        """Camera whose pixel (x, y) sees the original's (x+dx, y+dy): shift
        both affine bundles along their pixel derivatives. Exact for both
        camera families — the MSAA jitter primitive."""
        return dataclasses.replace(
            self,
            o0=self.o0 + dx * self.dox + dy * self.doy,
            d0=self.d0 + dx * self.ddx + dy * self.ddy,
        )

    def to(self, device) -> "Camera":
        """The same camera with its tensors on `device`."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self) if f.name != "normalize"})

    def rays(self, height: int, width: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Materialise (H, W, 3) origins and directions (oracle path)."""
        dev = self.device
        y = torch.arange(height, dtype=torch.float32, device=dev)[:, None, None]
        x = torch.arange(width, dtype=torch.float32, device=dev)[None, :, None]
        o = self.o0 + x * self.dox + y * self.doy
        d = self.d0 + x * self.ddx + y * self.ddy
        o = o.expand(height, width, 3)
        d = d.expand(height, width, 3)
        if self.normalize:
            d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        return o, d


def _vec(v, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(v, dtype=np.float32).copy()).to(device)


def legacy_ortho_camera(*, device) -> Camera:
    """The reference camera: origin (x, y, 0), shared direction (0, 0, -1)
    (MainState.cpp:37-39)."""
    z3 = _vec([0.0, 0.0, 0.0], device)
    return Camera(
        o0=z3,
        dox=_vec([1.0, 0.0, 0.0], device),
        doy=_vec([0.0, 1.0, 0.0], device),
        d0=_vec([0.0, 0.0, -1.0], device),
        ddx=z3,
        ddy=z3,
        normalize=False,
    )


def pinhole_camera(
    position,
    look_at,
    up=(0.0, 1.0, 0.0),
    fov_degrees: float = 45.0,
    width: int = 640,
    height: int = 480,
    *,
    device,
) -> Camera:
    """A real pinhole camera: rays share an origin, directions fan out
    through an image plane one unit in front and are normalised per pixel.
    The basis is computed in float32 numpy exactly as in the JAX package,
    so both packages build bit-identical cameras."""
    position = np.asarray(position, np.float32)
    look_at = np.asarray(look_at, np.float32)
    up = np.asarray(up, np.float32)

    fwd = look_at - position
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    true_up = np.cross(right, fwd)

    aspect = width / height
    half_h = float(np.tan(np.radians(fov_degrees) / 2.0))
    half_w = half_h * aspect

    # Direction at pixel center (x + .5, y + .5); x right, y DOWN the image.
    ddx = right * (2.0 * half_w / width)
    ddy = -true_up * (2.0 * half_h / height)
    d00 = fwd - right * half_w + true_up * half_h + 0.5 * ddx + 0.5 * ddy

    z3 = _vec([0.0, 0.0, 0.0], device)
    return Camera(
        o0=_vec(position, device),
        dox=z3,
        doy=z3,
        d0=_vec(d00, device),
        ddx=_vec(ddx, device),
        ddy=_vec(ddy, device),
        normalize=True,
    )
