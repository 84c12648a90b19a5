"""Math utilities — the reference's Utility namespace (misc/Utility.{h,cpp})
and Vec2/Vec3 helpers (misc/Vec2.h, misc/Vec3.h), the parts with meaning in
a headless framework.

normalise_float IS the legacy shading curve (Utility.cpp:109-116 — the
kernel re-implements it at rayTracer.cl:27-34); the 2-D intersection helpers
(Utility.cpp:127-202) back UI hit-testing in the reference and are kept for
API parity + the tile/rect math in the culling kernels.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np


def normalise_float(value, vmax, vmin=0.0):
    """(value - min) / (max - min) — Utility.cpp:109-116. No clamping,
    exactly like the reference (legacy shading relies on the overshoot)."""
    return (value - vmin) / (vmax - vmin)


def normalise_between_minus1_and_1(value, vmax, vmin=0.0):
    """Utility.cpp:97-107."""
    return normalise_float(value, vmax, vmin) * 2.0 - 1.0


def deg_to_rad(angle):
    """Utility::convertAngleToRadian (Utility.cpp:343-347)."""
    return angle * math.pi / 180.0


def rad_to_deg(angle):
    return angle * 180.0 / math.pi


class Rect(NamedTuple):
    """Axis-aligned rect (SDL_Rect role)."""

    x: float
    y: float
    w: float
    h: float

    @property
    def center(self) -> Tuple[float, float]:
        """Utility::getRectCenter."""
        return (self.x + self.w / 2.0, self.y + self.h / 2.0)


def rects_intersect(a: Rect, b: Rect) -> bool:
    """AABB overlap — the tile-vs-bbox test the culling kernel uses."""
    return (
        a.x <= b.x + b.w and a.x + a.w >= b.x
        and a.y <= b.y + b.h and a.y + a.h >= b.y
    )


def point_in_rect(px: float, py: float, r: Rect) -> bool:
    return r.x <= px <= r.x + r.w and r.y <= py <= r.y + r.h


def line_intersect(
    p1, p2, p3, p4
) -> Optional[Tuple[float, float]]:
    """Segment-segment intersection (Utility.cpp:127-165 role).

    Returns the intersection point or None."""
    p1, p2, p3, p4 = (np.asarray(p, np.float64) for p in (p1, p2, p3, p4))
    d1 = p2 - p1
    d2 = p4 - p3
    denom = d1[0] * d2[1] - d1[1] * d2[0]
    if abs(denom) < 1e-12:
        return None
    t = ((p3[0] - p1[0]) * d2[1] - (p3[1] - p1[1]) * d2[0]) / denom
    u = ((p3[0] - p1[0]) * d1[1] - (p3[1] - p1[1]) * d1[0]) / denom
    if 0.0 <= t <= 1.0 and 0.0 <= u <= 1.0:
        p = p1 + t * d1
        return (float(p[0]), float(p[1]))
    return None


def line_rect_intersect(p1, p2, rect: Rect) -> bool:
    """Segment vs rect (Utility.cpp:167-202 role)."""
    if point_in_rect(p1[0], p1[1], rect) or point_in_rect(p2[0], p2[1], rect):
        return True
    corners = [
        (rect.x, rect.y),
        (rect.x + rect.w, rect.y),
        (rect.x + rect.w, rect.y + rect.h),
        (rect.x, rect.y + rect.h),
    ]
    edges = [
        (corners[0], corners[1]),
        (corners[1], corners[2]),
        (corners[2], corners[3]),
        (corners[3], corners[0]),
    ]
    return any(line_intersect(p1, p2, a, b) is not None for a, b in edges)
