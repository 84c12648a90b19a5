"""Cube primitive with baked transforms.

Reproduces the reference's Cube exactly (RayTrace/Cube.cpp:9-83): a unit cube
as 36 vertices (12 triangles), where scale/rotate/translate calls multiply the
current vertex list in place — so the *call sequence* matters and transforms
compose in application order, exactly as in the scene builders
(e.g. states/MainState.cpp:436-439: scale, rotate, rotate, translate).

Rotation composes Z*Y*X per call (Cube.cpp:53-63: rotationMat = Rz * Ry * Rx,
applied as v' = rotationMat * v).

`Cube` is the host-side numpy builder, identical to the JAX package's so both
build the same float32 vertices; `bake_cube_params` is the differentiable
(center, scale, euler) parameterisation in torch.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

# The 36 unit-cube vertices in the reference's exact order (Cube.cpp:10-45).
UNIT_CUBE_VERTS = np.array(
    [
        [-1, -1, -1], [-1, -1,  1], [-1,  1,  1],
        [ 1,  1, -1], [-1, -1, -1], [-1,  1, -1],
        [ 1, -1,  1], [-1, -1, -1], [ 1, -1, -1],
        [ 1,  1, -1], [ 1, -1, -1], [-1, -1, -1],
        [-1, -1, -1], [-1,  1,  1], [-1,  1, -1],
        [ 1, -1,  1], [-1, -1,  1], [-1, -1, -1],
        [-1,  1,  1], [-1, -1,  1], [ 1, -1,  1],
        [ 1,  1,  1], [ 1, -1, -1], [ 1,  1, -1],
        [ 1, -1, -1], [ 1,  1,  1], [ 1, -1,  1],
        [ 1,  1,  1], [ 1,  1, -1], [-1,  1, -1],
        [ 1,  1,  1], [-1,  1, -1], [-1,  1,  1],
        [ 1,  1,  1], [-1,  1,  1], [ 1, -1,  1],
    ],
    dtype=np.float32,
)

TRIS_PER_CUBE = 12
VERTS_PER_CUBE = 36


def _rot_x(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)


def _rot_y(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def _rot_z(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


class Cube:
    """36-vertex cube with in-place baked transforms (reference semantics)."""

    def __init__(self, colour: Sequence[float]):
        self.vertices = UNIT_CUBE_VERTS.copy()  # (36, 3) float32
        colour = np.asarray(colour, np.float32)
        if colour.shape == (3,):
            colour = np.concatenate([colour, [255.0]]).astype(np.float32)
        if colour.shape != (4,):
            raise ValueError("cube colour must be RGB or RGBA")
        self.colour = colour

    # -- baked transforms (Cube.cpp:53-83) ---------------------------------
    def rotate(self, rotation: Sequence[float]) -> "Cube":
        """rotation = (rx, ry, rz) in radians; applies Rz @ Ry @ Rx."""
        rx, ry, rz = (float(v) for v in rotation)
        m = _rot_z(rz) @ _rot_y(ry) @ _rot_x(rx)
        self.vertices = self.vertices @ m.T
        return self

    def scale(self, s) -> "Cube":
        s = np.broadcast_to(np.asarray(s, np.float32), (3,))
        self.vertices = self.vertices * s
        return self

    def translate(self, t: Sequence[float]) -> "Cube":
        self.vertices = self.vertices + np.asarray(t, np.float32)
        return self

    # -- accessors ----------------------------------------------------------
    def get_triangles(self) -> np.ndarray:
        """(12, 3, 3) triangle vertices (Cube.cpp:48-51 returns the flat 36)."""
        return self.vertices.reshape(TRIS_PER_CUBE, 3, 3)

    def get_colour(self) -> np.ndarray:
        return self.colour


def bake_cube_params(center, scale, euler) -> torch.Tensor:
    """Differentiable cube bake: unit verts -> scale -> rotate(Z*Y*X) -> translate.

    Args are float32 tensors on one device — center (3,), scale (3,) or
    scalar, euler (3,) radians. Returns (12, 3, 3) triangle vertices on that
    device, with autograd through all inputs. Float32 matmuls must run in full
    precision (TF32 off) for the vertices to match the JAX package's
    precision="highest" bake.
    """
    center = torch.as_tensor(center, dtype=torch.float32)
    dev = center.device
    scale = torch.as_tensor(scale, dtype=torch.float32, device=dev).expand(3)
    euler = torch.as_tensor(euler, dtype=torch.float32, device=dev)
    cx, sx = torch.cos(euler[0]), torch.sin(euler[0])
    cy, sy = torch.cos(euler[1]), torch.sin(euler[1])
    cz, sz = torch.cos(euler[2]), torch.sin(euler[2])
    one = torch.ones((), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    mx = torch.stack([one, zero, zero, zero, cx, -sx, zero, sx, cx]).reshape(3, 3)
    my = torch.stack([cy, zero, sy, zero, one, zero, -sy, zero, cy]).reshape(3, 3)
    mz = torch.stack([cz, -sz, zero, sz, cz, zero, zero, zero, one]).reshape(3, 3)
    m = (mz @ my) @ mx
    verts = torch.as_tensor(UNIT_CUBE_VERTS, device=dev) * scale
    verts = verts @ m.T + center
    return verts.reshape(TRIS_PER_CUBE, 3, 3)


def cubes_to_triangles(cubes: Sequence[Cube]) -> Tuple[np.ndarray, np.ndarray]:
    """Flatten a cube list to (T, 3, 3) vertices + (T, 4) per-triangle colours
    (the reference flattens the same way, MainState.cpp:645-655)."""
    if not cubes:
        return (
            np.zeros((0, 3, 3), np.float32),
            np.zeros((0, 4), np.float32),
        )
    tris = np.concatenate([c.get_triangles() for c in cubes], axis=0)
    cols = np.concatenate(
        [np.repeat(c.colour[None, :], TRIS_PER_CUBE, axis=0) for c in cubes], axis=0
    )
    return tris.astype(np.float32), cols.astype(np.float32)
