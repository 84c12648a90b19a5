"""Scene model: SoA arrays of spheres + flattened cube triangles + lights.

The reference stores spheres SoA (states/MainState.h:98-103) and flattens
cube triangles into one vertex array for the kernel (MainState.cpp:645-655).
The port keeps the JAX package's two forms, as dataclasses of float32
tensors that all lie on one device:

- `Scene`       — user-facing: sphere_origin (S,3), sphere_radius (S,),
                  sphere_colour (S,4), tri_verts (T,3,3), tri_colour (T,4),
                  lights. Differentiable leaves.
- `PackedScene` — kernel-facing: the primitive axis last and zero/far-padded
                  to a multiple of `lane` (128, as in the JAX package, so the
                  binning products compare 1:1 with it). Zero triangles have
                  det == 0 (Möller–Trumbore miss, rayTracer.cl:54-55) and
                  padding spheres sit at z=+1e9 with radius 0 (geometric-test
                  miss, rayTracer.cl:86-97).

`scene_from_arrays` / `scene_to_arrays` carry a scene across as a flat dict
of numpy arrays, the form in which the JAX package's Scene leaves reach this
package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from opencl_ray_tracer_tpu_torch.runtime.graph import device_const
from opencl_ray_tracer_tpu_torch.utils import tracing


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _f32(x, device) -> torch.Tensor:
    """float32 tensor on `device`; python/numpy inputs round once to f32
    (float64 never reaches the device)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)


@dataclasses.dataclass
class Lights:
    """Point lights + global material knobs for lambert/phong shading."""

    position: torch.Tensor       # (L, 3)
    colour: torch.Tensor         # (L, 3) linear RGB in [0, 1]
    intensity: torch.Tensor      # (L,)
    ambient: torch.Tensor        # () scalar ambient term
    spec_strength: torch.Tensor  # () Phong specular strength
    shininess: torch.Tensor      # () Phong exponent

    @classmethod
    def default(cls, device) -> "Lights":
        """One white headlight above-left of the legacy image volume."""
        return cls(
            position=_f32([[200.0, 100.0, 200.0]], device),
            colour=_f32([[1.0, 1.0, 1.0]], device),
            intensity=_f32([1.0], device),
            ambient=_f32(0.1, device),
            spec_strength=_f32(0.5, device),
            shininess=_f32(32.0, device),
        )


@dataclasses.dataclass
class Scene:
    """User-facing scene. All leaves are float32 tensors on one device."""

    sphere_origin: torch.Tensor  # (S, 3)
    sphere_radius: torch.Tensor  # (S,)
    sphere_colour: torch.Tensor  # (S, 4) RGBA; RGB in [0,1], A=255 (ref convention)
    tri_verts: torch.Tensor      # (T, 3, 3) triangle vertices (12 per cube)
    tri_colour: torch.Tensor     # (T, 4) per-triangle RGBA
    lights: Lights

    @classmethod
    def build(
        cls,
        *,
        device,
        sphere_origin=None,
        sphere_radius=None,
        sphere_colour=None,
        cubes=None,
        tri_verts=None,
        tri_colour=None,
        lights: Optional[Lights] = None,
    ) -> "Scene":
        from opencl_ray_tracer_tpu_torch.scene.cube import cubes_to_triangles

        def arr(x, shape_tail):
            if x is None:
                return torch.zeros((0,) + shape_tail, dtype=torch.float32,
                                   device=device)
            return _f32(x, device)

        if cubes is not None:
            if tri_verts is not None or tri_colour is not None:
                raise ValueError("pass either cubes or tri_verts/tri_colour")
            tri_verts, tri_colour = cubes_to_triangles(cubes)
        return cls(
            sphere_origin=arr(sphere_origin, (3,)).reshape(-1, 3),
            sphere_radius=arr(sphere_radius, ()).reshape(-1),
            sphere_colour=arr(sphere_colour, (4,)).reshape(-1, 4),
            tri_verts=arr(tri_verts, (3, 3)).reshape(-1, 3, 3),
            tri_colour=arr(tri_colour, (4,)).reshape(-1, 4),
            lights=lights or Lights.default(device),
        )

    @property
    def device(self) -> torch.device:
        return self.sphere_origin.device

    @property
    def num_spheres(self) -> int:
        return self.sphere_origin.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.tri_verts.shape[0]

    @property
    def num_cubes(self) -> int:
        return self.num_triangles // 12

    def pack(self, lane: int = 128) -> "PackedScene":
        """Transpose + pad to the kernel layout (differentiable); the span
        `frame.pack` (`utils.tracing`)."""
        with tracing.span("frame.pack"):
            s = self.num_spheres
            t = self.num_triangles
            sp = max(_round_up(max(s, 1), lane), lane)
            tp = max(_round_up(max(t, 1), lane), lane)
            dev = self.device

            def pad(x, n, fill):
                # the fill is a per-device constant: no host copy per call
                tail = device_const(fill, dev).expand((n - x.shape[0],) + x.shape[1:])
                return torch.cat([x, tail], dim=0)

            # Spheres: far-away zero-radius padding that can never win
            # (distSq > 0 => miss; and t=1e9 > the 300000 sentinel regardless).
            so = pad(self.sphere_origin, sp, [0.0, 0.0, 1e9])
            sr = pad(self.sphere_radius, sp, 0.0)
            sc = pad(self.sphere_colour, sp, 0.0)
            # Triangles: zero padding => degenerate (det == 0) => guaranteed miss.
            tv = pad(self.tri_verts, tp, 0.0)
            tc = pad(self.tri_colour, tp, 0.0)

            v0 = tv[:, 0, :]
            e1 = tv[:, 1, :] - v0
            e2 = tv[:, 2, :] - v0
            return PackedScene(
                sph_origin=so.T.contiguous(),          # (3, Sp)
                sph_radius=sr[None, :].contiguous(),   # (1, Sp)
                sph_colour=sc.T.contiguous(),          # (4, Sp)
                tri_v0=v0.T.contiguous(),              # (3, Tp)
                tri_e1=e1.T.contiguous(),              # (3, Tp)
                tri_e2=e2.T.contiguous(),              # (3, Tp)
                tri_colour=tc.T.contiguous(),          # (4, Tp)
                lights=self.lights,
                n_spheres=s,
                n_tris=t,
            )


@dataclasses.dataclass
class PackedScene:
    """Kernel-facing layout: primitive axis last, padded."""

    sph_origin: torch.Tensor  # (3, Sp)
    sph_radius: torch.Tensor  # (1, Sp)
    sph_colour: torch.Tensor  # (4, Sp)
    tri_v0: torch.Tensor      # (3, Tp)
    tri_e1: torch.Tensor      # (3, Tp)
    tri_e2: torch.Tensor      # (3, Tp)
    tri_colour: torch.Tensor  # (4, Tp)
    lights: Lights
    n_spheres: int = 0
    n_tris: int = 0

    @property
    def device(self) -> torch.device:
        return self.sph_origin.device

    @property
    def padded_spheres(self) -> int:
        return self.sph_origin.shape[1]

    @property
    def padded_tris(self) -> int:
        return self.tri_v0.shape[1]


_SCENE_KEYS = (
    "sphere_origin", "sphere_radius", "sphere_colour", "tri_verts", "tri_colour",
)
_LIGHT_KEYS = (
    "position", "colour", "intensity", "ambient", "spec_strength", "shininess",
)


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def scene_to_arrays(scene) -> Dict[str, np.ndarray]:
    """Scene -> flat dict of numpy arrays; light fields are keyed
    "lights.<field>". Reads fields by name only, so it also takes any scene
    with the same leaves whose arrays numpy can convert (e.g. the JAX
    package's Scene)."""
    out = {k: _numpy(getattr(scene, k)) for k in _SCENE_KEYS}
    for k in _LIGHT_KEYS:
        out[f"lights.{k}"] = _numpy(getattr(scene.lights, k))
    return out


def scene_from_arrays(arrays, device) -> Scene:
    """Flat dict of arrays (the keys of `scene_to_arrays`; numpy or tensors)
    -> Scene on `device`. This is how a JAX package scene's leaves, taken as
    numpy arrays, become a port scene with the same float32 values."""
    lights = Lights(**{k: _f32(arrays[f"lights.{k}"], device) for k in _LIGHT_KEYS})
    return Scene(
        **{k: _f32(arrays[k], device) for k in _SCENE_KEYS}, lights=lights
    )
