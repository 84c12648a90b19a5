"""Config / flag system, shared verbatim with the JAX package.

`RenderConfig` and `Settings` are copied field for field from
`opencl_ray_tracer_tpu/config.py`, so `RenderConfig.to_json()` gives the same
text in both packages and one config file drives either of them. The knobs
that only the JAX kernels read (tile_h/tile_w/prim_chunk, mesh_shape) are kept
so the files stay interchangeable.

In this package `backend="pallas"` selects the hand-written CUDA kernel for
the tiled hard forward frame (kernels/csrc/fwd_tiled.cu) when the scene lies
on a CUDA device, and that kernel's plain PyTorch twin when it lies on the
CPU. The name stays "pallas" so config files need no translation.
"""

from __future__ import annotations

import dataclasses
import json
import os
import xml.etree.ElementTree as ET
from typing import Any, Mapping, Optional, Tuple

# ---------------------------------------------------------------------------
# Settings: the direct analogue of the reference's XML settings file.
# ---------------------------------------------------------------------------

DEFAULT_SETTINGS_XML = """<Settings>
  <Width>640</Width>
  <Height>480</Height>
  <Fullscreen>0</Fullscreen>
  <MSAA>0</MSAA>
</Settings>
"""

MIN_WIDTH, MIN_HEIGHT = 640, 480  # Platform.cpp:253-272 validation bounds.


class SettingsError(ValueError):
    """Raised on invalid settings — the reference shows an error dialog and
    exits (Platform.cpp:245-251); we raise instead."""


@dataclasses.dataclass
class Settings:
    """Window/workload settings (reference: resources/defaultSettings.xml)."""

    width: int = 640
    height: int = 480
    fullscreen: int = 0  # 0 window, 1 fullscreen, 2 borderless (Platform.cpp:274-298)
    msaa: int = 0

    def validate(self) -> "Settings":
        if self.width < MIN_WIDTH or self.height < MIN_HEIGHT:
            raise SettingsError(
                f"Resolution {self.width}x{self.height} below minimum "
                f"{MIN_WIDTH}x{MIN_HEIGHT} (reference Platform.cpp:253-272)"
            )
        if self.fullscreen not in (0, 1, 2):
            raise SettingsError(f"Fullscreen mode must be 0-2, got {self.fullscreen}")
        if self.msaa not in (0, 2, 4, 8, 16):
            raise SettingsError(f"MSAA must be one of 0/2/4/8/16, got {self.msaa}")
        return self

    # -- loaders ------------------------------------------------------------
    @classmethod
    def from_xml(cls, path_or_text: str) -> "Settings":
        """Load from an XML settings file (or literal XML text)."""
        if os.path.exists(path_or_text):
            tree = ET.parse(path_or_text)
            root = tree.getroot()
        else:
            root = ET.fromstring(path_or_text)

        def get(tag: str, default: int) -> int:
            el = root.find(tag)
            if el is None or el.text is None:
                return default
            try:
                return int(el.text.strip())
            except ValueError as e:
                raise SettingsError(f"Bad value for <{tag}>: {el.text!r}") from e

        return cls(
            width=get("Width", 640),
            height=get("Height", 480),
            fullscreen=get("Fullscreen", 0),
            msaa=get("MSAA", 0),
        ).validate()

    @classmethod
    def from_json(cls, path_or_text: str) -> "Settings":
        if os.path.exists(path_or_text):
            with open(path_or_text) as f:
                data = json.load(f)
        else:
            data = json.loads(path_or_text)
        return cls(**data).validate()

    @classmethod
    def init_settings_file(cls, path: str) -> "Settings":
        """First-run copy of the defaults, like Platform.cpp:312-348."""
        if not os.path.exists(path):
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "w") as f:
                f.write(DEFAULT_SETTINGS_XML)
        return cls.from_xml(path)


# ---------------------------------------------------------------------------
# RenderConfig: full renderer configuration (the TPU build's flag surface).
# ---------------------------------------------------------------------------

SHADING_MODES = ("legacy", "lambert", "phong")
BACKENDS = ("reference", "xla", "pallas")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static (trace-time) renderer configuration.

    Everything here is a *static* compile-time choice: it selects which kernel
    gets traced/compiled, never a runtime branch (XLA semantics: one trace,
    one compile). Dynamic quantities (scene params, camera params) live in the
    Scene/Camera pytrees instead.
    """

    width: int = 640
    height: int = 480

    # Shading model. "legacy" is the reference's exact depth-fog pipeline
    # (rayTracer.cl:186-196); lambert/phong add point lights + hard shadows.
    shading: str = "legacy"
    shadows: bool = False

    # Anti-aliasing: 0/1 = off, else samples per pixel (2/4/8/16 — the
    # Settings bounds, Platform.cpp:274-310). The reference passes this to
    # SDL's GL multisample attributes; the TPU equivalent is supersampling —
    # `msaa` sub-pixel-jittered renders through the affine camera bundle,
    # box-filtered (models/renderer.py render()).
    msaa: int = 0

    # Backend selection (the F1 CPU<->OpenCL toggle, MainState.h:48-52).
    backend: str = "pallas"

    # Soft/differentiable rendering knobs (0 => hard mode).
    soft: bool = False
    tau_depth: float = 2.0     # soft-min temperature over hit distances
    tau_edge: float = 0.5      # edge-indicator sigmoid temperature (pixels)

    # Pallas tiling: pixel tile shape (sublane x lane aligned).
    tile_h: int = 256
    tile_w: int = 256
    # Primitive chunk size processed per inner loop step.
    prim_chunk: int = 64
    # Tiled-kernel culling: max primitive candidates per tile (triangles and
    # spheres each). Tiles exceeding this fall back to the brute kernel for
    # the frame; raise for dense scenes (cost scales linearly with it).
    cull_k: int = 32
    # Max shadow-occluder candidates per (light, tile). Shadow corridors
    # (tile -> light bbox) are much wider than tiles, so dense scenes need a
    # higher cap here than cull_k; overflow falls back to the brute kernel
    # whose per-pixel shadow loop over ALL primitives is ~100x slower.
    shadow_cull_k: int = 64

    # Output: "int" reproduces the reference's int32 RGBA framebuffer
    # (rayTracer.cl:198-201); "float" keeps float pixels (for grads);
    # "packed" is the presentation-layer framebuffer — ONE int32 per pixel
    # holding R|G<<8|B<<16|255<<24 (the little-endian RGBA byte stream,
    # channels clamped to [0,255] like utils/image.pack_rgba). Packed is
    # the fastest path on the tiled Pallas backend (4 B/pixel of HBM
    # traffic, no post-kernel untangling) and feeds the PNG/display
    # pipeline with zero conversion.
    framebuffer_dtype: str = "int"

    # Device mesh shape for sharded rendering: (data,) over image rows.
    # None (default) = all visible devices; (n,) = an n-device mesh. Read by
    # parallel/mesh.render_sharded and parallel/train.make_train_step when
    # no explicit Mesh is passed (parallel/mesh.mesh_from_config).
    mesh_shape: Optional[Tuple[int, ...]] = None

    def validate(self) -> "RenderConfig":
        if self.shading not in SHADING_MODES:
            raise ValueError(f"shading must be one of {SHADING_MODES}")
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}")
        if self.framebuffer_dtype not in ("int", "float", "packed"):
            raise ValueError(
                "framebuffer_dtype must be 'int', 'float' or 'packed', got "
                f"{self.framebuffer_dtype!r}"
            )
        if self.soft and self.framebuffer_dtype != "float":
            raise ValueError("soft rendering requires framebuffer_dtype='float'")
        if self.msaa not in (0, 1, 2, 4, 8, 16):
            raise ValueError(f"msaa must be one of 0/1/2/4/8/16, got {self.msaa}")
        if self.tile_w % 128 != 0:
            raise ValueError("tile_w must be a multiple of 128 (TPU lane dim)")
        if self.tile_h % 8 != 0:
            raise ValueError("tile_h must be a multiple of 8 (TPU sublane dim)")
        # The tiled kernels consume candidate tables in 8-sublane chunks
        # (kernels/fwd_tiled.py CHUNK, kernels/soft_tiled.py CH): K caps
        # that are not 8-multiples would fail deep inside the kernel with
        # an opaque reshape error at trace time — reject them here.
        if self.cull_k % 8 != 0:
            raise ValueError(
                f"cull_k must be a multiple of 8 (TPU sublane chunk), got "
                f"{self.cull_k}"
            )
        if self.shadow_cull_k % 8 != 0:
            raise ValueError(
                f"shadow_cull_k must be a multiple of 8 (TPU sublane chunk), "
                f"got {self.shadow_cull_k}"
            )
        if self.mesh_shape is not None:
            if (
                not isinstance(self.mesh_shape, tuple)
                or not self.mesh_shape
                or any(int(n) <= 0 for n in self.mesh_shape)
            ):
                raise ValueError(
                    "mesh_shape must be None (all devices) or a tuple of "
                    f"positive ints, got {self.mesh_shape!r}"
                )
        return self

    def replace(self, **kw: Any) -> "RenderConfig":
        return dataclasses.replace(self, **kw).validate()

    @classmethod
    def from_settings(cls, s: Settings, **kw: Any) -> "RenderConfig":
        kw.setdefault("msaa", s.msaa)
        return cls(width=s.width, height=s.height, **kw).validate()

    @classmethod
    def from_json(cls, path_or_text: str) -> "RenderConfig":
        if os.path.exists(path_or_text):
            with open(path_or_text) as f:
                data = json.load(f)
        else:
            data = json.loads(path_or_text)
        if data.get("mesh_shape") is not None:
            data["mesh_shape"] = tuple(data["mesh_shape"])
        return cls(**data).validate()

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        if d["mesh_shape"] is not None:
            d["mesh_shape"] = list(d["mesh_shape"])
        return json.dumps(d, indent=2)


def load_config(path: str, **overrides: Any) -> RenderConfig:
    """Load a RenderConfig from a JSON file or XML settings file."""
    if path.endswith(".xml"):
        return RenderConfig.from_settings(Settings.from_xml(path), **overrides)
    cfg = RenderConfig.from_json(path)
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg
