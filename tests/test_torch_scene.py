"""Port parity: scene library, packing, config, cameras, cube bake, PNG IO.

The same seeded inputs go through the JAX package and the PyTorch port; the
scene arrays, packed layouts, config text and cameras must be bit-identical.
"""

import json
import os

import numpy as np
import pytest
import torch

import opencl_ray_tracer_tpu as J
import opencl_ray_tracer_tpu_torch as T
from opencl_ray_tracer_tpu.scene import bake_cube_params as j_bake
from opencl_ray_tracer_tpu.utils import read_png as j_read_png
from opencl_ray_tracer_tpu_torch.scene import bake_cube_params as t_bake
from opencl_ray_tracer_tpu_torch.scene import scene_from_arrays, scene_to_arrays
from opencl_ray_tracer_tpu_torch.utils import read_png, write_png

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

CPU = torch.device("cpu")
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def build(mod, name, **dev):
    if name == "scene1":
        return mod.create_scene1(**dev)
    if name == "scene2":
        return mod.create_scene2(seed=7, **dev)
    if name == "scene3":
        return mod.create_scene3(seed=0, **dev)
    if name == "scene3_small":
        return mod.random_scene(20, 20, seed=3, **dev)
    # the bench headline scene (bench.py:530): 10 spheres + 1 cube at 1080p
    return mod.random_scene(10, 1, seed=0, bounds=(1910.0, 1070.0), **dev)


SCENES = ["scene1", "scene2", "scene3", "scene3_small", "headline"]


@pytest.mark.parametrize("name", SCENES)
def test_scene_arrays_bit_identical(name):
    want = scene_to_arrays(build(J, name))
    got = scene_to_arrays(build(T, name, device=CPU))
    assert want.keys() == got.keys()
    for key in want:
        assert got[key].dtype == np.float32, key
        assert np.array_equal(want[key], got[key]), key


@pytest.mark.parametrize("name", ["scene1", "scene3_small", "headline"])
def test_pack_fields_equal(name):
    jp = build(J, name).pack()
    tp = build(T, name, device=CPU).pack()
    assert (tp.n_spheres, tp.n_tris) == (jp.n_spheres, jp.n_tris)
    assert (tp.padded_spheres, tp.padded_tris) == (jp.padded_spheres, jp.padded_tris)
    for f in ("sph_origin", "sph_radius", "sph_colour", "tri_v0", "tri_e1",
              "tri_e2", "tri_colour"):
        assert np.array_equal(np.asarray(getattr(jp, f)),
                              getattr(tp, f).numpy()), f


@pytest.mark.parametrize(
    "kw",
    [
        {},
        dict(width=1920, height=1080, shading="phong", shadows=True,
             framebuffer_dtype="packed", cull_k=48, msaa=4),
        dict(shading="lambert", mesh_shape=(2, 4), tau_depth=1.0),
    ],
)
def test_render_config_json_same_text(kw):
    text = J.RenderConfig(**kw).to_json()
    assert T.RenderConfig(**kw).to_json() == text
    # one config file drives both packages
    assert T.RenderConfig.from_json(text) == T.RenderConfig(**kw)
    assert json.loads(text)["backend"] == "pallas"


def _camera_fields(cam):
    return {f: np.asarray(getattr(cam, f))
            for f in ("o0", "dox", "doy", "d0", "ddx", "ddy")}


@pytest.mark.parametrize("kind", ["ortho", "pinhole", "pinhole_shifted"])
def test_camera_fields_equal(kind):
    if kind == "ortho":
        jc, tc = J.legacy_ortho_camera(), T.legacy_ortho_camera(device=CPU)
    else:
        args = dict(position=(320.0, 240.0, 60.0), look_at=(320.0, 240.0, -85.0),
                    fov_degrees=80.0, width=160, height=120)
        jc, tc = J.pinhole_camera(**args), T.pinhole_camera(**args, device=CPU)
        if kind == "pinhole_shifted":
            jc, tc = jc.shift_subpixel(0.25, -0.375), tc.shift_subpixel(0.25, -0.375)
    assert jc.normalize == tc.normalize
    want, got = _camera_fields(jc), _camera_fields(tc)
    for f in want:
        assert got[f].dtype == np.float32
        assert np.array_equal(want[f], got[f]), f
    jo, jd = (np.asarray(a) for a in jc.rays(24, 40))
    to, td = (a.numpy() for a in tc.rays(24, 40))
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_allclose(td, jd, rtol=1e-6, atol=1e-7)


def test_bake_cube_params_allclose():
    rng = np.random.default_rng(11)
    for _ in range(4):
        center = rng.uniform(-200, 200, 3).astype(np.float32)
        scale = rng.uniform(5, 30, 3).astype(np.float32)
        euler = rng.uniform(-3.2, 3.2, 3).astype(np.float32)
        want = np.asarray(j_bake(center, scale, euler))
        got = t_bake(torch.from_numpy(center), torch.from_numpy(scale),
                     torch.from_numpy(euler)).numpy()
        assert got.shape == (12, 3, 3)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["scene1", "scene3_small"])
def test_scene_arrays_round_trip(name):
    jax_arrays = scene_to_arrays(build(J, name))   # JAX leaves as numpy
    scene = scene_from_arrays(jax_arrays, CPU)
    back = scene_to_arrays(scene)
    for key, val in jax_arrays.items():
        assert np.array_equal(back[key], val), key
    again = scene_from_arrays(back, CPU)
    assert again.num_spheres == scene.num_spheres
    assert again.num_triangles == scene.num_triangles


@pytest.mark.parametrize(
    "name", sorted(f for f in os.listdir(GOLDEN_DIR) if f.endswith(".png"))
)
def test_read_png_matches_jax_codec(name):
    path = os.path.join(GOLDEN_DIR, name)
    assert np.array_equal(read_png(path), j_read_png(path))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)


@pytest.mark.parametrize("channels", [3, 4])
def test_read_png_all_filters(tmp_path, channels):
    """Rows filtered with each of the five PNG filter types (RGB and RGBA)
    decode to the raw pixels, as the JAX package's codec decodes them."""
    import struct
    import zlib

    rng = np.random.default_rng(5)
    h, w = 10, 7
    img = rng.integers(0, 256, size=(h, w, channels)).astype(np.uint8)
    raw = img.reshape(h, w * channels).astype(int)
    lines = []
    for y in range(h):
        ftype = y % 5
        prev = raw[y - 1] if y else np.zeros_like(raw[0])
        out = []
        for i in range(w * channels):
            left = raw[y, i - channels] if i >= channels else 0
            upleft = prev[i - channels] if i >= channels else 0
            pred = (0, left, prev[i], (left + prev[i]) // 2,
                    _paeth(left, prev[i], upleft))[ftype]
            out.append((raw[y, i] - pred) % 256)
        lines.append(bytes([ftype] + out))

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    path = str(tmp_path / "filters.png")
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                           6 if channels == 4 else 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(b"".join(lines))))
        f.write(chunk(b"IEND", b""))
    got = read_png(path)
    assert np.array_equal(got[..., :channels], img)
    assert np.all(got[..., 3] == (img[..., 3] if channels == 4 else 255))
    assert np.array_equal(got, j_read_png(path))


def test_png_round_trip(tmp_path):
    rng = np.random.default_rng(3)
    img = rng.integers(-40, 300, size=(17, 23, 4)).astype(np.int32)
    path = str(tmp_path / "rt.png")
    write_png(path, torch.from_numpy(img))
    assert np.array_equal(read_png(path), np.clip(img, 0, 255).astype(np.uint8))
    assert np.array_equal(j_read_png(path), read_png(path))
