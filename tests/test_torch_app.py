"""Port parity of the app shell (app/): the same scripted event sequences
through the JAX package's and the port's InputManager, Controller and
StateManager give identical state sequences and axis values; MainState on
the CPU traces the same framebuffers as JAX's MainState on the same key
script; the gamepad bindings, the PNG dump and the display blit."""

import numpy as np
import pytest
import torch

import opencl_ray_tracer_tpu as J
import opencl_ray_tracer_tpu.app as japp
import opencl_ray_tracer_tpu_torch as T
import opencl_ray_tracer_tpu_torch.app as tapp
from opencl_ray_tracer_tpu.app import controller as jctl
from opencl_ray_tracer_tpu_torch.app import controller as tctl
from opencl_ray_tracer_tpu_torch.utils import read_png

torch.set_num_threads(2)

KEYS = ("a", "F1", "SPACE", "mouse:left")
AXES = ("leftx", "lefty", "rightx", "righty", "lefttrigger", "righttrigger")


def _event_script(seed, n=400):
    """A seeded sequence of input events (name, args) over keys, the mouse
    and two pads, with an `update` (one frame) between bursts."""
    rng = np.random.default_rng(seed)
    script = [("add_controller", ("pad0",)), ("add_controller", ("pad1", False))]
    for _ in range(n):
        kind = rng.integers(0, 10)
        if kind == 0:
            script.append(("feed_key_down", (KEYS[rng.integers(0, 3)],)))
        elif kind == 1:
            script.append(("feed_key_up", (KEYS[rng.integers(0, 3)],)))
        elif kind == 2:
            script.append(("feed_key_tap", (KEYS[rng.integers(0, 3)],)))
        elif kind == 3:
            script.append(("feed_mouse_move", tuple(int(v) for v in
                                                    rng.integers(-50, 700, 2))))
        elif kind == 4:
            script.append((("feed_mouse_down", "feed_mouse_up")[rng.integers(0, 2)],
                           ("left",)))
        elif kind == 5:
            script.append(("feed_mouse_wheel", (int(rng.integers(-3, 4)),)))
        elif kind == 6:
            script.append(("pad_button", (int(rng.integers(0, 2)),
                                          int(rng.integers(0, 15)),
                                          bool(rng.integers(0, 2)))))
        elif kind == 7:
            raw = int(rng.choice([-32768, -1, 0, 1, 32767,
                                  int(rng.integers(-32768, 32768))]))
            script.append(("pad_axis", (int(rng.integers(0, 2)),
                                        AXES[rng.integers(0, 6)], raw)))
        elif kind == 8:
            script.append(("pad_rumble", (int(rng.integers(0, 3)),
                                          float(rng.uniform(0, 1)),
                                          int(rng.integers(0, 500)))))
        else:
            script.append(("update", ()))
    return script + [("set_dead_zone", (0.35,)), ("update", ())]


def _run_inputs(mod, ctl, script):
    """Replay the script on `mod`'s InputManager; the snapshot after every
    update: every key's state, the mouse, each pad's buttons, axes,
    deadzone checks and rumble."""
    im = mod.InputManager()
    snaps = []
    for name, args in script:
        if name == "pad_button":
            pad, button, down = args
            if pad < im.get_num_controllers():
                p = im._gamepads[pad]
                (p.feed_button_down if down else p.feed_button_up)(ctl.Button(button))
        elif name == "pad_axis":
            pad, axis, raw = args
            if pad < im.get_num_controllers():
                im._gamepads[pad].feed_axis_raw(axis, raw)
        elif name == "pad_rumble":
            im.play_controller_rumble(*args)
        elif name == "add_controller":
            im.add_controller(*args)
        else:
            getattr(im, name)(*args)
        if name != "update":
            continue
        snap = [(k, im.key_state(k).name, im.was_key_pressed(k), im.is_key_held(k),
                 im.was_key_released(k)) for k in KEYS]
        snap += [im.mouse_pos(), im.mouse_delta(), im.mouse_wheel(),
                 sorted(im.pressed_keys())]
        for i in range(3):  # pad 2 does not exist: the guarded answers
            snap += [(b.name, im.was_controller_button_pressed(i, b),
                      im.is_controller_button_held(i, b),
                      im.was_controller_button_released(i, b))
                     for b in ctl.Button]
            snap += [im.get_controller_axis_1d(i, a) for a in ctl.Axis1D]
            snap += [im.get_controller_axis_2d(i, a) for a in ctl.Axis2D]
            snap += [im.is_controller_axis_in_use(i, a) for a in ctl.Axis2D]
            if i < im.get_num_controllers():
                snap.append(im._gamepads[i].rumble_active)
        snaps.append(snap)
    return snaps


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_input_and_controller_sequences_match_jax(seed):
    script = _event_script(seed)
    want = _run_inputs(japp, jctl, script)
    got = _run_inputs(tapp, tctl, script)
    assert len(got) == len(want) > 20
    assert got == want  # states, positions and axis values, exactly


def test_axis_normalisation_matches_jax_exactly():
    for raw in [-32768, -32767, -1, 0, 1, 12345, 32766, 32767]:
        for axis in AXES:
            jp, tp = jctl.Controller(0), tctl.Controller(0)
            jp.feed_axis_raw(axis, raw)
            tp.feed_axis_raw(axis, raw)
            for a in tctl.Axis1D:
                assert tp.get_axis_1d(a) == jp.get_axis_1d(jctl.Axis1D(int(a)))
            for a in tctl.Axis2D:
                assert tp.get_axis_2d(a) == jp.get_axis_2d(jctl.Axis2D(int(a)))


def _run_states(mod):
    sm = mod.StateManager()
    log = []

    class Named(mod.State):
        def __init__(self, mgr, name):
            super().__init__(mgr)
            self.name, self.updates = name, 0

        def update(self, dt):
            self.updates += 1

        def event_handler(self, event):
            return event != self.name

        def render(self):
            return f"{self.name}:{self.updates}"

    states = {n: Named(sm, n) for n in "abc"}
    for op, arg in [("add", "a"), ("add", "b"), ("update", None), ("event", "b"),
                    ("event", "a"), ("pop", None), ("update", None),
                    ("change", "c"), ("update", None), ("add", "a"),
                    ("update", None), ("pop", None), ("pop", None), ("pop", None),
                    ("update", None), ("event", "x")]:
        if op == "add":
            sm.add_state(states[arg])
        elif op == "change":
            sm.change_state(states[arg])
        elif op == "pop":
            sm.pop_last_state()
        elif op == "update":
            sm.update(0.016)
        else:
            log.append(sm.event_handler(arg))
        log.append((sm.render(), getattr(sm.top, "name", None)))
    return log


def test_state_manager_sequence_matches_jax():
    assert _run_states(tapp) == _run_states(japp)


W, H = 128, 64
# r: pallas scene 1; m: reference; m: xla; s: xla scene 2; m: pallas;
# m: reference; s: reference scene 3; m: xla
SCRIPT = ["r", "m", "m", "s", "m", "m", "s", "m"]


def _pair(cfg_kw, **kw):
    jsm, tsm = japp.StateManager(), tapp.StateManager()
    jst = japp.MainState(jsm, japp.InputManager(), config=J.RenderConfig(**cfg_kw),
                         **kw)
    tst = tapp.MainState(tsm, tapp.InputManager(), config=T.RenderConfig(**cfg_kw),
                         device="cpu", **kw)
    jsm.add_state(jst)
    tsm.add_state(tst)
    return (jsm, jst), (tsm, tst)


@pytest.mark.parametrize("shading", ["legacy", "phong"])
def test_main_state_script_matches_jax(shading):
    """The same key script through both MainStates: the same backend and
    scene after every key, the same status lines, and the same frames at
    the bars of the port's parity tests for each backend. Float phong +
    shadows frames of the oracle (reference) and the whole-frame path
    (xla): within 0.5/255 on every pixel; int legacy frames: identical on
    >= 99.9% of pixels (tests/test_torch_oracle.py, test_torch_xla_backend.py).
    The pallas frames (the port's tiled twin against JAX's kernel in
    interpret mode): identical, or within 0.5/255, on >= 99.5% of pixels
    (tests/test_torch_fwd_tiled.py), not `cli compare`'s 99.9%: in this
    128x64 corner of scene 1 a cube's diagonal seam is 0.2% of the pixels,
    and a ray on it may pass between the two triangles. There the port's
    twin and JAX's kernel differ on 9 of 8,192 int pixels, JAX's kernel and
    JAX's oracle on 18, the two oracles on 7."""
    kw = dict(width=W, height=H, shading=shading, shadows=shading == "phong",
              framebuffer_dtype="int" if shading == "legacy" else "float")
    (jsm, jst), (tsm, tst) = _pair(kw)
    seen = set()
    for key in SCRIPT:
        jl = japp.run_scripted(jsm, [key])
        tl = tapp.run_scripted(tsm, [key])
        assert (tst.backend, tst.current_scene) == (jst.backend, jst.current_scene)
        strip = lambda ls: [l.split("| Time")[0] for l in ls]  # noqa: E731
        assert strip(tl) == strip(jl)
        got = tst.framebuffer.numpy()
        want = np.asarray(jst.framebuffer)
        assert got.shape == want.shape == (H, W, 4) and got.dtype == want.dtype
        assert tst.framebuffer.device.type == "cpu"
        assert tst.time_taken_us > 0
        if got.dtype == np.int32:
            share = np.all(got == want, axis=-1).mean()
        else:
            share = (np.abs(got - want).max(axis=-1) < 0.5).mean()
        if tst.backend == "pallas":
            bar = 0.995
        else:
            bar = 0.999 if got.dtype == np.int32 else 1.0
        assert share >= bar, (key, tst.backend, tst.current_scene, share)
        seen.add((tst.backend, tst.current_scene))
    assert {b for b, _ in seen} == {"reference", "xla", "pallas"}
    assert {s for _, s in seen} == {1, 2, 3}


def _port_state(**kw):
    cfg = T.RenderConfig(width=W, height=H, shading="legacy")
    sm = tapp.StateManager()
    st = tapp.MainState(sm, tapp.InputManager(), config=cfg, device="cpu", **kw)
    sm.add_state(st)
    return sm, st


def test_main_state_needs_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: MainState takes it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tapp.MainState(tapp.StateManager(), tapp.InputManager())


def test_gamepad_drives_harness():
    """Pad buttons mirror the keyboard bindings: X = mode, Y = scene,
    A = re-run."""
    sm, st = _port_state()
    sm.update(0.016)
    pad = st.inputs.add_controller("test-pad")
    start_backend, start_scene = st.backend, st.current_scene
    pad.feed_button_down(tctl.Button.X)
    sm.update(0.016)
    assert st.backend == "reference" != start_backend
    assert st.framebuffer.device.type == "cpu"
    pad.feed_button_down(tctl.Button.Y)
    sm.update(0.016)
    assert st.current_scene == start_scene % 3 + 1
    fb_before = st.framebuffer
    pad.feed_button_down(tctl.Button.A)
    sm.update(0.016)
    assert st.framebuffer is not None and st.framebuffer is not fb_before
    assert sm.event_handler("q") is False and sm.event_handler("ESC") is False


def test_png_dump(tmp_path):
    sm, st = _port_state(png_dir=str(tmp_path))
    tapp.run_scripted(sm, ["r", "p", "m", "p"])
    names = sorted(f.name for f in tmp_path.glob("*.png"))
    assert names == ["scene1_pallas.png", "scene1_reference.png"]
    img = read_png(str(tmp_path / "scene1_reference.png"))
    fb = np.clip(st.framebuffer.numpy(), 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(img, fb)


def test_display_blits_every_new_frame_and_d_key(capsys):
    """--display re-blits the ANSI framebuffer whenever a trace produced a
    new image; 'd' prints it once on demand."""
    sm, st = _port_state(display=True)
    sm.update(0.016)  # startup trace -> blit
    assert "\x1b[38;2;" in capsys.readouterr().out
    sm.update(0.016)  # no new trace -> no re-blit
    assert "\x1b[" not in capsys.readouterr().out
    sm.event_handler("r")
    sm.update(0.016)  # re-run -> new framebuffer -> blit again
    assert "\x1b[38;2;" in capsys.readouterr().out
    sm, st = _port_state()
    sm.update(0.016)
    capsys.readouterr()
    sm.event_handler("d")
    sm.update(0.016)
    assert "\x1b[38;2;" in capsys.readouterr().out
