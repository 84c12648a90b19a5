"""Game-controller (gamepad) state machine — headless.

The reference wraps SDL_GameController per pad (input/Controller.h:10-126,
Controller.cpp:1-287): 15 buttons through the same Pressed -> Held ->
Released -> None per-frame lifecycle as keys, two 2-D sticks and two
triggers normalised from raw s16 axis values, plus haptic rumble. The
InputManager front-end adds pad discovery, per-pad queries and a global
stick deadzone (InputManager.h:129-210, InputManager.cpp:258,456-466).

This build has no SDL: events are fed programmatically (tests, scripted
app runs, or a future evdev bridge), axis normalisation reproduces the
reference's exact formulas (Utility.cpp:88-116 — note raw 0 maps to
~+1.5e-5, not exactly 0, because the s16 range is asymmetric), and rumble
is tracked state + a log line instead of a haptic effect.
"""

from __future__ import annotations

import enum
from typing import Dict, Optional, Tuple

from opencl_ray_tracer_tpu_torch.utils.log import log_info, log_warning

AXIS_MIN = -32768  # Controller.h AXIS_MIN/AXIS_MAX (raw SDL s16 range)
AXIS_MAX = 32767


class Button(enum.IntEnum):
    """SDL_GameControllerButton values (Controller.h Button enum)."""

    A = 0
    B = 1
    X = 2
    Y = 3
    BACK = 4
    GUIDE = 5
    START = 6
    LEFTSTICK = 7
    RIGHTSTICK = 8
    LEFTSHOULDER = 9
    RIGHTSHOULDER = 10
    DPAD_UP = 11
    DPAD_DOWN = 12
    DPAD_LEFT = 13
    DPAD_RIGHT = 14


class Axis1D(enum.IntEnum):
    LEFT_TRIGGER = 0
    RIGHT_TRIGGER = 1


class Axis2D(enum.IntEnum):
    LEFT_STICK = 0
    RIGHT_STICK = 1


class _BState(enum.Enum):
    NONE = 0
    PRESSED = 1
    HELD = 2
    RELEASED = 3


def _normalise_float(value: float, max_: float, min_: float) -> float:
    """Utility::normaliseFloat (Utility.cpp:109-116)."""
    return (value - min_) / (max_ - min_)


def _normalise_pm1(value: float, max_: float, min_: float) -> float:
    """Utility::normaliseBetweenMinusOneAndOne (Utility.cpp:88-106) — the
    reference's stick normalisation, shift-then-scale (raw 0 -> ~+1.5e-5)."""
    max_ = max_ + abs(min_)
    value = value + abs(min_)
    return (_normalise_float(value, max_, 0.0) - 0.5) * 2.0


class Controller:
    """One gamepad: buttons + sticks + triggers + (headless) rumble.

    Events arrive via feed_* (the processEvents role, Controller.cpp:133-190)
    and are applied at the next update() — the headless equivalent of events
    pumped between frames — in arrival order, so a press and release landing
    in the same frame leaves the LAST event's state, exactly as the
    reference's event loop does. update() first advances Pressed->Held /
    Released->None (Controller.cpp:268-287), then applies the queue, so an
    edge is observable for exactly one frame (the key machine's pairing).
    """

    def __init__(self, joy_id: int, name: str = "virtual-pad",
                 rumble_supported: bool = True):
        self._joy_id = int(joy_id)
        self._name = name
        self._buttons: Dict[Button, _BState] = {
            b: _BState.NONE for b in Button
        }
        self._pending: list = []  # (Button, is_down) in arrival order
        self._left_stick = (0.0, 0.0)
        self._right_stick = (0.0, 0.0)
        self._left_trigger = 0.0
        self._right_trigger = 0.0
        self._rumble_supported = bool(rumble_supported)
        # (strength, length_ms) of the active rumble, or None.
        self._rumble: Optional[Tuple[float, int]] = None

    # -- identity (Controller.cpp:60-78) ------------------------------------
    def is_valid(self) -> bool:
        return True  # a constructed headless pad is always open

    def get_name(self) -> str:
        return self._name

    def get_joystick_id(self) -> int:
        return self._joy_id

    # -- event feeding (processEvents / updateAxis / updateButtons) ----------
    def feed_button_down(self, button: Button) -> None:
        self._pending.append((Button(button), True))

    def feed_button_up(self, button: Button) -> None:
        self._pending.append((Button(button), False))

    def feed_axis_raw(self, axis: str, value: int) -> None:
        """Raw s16 axis event (SDL_CONTROLLERAXISMOTION shape). axis is one
        of leftx/lefty/rightx/righty/lefttrigger/righttrigger."""
        v = float(value)
        if axis == "leftx":
            self._left_stick = (_normalise_pm1(v, AXIS_MAX, AXIS_MIN),
                                self._left_stick[1])
        elif axis == "lefty":
            self._left_stick = (self._left_stick[0],
                                _normalise_pm1(v, AXIS_MAX, AXIS_MIN))
        elif axis == "rightx":
            self._right_stick = (_normalise_pm1(v, AXIS_MAX, AXIS_MIN),
                                 self._right_stick[1])
        elif axis == "righty":
            self._right_stick = (self._right_stick[0],
                                 _normalise_pm1(v, AXIS_MAX, AXIS_MIN))
        elif axis == "lefttrigger":
            self._left_trigger = _normalise_float(v, AXIS_MAX, 0.0)
        elif axis == "righttrigger":
            self._right_trigger = _normalise_float(v, AXIS_MAX, 0.0)
        else:
            log_warning("unknown controller axis %r", axis)

    # -- per-frame lifecycle (Controller::update) ----------------------------
    def update(self) -> None:
        for b, st in self._buttons.items():
            if st == _BState.PRESSED:
                self._buttons[b] = _BState.HELD
            elif st == _BState.RELEASED:
                self._buttons[b] = _BState.NONE
        for b, is_down in self._pending:
            self._buttons[b] = _BState.PRESSED if is_down else _BState.RELEASED
        self._pending = []

    # -- queries (Controller.cpp:81-129) -------------------------------------
    def was_button_pressed(self, button: Button) -> bool:
        return self._buttons.get(Button(button)) == _BState.PRESSED

    def is_button_held(self, button: Button) -> bool:
        return self._buttons.get(Button(button)) in (
            _BState.PRESSED, _BState.HELD,
        )

    def was_button_released(self, button: Button) -> bool:
        return self._buttons.get(Button(button)) == _BState.RELEASED

    def get_axis_1d(self, axis: Axis1D) -> float:
        if axis == Axis1D.LEFT_TRIGGER:
            return self._left_trigger
        if axis == Axis1D.RIGHT_TRIGGER:
            return self._right_trigger
        log_warning("Invalid Axis1D requested")
        return 0.0

    def get_axis_2d(self, axis: Axis2D) -> Tuple[float, float]:
        if axis == Axis2D.LEFT_STICK:
            return self._left_stick
        if axis == Axis2D.RIGHT_STICK:
            return self._right_stick
        log_warning("Invalid Axis2D requested")
        return (0.0, 0.0)

    # -- rumble (Controller.cpp:246-266; headless: state + log) --------------
    def rumble_play(self, strength: float, length_ms: int) -> None:
        if not self._rumble_supported:
            return
        self._rumble = (float(strength), int(length_ms))
        log_info("%s rumble: strength=%.2f for %dms (headless no-op)",
                 self._name, strength, length_ms)

    def rumble_stop(self) -> None:
        if not self._rumble_supported:
            return
        self._rumble = None

    @property
    def rumble_active(self) -> Optional[Tuple[float, int]]:
        """Introspection for tests/UI: the active (strength, ms) or None."""
        return self._rumble
