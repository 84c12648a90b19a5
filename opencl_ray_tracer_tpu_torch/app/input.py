"""Input manager — the reference's InputManager edge-detection semantics
(input/InputManager.h:11-334) without SDL.

The reference tracks every key/button through a per-frame state machine
Pressed -> Held -> Released -> None (input/InputManager.cpp:562-601). That
exact lifecycle is reproduced here over a programmatic event queue, so the
app shell works headless (tests, scripted benchmark runs) and from a TTY."""

from __future__ import annotations

import enum
from typing import Dict, Iterable, List, Optional, Set, Tuple

from opencl_ray_tracer_tpu_torch.app.controller import (
    Axis1D,
    Axis2D,
    Button,
    Controller,
)


class ButtonState(enum.Enum):
    NONE = 0
    PRESSED = 1   # went down this frame
    HELD = 2      # still down
    RELEASED = 3  # went up this frame


class InputManager:
    def __init__(self):
        self._keys: Dict[str, ButtonState] = {}
        self._pending_down: Set[str] = set()
        self._pending_up: Set[str] = set()
        # mouse state (InputManager.h mouse surface): position, wheel,
        # buttons. Buttons share the key state machine under "mouse:<name>"
        # names so they get the same Pressed -> Held -> Released lifecycle.
        self._mouse_pos = (0, 0)
        self._mouse_delta = (0, 0)
        self._pending_mouse_pos = None
        self._wheel = 0
        self._pending_wheel = 0
        # gamepads (InputManager.h:129-210): index-addressed pad list +
        # a global 2-D-stick deadzone (InputManager.cpp:258 default 0.2)
        self._gamepads: List[Controller] = []
        self._deadzone = 0.2

    # -- event feeding (the SDL_Event pump role) ---------------------------
    def feed_key_down(self, key: str) -> None:
        self._pending_down.add(key)

    def feed_key_up(self, key: str) -> None:
        self._pending_up.add(key)

    def feed_key_tap(self, key: str) -> None:
        """Down+up in one go: PRESSED on the next update, RELEASED on the
        one after (what a terminal keypress maps to)."""
        self._pending_down.add(key)
        self._pending_up.add(key)

    def feed_mouse_move(self, x: int, y: int) -> None:
        self._pending_mouse_pos = (int(x), int(y))

    def feed_mouse_down(self, button: str = "left") -> None:
        self._pending_down.add(f"mouse:{button}")

    def feed_mouse_up(self, button: str = "left") -> None:
        self._pending_up.add(f"mouse:{button}")

    def feed_mouse_wheel(self, dy: int) -> None:
        self._pending_wheel += int(dy)

    # -- per-frame update (InputManager::update lifecycle) ------------------
    def update(self) -> None:
        # advance last frame's edge states
        for k, st in list(self._keys.items()):
            if st == ButtonState.PRESSED:
                self._keys[k] = ButtonState.HELD
            elif st == ButtonState.RELEASED:
                self._keys[k] = ButtonState.NONE

        taps = self._pending_down & self._pending_up
        downs = self._pending_down - taps
        ups = self._pending_up - taps
        self._pending_down = set()
        self._pending_up = set()

        for k in downs:
            if self._keys.get(k, ButtonState.NONE) in (
                ButtonState.NONE, ButtonState.RELEASED,
            ):
                self._keys[k] = ButtonState.PRESSED
        for k in ups:
            if self._keys.get(k, ButtonState.NONE) in (
                ButtonState.PRESSED, ButtonState.HELD,
            ):
                self._keys[k] = ButtonState.RELEASED
        for k in taps:
            self._keys[k] = ButtonState.PRESSED
            self._pending_up.add(k)  # release lands next frame

        if self._pending_mouse_pos is not None:
            px, py = self._mouse_pos
            nx, ny = self._pending_mouse_pos
            self._mouse_delta = (nx - px, ny - py)
            self._mouse_pos = self._pending_mouse_pos
            self._pending_mouse_pos = None
        else:
            self._mouse_delta = (0, 0)
        self._wheel = self._pending_wheel
        self._pending_wheel = 0

        for pad in self._gamepads:
            pad.update()

    # -- queries (InputManager.h API shape) ---------------------------------
    def was_key_pressed(self, key: str) -> bool:
        return self._keys.get(key) == ButtonState.PRESSED

    def is_key_held(self, key: str) -> bool:
        return self._keys.get(key) in (ButtonState.PRESSED, ButtonState.HELD)

    def was_key_released(self, key: str) -> bool:
        return self._keys.get(key) == ButtonState.RELEASED

    def key_state(self, key: str) -> ButtonState:
        return self._keys.get(key, ButtonState.NONE)

    def pressed_keys(self) -> Iterable[str]:
        return [k for k, s in self._keys.items() if s == ButtonState.PRESSED]

    # -- mouse queries (InputManager.h getMousePos/wasMouseButtonPressed...) --
    def mouse_pos(self) -> tuple:
        return self._mouse_pos

    def mouse_delta(self) -> tuple:
        """Movement since the previous update (getMouseDirection role)."""
        return self._mouse_delta

    def mouse_wheel(self) -> int:
        """Wheel movement accumulated over the last frame."""
        return self._wheel

    def was_mouse_pressed(self, button: str = "left") -> bool:
        return self.was_key_pressed(f"mouse:{button}")

    def is_mouse_held(self, button: str = "left") -> bool:
        return self.is_key_held(f"mouse:{button}")

    def was_mouse_released(self, button: str = "left") -> bool:
        return self.was_key_released(f"mouse:{button}")

    # -- gamepads (InputManager.h controller surface) ------------------------
    def add_controller(self, name: str = "virtual-pad",
                       rumble_supported: bool = True) -> Controller:
        """Attach a pad (the SDL_CONTROLLERDEVICEADDED role,
        InputManager.cpp addController) and return it for event feeding."""
        pad = Controller(len(self._gamepads), name, rumble_supported)
        self._gamepads.append(pad)
        return pad

    def remove_controller(self, index: int) -> None:
        if 0 <= index < len(self._gamepads):
            del self._gamepads[index]

    def get_num_controllers(self) -> int:
        return len(self._gamepads)

    def _pad(self, index: int) -> Optional[Controller]:
        """Index guard: invalid pads answer False/0 like the reference's
        bounds-checked front-end, never raise."""
        if 0 <= index < len(self._gamepads):
            return self._gamepads[index]
        return None

    def was_controller_button_pressed(self, index: int, button: Button) -> bool:
        pad = self._pad(index)
        return pad.was_button_pressed(button) if pad else False

    def is_controller_button_held(self, index: int, button: Button) -> bool:
        pad = self._pad(index)
        return pad.is_button_held(button) if pad else False

    def was_controller_button_released(self, index: int, button: Button) -> bool:
        pad = self._pad(index)
        return pad.was_button_released(button) if pad else False

    def get_controller_axis_1d(self, index: int, axis: Axis1D) -> float:
        pad = self._pad(index)
        return pad.get_axis_1d(axis) if pad else 0.0

    def get_controller_axis_2d(self, index: int,
                               axis: Axis2D) -> Tuple[float, float]:
        pad = self._pad(index)
        return pad.get_axis_2d(axis) if pad else (0.0, 0.0)

    def is_controller_axis_in_use(self, index: int, axis: Axis2D) -> bool:
        """Deadzone check (InputManager.cpp:456-461): true when either
        component of the stick is at or past the deadzone."""
        x, y = self.get_controller_axis_2d(index, axis)
        dz = self._deadzone
        return x <= -dz or x >= dz or y <= -dz or y >= dz

    def set_dead_zone(self, deadzone: float) -> None:
        self._deadzone = float(deadzone)

    def play_controller_rumble(self, index: int, strength: float,
                               length_ms: int) -> None:
        pad = self._pad(index)
        if pad:
            pad.rumble_play(strength, length_ms)

    def stop_controller_rumble(self, index: int) -> None:
        pad = self._pad(index)
        if pad:
            pad.rumble_stop()
