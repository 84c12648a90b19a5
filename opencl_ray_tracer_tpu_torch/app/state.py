"""State machine — the reference's State/StateManager
(states/StateManager.{h,cpp}, states/State.h).

Semantics preserved: a stack of states; the manager forwards event handling
and update to the TOP state only, render to ALL states bottom-up
(StateManager.cpp:27-66). Here "render" produces status lines / framebuffers
instead of SDL draws, so the shell runs headless and is unit-testable."""

from __future__ import annotations

from typing import List, Optional


class State:
    """Abstract app state (states/State.h:19-63)."""

    state_name = "State"

    def __init__(self, manager: "StateManager"):
        self.manager = manager

    def event_handler(self, event) -> bool:
        """Handle one input event; return False to request quit."""
        return True

    def update(self, dt: float) -> None:
        pass

    def render(self) -> Optional[str]:
        """Return a status line (or None)."""
        return None


class StateManager:
    """Stack of states (states/StateManager.h:14-77)."""

    def __init__(self):
        self.states: List[State] = []

    def add_state(self, state: State) -> None:
        self.states.append(state)

    def change_state(self, state: State) -> None:
        """Pop everything, push `state` (StateManager::changeState)."""
        self.states.clear()
        self.states.append(state)

    def pop_last_state(self) -> None:
        if self.states:
            self.states.pop()

    @property
    def top(self) -> Optional[State]:
        return self.states[-1] if self.states else None

    def event_handler(self, event) -> bool:
        return self.top.event_handler(event) if self.top else True

    def update(self, dt: float) -> None:
        if self.top:
            self.top.update(dt)

    def render(self) -> List[str]:
        out = []
        for s in self.states:  # bottom-up, like the reference
            line = s.render()
            if line:
                out.append(line)
        return out
