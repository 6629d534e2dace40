"""Interactive window / input layer (mirror of ``rvpt_tpu/window.py``).

The reference wraps GLFW in a ``Window`` with an edge-triggered key-state
machine, mouse-look with a cursor lock and an FPS-style camera controller
in the app loop (src/rvpt/window.h:14-227, window.cpp:10-269,
main.cpp:64-86,110-155).  Split as the JAX package splits it:

* ``InputState`` — the key/mouse state machine, backend-agnostic: events
  go in (press/release/repeat), ``poll_events()`` advances the edges
  (pressed→held, released→none — window.cpp:94-106), and the queries
  mirror ``is_key_down/up/held`` (window.cpp:123-137).
* ``CameraController`` — the reference's ``update_camera``
  (main.cpp:64-86): WASD/space/ctrl camera-local translation at 3 u/s (5x
  with shift), arrow taps rotating 0.3 deg, mouse-look at 0.3 deg/count
  while the cursor is locked (main.cpp:117-122).
* ``Viewer`` — the interactive loop (main.cpp:139-155): ESC closes, R
  hot-reloads, V toggles the debug overlay, Enter-release toggles the mouse
  lock; each frame polls input, moves the camera, draws via ``Renderer``
  (whose dirty check resets accumulation on a camera change,
  rvpt.cpp:102-111), and presents through a backend: "none", a callable,
  "pygame" or "matplotlib", the last two imported only when chosen.
"""

from __future__ import annotations

import enum
from typing import Callable, Optional


class KeyState(enum.Enum):
    """window.h:200-209."""

    NONE = 0
    PRESSED = 1   # the frame the key went down
    HELD = 2      # every later frame until release
    REPEAT = 3    # OS-triggered autorepeat (counts as held)
    RELEASED = 4  # the frame the key went up, cleared next poll


class Action(enum.Enum):
    PRESS = 0
    RELEASE = 1
    REPEAT = 2


# Key names are plain strings ("w", "space", "left_shift", "escape", ...)
# instead of the reference's 1024-entry GLFW keycode array (window.h:17-139).
class InputState:
    """Edge-triggered input state machine (window.cpp:94-161)."""

    def __init__(self) -> None:
        self._keys: dict[str, KeyState] = {}
        self._pending: list[tuple[str, Action]] = []
        self.mouse_x = 0.0
        self.mouse_y = 0.0
        self._prev_x = 0.0
        self._prev_y = 0.0
        self.mouse_dx = 0.0
        self.mouse_dy = 0.0
        self.mouse_locked = True          # window.h:217
        self._saved_pos = (0.0, 0.0)
        self.mouse_move_callbacks: list[Callable[[float, float], None]] = []
        self.mouse_click_callbacks: list[Callable[[str, Action], None]] = []
        self.scroll_callbacks: list[Callable[[float, float], None]] = []
        self._should_close = False

    # -- event intake (the GLFW callbacks, window.cpp:139-249) --
    def on_key(self, key: str, action: Action) -> None:
        """Key events queue until the next ``poll_events`` — GLFW delivers
        callbacks *inside* glfwPollEvents, after the edge advance
        (window.cpp:94-106), and the edge logic depends on that order."""
        self._pending.append((key.lower(), action))

    def on_mouse_move(self, x: float, y: float) -> None:
        """window.cpp:170-207: callbacks receive the *change*, and only the
        change is meaningful while the cursor is locked."""
        self._prev_x, self._prev_y = self.mouse_x, self.mouse_y
        self.mouse_x, self.mouse_y = x, y
        self.mouse_dx = x - self._prev_x
        self.mouse_dy = y - self._prev_y
        for cb in self.mouse_move_callbacks:
            cb(self.mouse_dx, self.mouse_dy)

    def on_mouse_click(self, button: str, action: Action) -> None:
        for cb in self.mouse_click_callbacks:
            cb(button, action)

    def on_scroll(self, dx: float, dy: float) -> None:
        for cb in self.scroll_callbacks:
            cb(dx, dy)

    # -- per-frame edge advance + event delivery (window.cpp:94-161) --
    def poll_events(self) -> None:
        for key, state in list(self._keys.items()):
            if state is KeyState.RELEASED:
                self._keys[key] = KeyState.NONE
            elif state is KeyState.PRESSED:
                self._keys[key] = KeyState.HELD
        pending, self._pending = self._pending, []
        for key, action in pending:
            if action is Action.RELEASE:
                self._keys[key] = KeyState.RELEASED
            elif action is Action.REPEAT:
                self._keys[key] = KeyState.REPEAT
            elif self._keys.get(key, KeyState.NONE) not in (
                KeyState.HELD,
                KeyState.REPEAT,
            ):
                # GLFW never re-sends PRESS while held; guard sloppy backends.
                self._keys[key] = KeyState.PRESSED

    # -- queries (window.cpp:123-137) --
    def is_key_down(self, key: str) -> bool:
        return self._keys.get(key.lower()) is KeyState.PRESSED

    def is_key_up(self, key: str) -> bool:
        return self._keys.get(key.lower()) is KeyState.RELEASED

    def is_key_held(self, key: str) -> bool:
        return self._keys.get(key.lower()) in (KeyState.HELD, KeyState.REPEAT)

    # -- mouse lock (window.cpp:255-269) --
    def set_mouse_window_lock(self, locked: bool) -> None:
        if locked and not self.mouse_locked:
            self._saved_pos = (self.mouse_x, self.mouse_y)
        elif not locked and self.mouse_locked:
            self.mouse_x, self.mouse_y = self._saved_pos
        self.mouse_locked = locked

    def should_close(self) -> bool:
        return self._should_close

    def set_close(self) -> None:
        self._should_close = True


class CameraController:
    """main.cpp:64-86, bound to an ``InputState`` and a ``Camera``."""

    MOVE_SPEED = 3.0       # units/s (main.cpp:70-76)
    SHIFT_MULT = 5.0       # main.cpp:69
    ROT_STEP = 0.3         # degrees per arrow tap (main.cpp:80-85)
    MOUSE_SENS = 0.3       # degrees per count (main.cpp:120)

    def __init__(self, clamp_vertical: bool = False) -> None:
        self.clamp_vertical = clamp_vertical

    def update(self, input_state: InputState, camera, dt: float):
        """Returns the camera advanced by this frame's input."""
        from .models import camera as camera_mod

        inp = input_state
        if inp.is_key_held("left_shift"):
            dt *= self.SHIFT_MULT
        mx = my = mz = 0.0
        if inp.is_key_held("space"):
            my += self.MOVE_SPEED
        if inp.is_key_held("left_control"):
            my -= self.MOVE_SPEED
        if inp.is_key_held("w"):
            mz += self.MOVE_SPEED
        if inp.is_key_held("s"):
            mz -= self.MOVE_SPEED
        if inp.is_key_held("d"):
            mx += self.MOVE_SPEED
        if inp.is_key_held("a"):
            mx -= self.MOVE_SPEED
        if mx or my or mz:
            camera = camera_mod.translate(
                camera, (dt * mx, dt * my, dt * mz)
            )

        yaw = pitch = 0.0
        if inp.is_key_down("right"):
            yaw = self.ROT_STEP
        if inp.is_key_down("left"):
            yaw = -self.ROT_STEP
        if inp.is_key_down("up"):
            pitch = -self.ROT_STEP
        if inp.is_key_down("down"):
            pitch = self.ROT_STEP
        if yaw or pitch:
            camera = camera_mod.rotate(
                camera, (yaw, pitch, 0.0), clamp_vertical=self.clamp_vertical
            )
        return camera

    def mouse_look(self, input_state: InputState, camera, dx: float, dy: float):
        """main.cpp:117-122: rotate only while the cursor is locked."""
        from .models import camera as camera_mod

        if not input_state.mouse_locked:
            return camera
        return camera_mod.rotate(
            camera,
            (dx * self.MOUSE_SENS, -dy * self.MOUSE_SENS, 0.0),
            clamp_vertical=self.clamp_vertical,
        )


class Viewer:
    """The application loop (main.cpp:139-155) over a ``Renderer``.

    ``backend`` presents frames: "pygame" opens a real OS window with the
    reference's cursor lock / mouse capture (present.PygamePresenter;
    window.cpp:260-269); "matplotlib" opens a live plot window wired to the
    InputState (close box → set_close, no cursor lock); "none" runs headless;
    a callable receives the HxWx3 float image (a NumPy array) per frame.
    ``run(max_frames=...)`` bounds the loop for scripted/headless use.
    """

    def __init__(self, renderer, backend="none",
                 on_frame: Optional[Callable] = None,
                 clamp_vertical: bool = False,
                 sdl_driver: Optional[str] = None) -> None:
        self.renderer = renderer
        self.input = InputState()
        self.controller = CameraController(clamp_vertical=clamp_vertical)
        self.debug_overlay = False
        self.on_frame = on_frame
        self._backend_name = backend if not callable(backend) else "callable"
        if callable(backend):
            self.on_frame = backend
        self._fig = None
        self._im = None
        self.presenter = None
        if backend == "pygame":
            from .present import PygamePresenter

            self.presenter = PygamePresenter(
                self.input, renderer.film_cfg.width,
                renderer.film_cfg.height, driver=sdl_driver,
            )
        elif backend == "matplotlib":
            self._init_matplotlib()
        # Mouse wiring (main.cpp:117-137): look while locked; left-release
        # toggles the lock off, next left-release re-locks.
        self.input.mouse_move_callbacks.append(self._on_mouse_move)
        self.input.mouse_click_callbacks.append(self._on_mouse_click)

    def _init_matplotlib(self) -> None:
        import matplotlib.pyplot as plt

        self._plt = plt
        self._fig, ax = plt.subplots(
            num="rvpt_tpu_torch", figsize=(8, 4.5)
        )
        ax.set_axis_off()
        import numpy as np

        shape = (self.renderer.film_cfg.height, self.renderer.film_cfg.width, 3)
        self._im = ax.imshow(np.zeros(shape, dtype=np.float32))
        canvas = self._fig.canvas
        canvas.mpl_connect(
            "key_press_event",
            lambda e: e.key and self.input.on_key(e.key, Action.PRESS),
        )
        canvas.mpl_connect(
            "key_release_event",
            lambda e: e.key and self.input.on_key(e.key, Action.RELEASE),
        )
        canvas.mpl_connect(
            "motion_notify_event",
            lambda e: self.input.on_mouse_move(e.x or 0.0, e.y or 0.0),
        )
        canvas.mpl_connect(
            "button_release_event",
            lambda e: self.input.on_mouse_click("left", Action.RELEASE),
        )
        canvas.mpl_connect("close_event", lambda e: self.input.set_close())

    def _on_mouse_move(self, dx: float, dy: float) -> None:
        self.renderer.camera = self.controller.mouse_look(
            self.input, self.renderer.camera, dx, dy
        )

    def _on_mouse_click(self, button: str, action: Action) -> None:
        if button == "left" and action is Action.RELEASE:
            self.input.set_mouse_window_lock(not self.input.mouse_locked)

    def step(self, dt: Optional[float] = None) -> None:
        """One loop iteration: poll → hotkeys → camera → draw → present."""
        inp = self.input
        if self.presenter is not None:
            self.presenter.pump()  # enqueue raw SDL events + sync cursor lock
        inp.poll_events()
        if inp.is_key_down("escape"):
            inp.set_close()
        if inp.is_key_down("r"):
            self.renderer.reload()
        if inp.is_key_down("v"):
            self.debug_overlay = not self.debug_overlay
        # Live render-settings hotkeys — the headless stand-in for the
        # reference's ImGui render-settings panel (rvpt.cpp:270-341): any
        # change lands in the dirty fingerprint and resets accumulation
        # exactly like an ImGui edit (rvpt.cpp:102-111).
        st = self.renderer.settings
        if inp.is_key_down("i"):   # cycle integrator (all quadrants)
            nxt = (st.top_left_render_mode + 1) % 11
            st = st.replace(
                top_left_render_mode=nxt, top_right_render_mode=nxt,
                bottom_left_render_mode=nxt, bottom_right_render_mode=nxt,
            )
        if inp.is_key_down("[") or inp.is_key_down("left_bracket"):
            st = st.replace(max_bounces=max(1, st.max_bounces - 1))
        if inp.is_key_down("]") or inp.is_key_down("right_bracket"):
            st = st.replace(max_bounces=min(64, st.max_bounces + 1))
        if st is not self.renderer.settings:
            self.renderer.settings = st
        if inp.is_key_up("enter"):
            inp.set_mouse_window_lock(not inp.mouse_locked)
        if self.presenter is not None:
            self.presenter.sync_lock()  # hotkeys/clicks may have toggled it

        if dt is None:
            dt = self.renderer.timer.since_last_frame()
        self.renderer.camera = self.controller.update(
            inp, self.renderer.camera, dt
        )
        self.renderer.draw()
        img = self.renderer.image
        if img is not None:
            img = img.numpy()
        if img is not None and self.debug_overlay and self.renderer.scene.num_triangles:
            img = self.renderer.debug_view("triangles")
        if self.on_frame is not None and img is not None:
            self.on_frame(img)
        if self.presenter is not None and img is not None:
            self.presenter.present(img)
        if self._im is not None and img is not None:
            self._im.set_data(img.clip(0.0, 1.0))
            self._fig.canvas.draw_idle()
            self._plt.pause(0.001)

    def run(self, max_frames: Optional[int] = None) -> int:
        frames = 0
        while not self.input.should_close():
            if max_frames is not None and frames >= max_frames:
                break
            self.step()
            frames += 1
        return frames
