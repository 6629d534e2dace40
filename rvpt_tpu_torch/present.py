"""Interactive present backend: a real OS window with mouse capture
(mirror of ``rvpt_tpu/present.py``).

The reference's window layer is GLFW: key callbacks feed an edge-triggered
state machine, the cursor can be locked and hidden for mouse look, and
frames go to a swapchain (src/rvpt/window.cpp:94-161, 260-269).
``window.InputState`` reproduces the state machine; this module gives it
a pygame/SDL backend that grabs and hides the cursor and delivers relative
mouse motion while locked.  pygame is imported when a presenter is made,
never with this module.

Headless: ``driver="dummy"`` runs against SDL's dummy video driver, and
``pygame.event.post`` injects events, so tests drive the key, mouse and
lock wiring without a display.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .window import Action, InputState


def _keymap():
    import pygame

    m = {
        pygame.K_ESCAPE: "escape",
        pygame.K_RETURN: "enter",
        pygame.K_SPACE: "space",
        pygame.K_LSHIFT: "left_shift",
        pygame.K_RSHIFT: "right_shift",
        pygame.K_LCTRL: "left_control",
        pygame.K_RCTRL: "right_control",
        pygame.K_LEFT: "left",
        pygame.K_RIGHT: "right",
        pygame.K_UP: "up",
        pygame.K_DOWN: "down",
        pygame.K_LEFTBRACKET: "left_bracket",
        pygame.K_RIGHTBRACKET: "right_bracket",
    }
    for c in "abcdefghijklmnopqrstuvwxyz0123456789":
        m[getattr(pygame, f"K_{c}")] = c
    return m


class PygamePresenter:
    """SDL window bound to an ``InputState``.

    Call ``pump()`` once per frame BEFORE ``InputState.poll_events`` (it
    enqueues this frame's raw events, exactly like glfwPollEvents delivers
    callbacks) and ``present(img)`` with the HxWx3 float image after
    rendering.  The cursor lock follows ``InputState.mouse_locked``: when
    locked the cursor is hidden+grabbed and motion arrives as deltas
    (window.cpp:260-269); when unlocked the cursor is restored.
    """

    def __init__(self, input_state: InputState, width: int, height: int,
                 title: str = "rvpt_tpu_torch", driver: Optional[str] = None,
                 scale: int = 1) -> None:
        if driver is not None:
            os.environ["SDL_VIDEODRIVER"] = driver
        import pygame

        self.pygame = pygame
        self.input = input_state
        self.size = (width * scale, height * scale)
        self._film = (width, height)
        pygame.display.init()
        pygame.display.set_caption(title)
        self.screen = pygame.display.set_mode(self.size)
        self._keymap = _keymap()
        self._locked_applied: Optional[bool] = None
        # Virtual cursor position accumulated from relative motion while
        # locked (the InputState API is absolute-position based).
        self._mx, self._my = 0.0, 0.0
        self.sync_lock()

    # ------------------------------------------------------------------ events
    def pump(self) -> None:
        pg = self.pygame
        for ev in pg.event.get():
            if ev.type == pg.QUIT:
                self.input.set_close()
            elif ev.type == pg.KEYDOWN:
                name = self._keymap.get(ev.key)
                if name:
                    self.input.on_key(name, Action.PRESS)
            elif ev.type == pg.KEYUP:
                name = self._keymap.get(ev.key)
                if name:
                    self.input.on_key(name, Action.RELEASE)
            elif ev.type == pg.MOUSEMOTION:
                if self.input.mouse_locked:
                    # While locked, only deltas are meaningful
                    # (window.cpp:170-207): integrate them into a virtual
                    # position for the absolute-based InputState API.
                    self._mx += ev.rel[0]
                    self._my += ev.rel[1]
                else:
                    self._mx, self._my = float(ev.pos[0]), float(ev.pos[1])
                self.input.on_mouse_move(self._mx, self._my)
            elif ev.type == pg.MOUSEBUTTONUP and ev.button == 1:
                self.input.on_mouse_click("left", Action.RELEASE)
            elif ev.type == pg.MOUSEWHEEL:
                self.input.on_scroll(float(ev.x), float(ev.y))
        self.sync_lock()

    def sync_lock(self) -> None:
        """Apply InputState.mouse_locked to the OS cursor (grab/hide)."""
        want = bool(self.input.mouse_locked)
        if want == self._locked_applied:
            return
        pg = self.pygame
        pg.event.set_grab(want)
        pg.mouse.set_visible(not want)
        if want:
            pg.mouse.get_rel()  # drop the pent-up delta so the view doesn't jump
        self._locked_applied = want

    @property
    def mouse_grabbed(self) -> bool:
        return bool(self._locked_applied)

    # ----------------------------------------------------------------- present
    def present(self, img: np.ndarray) -> None:
        """Blit an HxWx3 float image (film layout) to the window."""
        pg = self.pygame
        u8 = (np.clip(np.asarray(img), 0.0, 1.0) * 255.0).astype(np.uint8)
        # pygame surfaces are (W, H, 3)
        surf = pg.surfarray.make_surface(u8.swapaxes(0, 1))
        if surf.get_size() != self.size:
            surf = pg.transform.scale(surf, self.size)
        self.screen.blit(surf, (0, 0))
        pg.display.flip()

    def close(self) -> None:
        self.pygame.display.quit()
