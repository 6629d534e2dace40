"""The window/input layer and the pygame presenter of rvpt_tpu_torch
(mirrors of tests/test_window.py and tests/test_present.py), on the CPU.

The edge-triggered key state machine against the reference's transitions
(src/rvpt/window.cpp:94-137), the FPS camera controller against
main.cpp:64-86 and against the JAX controller on the same input, the
headless Viewer loop over the port's Renderer end to end, and the
PygamePresenter on SDL's dummy video driver (skipped where pygame is
missing, as on the card's machine).
"""

import numpy as np
import pytest

from rvpt_tpu import window as jwindow
from rvpt_tpu.models import camera as jcamera
from rvpt_tpu_torch.models import camera as camera_mod
from rvpt_tpu_torch.window import Action, CameraController, InputState, KeyState, Viewer


class TestInputState:
    def test_press_edge_then_held(self):
        inp = InputState()
        inp.on_key("w", Action.PRESS)
        # Events queue until the poll (GLFW delivers inside glfwPollEvents).
        assert not inp.is_key_down("w")
        inp.poll_events()
        assert inp.is_key_down("w") and not inp.is_key_held("w")
        inp.poll_events()
        assert not inp.is_key_down("w") and inp.is_key_held("w")
        inp.poll_events()  # stays held until released
        assert inp.is_key_held("w")

    def test_release_edge_clears_after_one_poll(self):
        inp = InputState()
        inp.on_key("w", Action.PRESS)
        inp.poll_events()
        inp.on_key("w", Action.RELEASE)
        inp.poll_events()
        assert inp.is_key_up("w") and not inp.is_key_held("w")
        inp.poll_events()
        assert not inp.is_key_up("w")
        assert inp._keys["w"] is KeyState.NONE

    def test_repeat_counts_as_held(self):
        inp = InputState()
        inp.on_key("w", Action.PRESS)
        inp.poll_events()
        inp.on_key("w", Action.REPEAT)
        inp.poll_events()
        assert inp.is_key_held("w")
        assert not inp.is_key_down("w")

    def test_press_while_held_does_not_retrigger_edge(self):
        inp = InputState()
        inp.on_key("w", Action.PRESS)
        inp.poll_events()
        inp.poll_events()
        inp.on_key("w", Action.PRESS)  # backend re-sends; must stay held
        inp.poll_events()
        assert inp.is_key_held("w") and not inp.is_key_down("w")

    def test_case_insensitive(self):
        inp = InputState()
        inp.on_key("W", Action.PRESS)
        inp.poll_events()
        assert inp.is_key_down("w")

    def test_mouse_move_reports_delta(self):
        inp = InputState()
        seen = []
        inp.mouse_move_callbacks.append(lambda dx, dy: seen.append((dx, dy)))
        inp.on_mouse_move(10.0, 5.0)
        inp.on_mouse_move(13.0, 3.0)
        assert seen[-1] == (3.0, -2.0)

    def test_mouse_lock_restores_position(self):
        # window.cpp:260-269: unlocking saves nothing; locking saves the
        # position, unlocking restores it.
        inp = InputState()
        inp.set_mouse_window_lock(False)
        inp.on_mouse_move(100.0, 50.0)
        inp.set_mouse_window_lock(True)   # saves (100, 50)
        inp.on_mouse_move(7.0, 8.0)
        inp.set_mouse_window_lock(False)  # restores
        assert (inp.mouse_x, inp.mouse_y) == (100.0, 50.0)


class TestCameraController:
    def make(self):
        return CameraController(), camera_mod.Camera.create(device="cpu"), InputState()

    def hold(self, inp, key):
        inp.on_key(key, Action.PRESS)
        inp.poll_events()
        inp.poll_events()  # PRESSED edge -> HELD

    def test_wasd_moves_camera_local_frame(self):
        ctl, cam, inp = self.make()
        # Rotate camera 90 deg yaw: forward (+z local) becomes +x world.
        cam = camera_mod.rotate(cam, (90.0, 0.0, 0.0))
        self.hold(inp, "w")
        out = ctl.update(inp, cam, dt=1.0)
        delta = np.asarray(out.translation) - np.asarray(cam.translation)
        np.testing.assert_allclose(delta, [3.0, 0.0, 0.0], atol=1e-5)

    def test_shift_is_5x(self):
        ctl, cam, inp = self.make()
        self.hold(inp, "w")
        self.hold(inp, "left_shift")
        out = ctl.update(inp, cam, dt=0.1)
        delta = np.asarray(out.translation)
        np.testing.assert_allclose(delta, [0.0, 0.0, 1.5], atol=1e-5)

    def test_space_ctrl_vertical(self):
        ctl, cam, inp = self.make()
        self.hold(inp, "space")
        out = ctl.update(inp, cam, dt=0.5)
        np.testing.assert_allclose(
            np.asarray(out.translation), [0.0, 1.5, 0.0], atol=1e-5
        )

    def test_arrow_rotation_is_tap_edge_only(self):
        # main.cpp:80-85 queries is_key_down (the PRESSED edge), so a held
        # arrow key rotates exactly once per press.
        ctl, cam, inp = self.make()
        inp.on_key("right", Action.PRESS)
        inp.poll_events()
        out = ctl.update(inp, cam, dt=0.0)
        assert float(out.rotation[0]) == pytest.approx(0.3)
        inp.poll_events()  # now HELD: no further rotation
        out2 = ctl.update(inp, out, dt=0.0)
        assert float(out2.rotation[0]) == pytest.approx(0.3)

    def test_mouse_look_only_while_locked(self):
        ctl, cam, inp = self.make()
        out = ctl.mouse_look(inp, cam, 10.0, 4.0)
        np.testing.assert_allclose(
            np.asarray(out.rotation), [3.0, -1.2, 0.0], atol=1e-6
        )
        inp.set_mouse_window_lock(False)
        out2 = ctl.mouse_look(inp, cam, 10.0, 4.0)
        np.testing.assert_allclose(np.asarray(out2.rotation), [0.0, 0.0, 0.0])

    def test_matches_jax_controller(self):
        """The same key and mouse sequence moves both packages' cameras
        alike (camera-local moves, taps, mouse look, clamp)."""
        seq = [("w", 0.1), ("d", 0.2), ("left_shift", 0.05), ("right", 0.0),
               ("space", 0.3), ("up", 0.0)]
        cams = []
        for win, cam_mod in ((jwindow, jcamera), (None, camera_mod)):
            ctl = (win.CameraController if win else CameraController)(clamp_vertical=True)
            inp = (win.InputState if win else InputState)()
            act = win.Action if win else Action
            kw = {} if win else {"device": "cpu"}
            cam = cam_mod.Camera.create(rotation=(20.0, 85.0, 0.0), **kw)
            for key, dt in seq:
                inp.on_key(key, act.PRESS)
                inp.poll_events()
                cam = ctl.update(inp, cam, dt)
                inp.poll_events()
                cam = ctl.update(inp, cam, dt)
            cam = ctl.mouse_look(inp, cam, 7.0, -40.0)
            cams.append(cam)
        for k in ("translation", "rotation"):
            np.testing.assert_allclose(np.asarray(getattr(cams[1], k)),
                                       np.asarray(getattr(cams[0], k)), rtol=1e-5, atol=1e-5)

    def test_pitch_clamp(self):
        ctl = CameraController(clamp_vertical=True)
        cam = camera_mod.Camera.create(rotation=(0.0, 89.0, 0.0), device="cpu")
        inp = InputState()
        inp.set_mouse_window_lock(True)
        out = ctl.mouse_look(inp, cam, 0.0, -100.0)
        assert float(out.rotation[1]) == pytest.approx(90.0)


class TestViewer:
    def make_viewer(self, frames_sink):
        from rvpt_tpu_torch import FilmConfig, RenderSettings
        from rvpt_tpu_torch.renderer import Renderer
        from rvpt_tpu_torch.scene import builtin

        cfg = FilmConfig(width=32, height=16)
        scene, camera = builtin.cornell_box(aspect=cfg.aspect, device="cpu")
        r = Renderer(scene, camera, RenderSettings(max_bounces=1), cfg)
        return Viewer(r, backend=frames_sink.append)

    def test_headless_loop_renders_and_accumulates(self):
        frames = []
        v = self.make_viewer(frames)
        n = v.run(max_frames=3)
        assert n == 3 and len(frames) == 3
        assert frames[0].shape == (16, 32, 3)
        assert int(v.renderer.film.frame) == 3

    def test_escape_closes(self):
        frames = []
        v = self.make_viewer(frames)
        v.step(dt=0.0)
        v.input.on_key("escape", Action.PRESS)
        assert v.run(max_frames=10) == 1  # one more step, then closed
        assert v.input.should_close()

    def test_camera_movement_resets_accumulation(self):
        # The dirty check (rvpt.cpp:102-111) must notice controller movement.
        frames = []
        v = self.make_viewer(frames)
        v.step(dt=0.1)
        v.step(dt=0.1)
        assert int(v.renderer.film.frame) == 2
        v.input.on_key("w", Action.PRESS)
        v.input.poll_events()  # -> held before the next step polls again
        v.step(dt=0.1)
        assert int(v.renderer.film.frame) == 1

    def test_v_toggles_debug_overlay(self):
        frames = []
        v = self.make_viewer(frames)
        v.input.on_key("v", Action.PRESS)
        v.step(dt=0.0)
        assert v.debug_overlay
        v.input.on_key("v", Action.RELEASE)
        v.step(dt=0.0)
        v.input.on_key("v", Action.PRESS)
        v.step(dt=0.0)
        assert not v.debug_overlay

    def test_i_cycles_integrator_and_resets_accumulation(self):
        # Settings hotkeys are the ImGui-panel stand-in (rvpt.cpp:270-341):
        # a settings edit must reset accumulation via the dirty fingerprint
        # (rvpt.cpp:102-111), exactly like camera movement does.
        frames = []
        v = self.make_viewer(frames)
        v.step(dt=0.0)
        v.step(dt=0.0)
        assert int(v.renderer.film.frame) == 2
        v.input.on_key("i", Action.PRESS)
        v.step(dt=0.0)
        st = v.renderer.settings
        assert st.modes() == ((9 + 1) % 11,) * 4
        assert int(v.renderer.film.frame) == 1  # reset, then drew one frame

    def test_bracket_keys_step_bounces(self):
        frames = []
        v = self.make_viewer(frames)
        assert v.renderer.settings.max_bounces == 1
        v.input.on_key("]", Action.PRESS)
        v.step(dt=0.0)
        assert v.renderer.settings.max_bounces == 2
        v.step(dt=0.0)
        assert int(v.renderer.film.frame) == 2
        v.input.on_key("left_bracket", Action.PRESS)  # pygame key name
        v.step(dt=0.0)
        assert v.renderer.settings.max_bounces == 1
        assert int(v.renderer.film.frame) == 1
        v.input.on_key("[", Action.PRESS)  # floor at 1 bounce
        v.step(dt=0.0)
        assert v.renderer.settings.max_bounces == 1

    def test_enter_release_toggles_mouse_lock(self):
        frames = []
        v = self.make_viewer(frames)
        assert v.input.mouse_locked
        v.input.on_key("enter", Action.PRESS)
        v.step(dt=0.0)
        v.input.on_key("enter", Action.RELEASE)
        v.step(dt=0.0)
        assert not v.input.mouse_locked


# ------------------------------------------------------- pygame presenter


@pytest.fixture()
def pg():
    return pytest.importorskip("pygame")


@pytest.fixture()
def presenter(pg):
    from rvpt_tpu_torch.present import PygamePresenter

    p = PygamePresenter(InputState(), 32, 16, driver="dummy")
    yield p
    p.close()


def _post_key(pg, code, down=True):
    pg.event.post(pg.event.Event(pg.KEYDOWN if down else pg.KEYUP, key=code))


def test_present_key_events_reach_input_state(pg, presenter):
    inp = presenter.input
    _post_key(pg, pg.K_w)
    presenter.pump()
    inp.poll_events()
    assert inp.is_key_down("w")
    inp.poll_events()
    assert inp.is_key_held("w")
    _post_key(pg, pg.K_w, down=False)
    presenter.pump()
    inp.poll_events()
    assert inp.is_key_up("w")


def test_present_quit_event_closes(pg, presenter):
    pg.event.post(pg.event.Event(pg.QUIT))
    presenter.pump()
    assert presenter.input.should_close()


def test_present_cursor_lock_follows_input_state(presenter):
    inp = presenter.input
    assert presenter.mouse_grabbed  # locked by default (window.h:217)
    inp.set_mouse_window_lock(False)
    presenter.pump()
    assert not presenter.mouse_grabbed
    inp.set_mouse_window_lock(True)
    presenter.pump()
    assert presenter.mouse_grabbed


def test_present_locked_motion_integrates_deltas(pg, presenter):
    inp = presenter.input
    seen = []
    inp.mouse_move_callbacks.append(lambda dx, dy: seen.append((dx, dy)))
    pg.event.post(pg.event.Event(pg.MOUSEMOTION, pos=(5, 5), rel=(3, -2)))
    presenter.pump()
    assert seen == [(3.0, -2.0)]
    # unlocked motion uses absolute positions
    inp.set_mouse_window_lock(False)
    presenter.pump()
    pg.event.post(pg.event.Event(pg.MOUSEMOTION, pos=(10, 4), rel=(7, 1)))
    presenter.pump()
    assert inp.mouse_x == 10.0 and inp.mouse_y == 4.0


def test_present_blits_frame(presenter):
    img = np.random.default_rng(0).uniform(size=(16, 32, 3)).astype(np.float32)
    presenter.present(img)  # must not raise under the dummy driver


def test_present_viewer_pygame_backend_end_to_end(pg):
    """The Viewer loop on the dummy driver: W moves the camera, Enter's
    release toggles the lock, Escape closes (main.cpp:139-155)."""
    from rvpt_tpu_torch import FilmConfig, RenderSettings
    from rvpt_tpu_torch.renderer import Renderer
    from rvpt_tpu_torch.scene import builtin

    cfg = FilmConfig(width=32, height=16)
    scene, cam = builtin.sphere_plane(aspect=cfg.aspect, device="cpu")
    r = Renderer(scene, cam, RenderSettings(max_bounces=1), cfg)
    v = Viewer(r, backend="pygame", sdl_driver="dummy")
    try:
        z0 = float(r.camera.translation[2])
        _post_key(pg, pg.K_w)
        v.step(dt=0.1)   # PRESSED this frame (movement starts when HELD)
        v.step(dt=0.1)   # HELD -> camera moves
        _post_key(pg, pg.K_w, down=False)
        v.step(dt=0.1)
        assert float(r.camera.translation[2]) > z0  # moved forward

        assert v.input.mouse_locked
        _post_key(pg, pg.K_RETURN)
        v.step(dt=0.0)
        _post_key(pg, pg.K_RETURN, down=False)
        v.step(dt=0.0)  # enter release -> toggle lock
        assert not v.input.mouse_locked
        assert not v.presenter.mouse_grabbed

        _post_key(pg, pg.K_ESCAPE)
        v.step(dt=0.0)
        assert v.input.should_close()
    finally:
        v.presenter.close()
