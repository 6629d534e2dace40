"""The renderer object (mirror of ``rvpt_tpu/renderer.py``, its display part).

Owns the scene, camera, settings and the temporal film; resets
accumulation on any camera or settings change (rvpt.cpp:21-29, 102-111);
keeps up to ``frames_in_flight - 1`` frames outstanding on the card
(rvpt.h:25); reports frame statistics.  Frames go through the whole-path
tracer, built once per scene.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import torch

from .config import FilmConfig, RenderSettings
from .models.camera import Camera
from .ops.film import Film, chw_to_hwc, to_srgb_u8
from .ops.pathkernel import PathTracer, camera_params
from .render import render_frame
from .scene.scene import Scene
from .utils.image import write_png
from .utils.timer import FrameTimer

MAX_FRAMES_IN_FLIGHT = 2


def _camera_fingerprint(camera: Camera):
    return (
        tuple(camera.translation.tolist()),
        tuple(camera.rotation.tolist()),
        float(camera.fov),
        float(camera.scale),
        camera.mode,
        camera.aspect,
    )


class Renderer:
    def __init__(
        self,
        scene: Scene,
        camera: Camera,
        settings: RenderSettings | None = None,
        film: FilmConfig | None = None,
        frames_in_flight: int = MAX_FRAMES_IN_FLIGHT,
    ) -> None:
        self.settings = settings or RenderSettings()
        self.film_cfg = film or FilmConfig()
        self.camera = camera
        self.set_scene(scene)
        self.film = Film.create(self.film_cfg.height, self.film_cfg.width,
                                device=scene.device)
        self.timer = FrameTimer()
        self.frames_in_flight = max(1, int(frames_in_flight))
        self._inflight: deque = deque()
        self._image_dev = None  # last accumulated frame, CHW, on the device
        # The dirty check reads camera values to the host, and the tracer's
        # camera vector is rebuilt, only when the camera OBJECT changed
        # (exactly the frames that reset anyway).
        self._fp_cam_obj = None
        self._fp_cam_val = None
        self._cam_params = None

    @property
    def device(self) -> torch.device:
        return self.scene.device

    @property
    def image(self):
        """Last accumulated frame as a host HWC f32 tensor."""
        if self._image_dev is None:
            return None
        return chw_to_hwc(self._image_dev).cpu()

    def set_scene(self, scene: Scene) -> None:
        self.scene = scene
        self.tracer = PathTracer(scene)
        self._prev_state = None  # force an accumulation reset

    def update_camera(self, **kw) -> None:
        """Change camera fields (translation/rotation/fov/scale/mode); the
        dirty check notices and resets accumulation."""
        dev = self.camera.device
        self.camera = dataclasses.replace(
            self.camera,
            **{k: (torch.as_tensor(v, dtype=torch.float32, device=dev)
                   if k != "mode" else v) for k, v in kw.items()},
        )

    def draw(self) -> torch.Tensor:
        """Render one frame: dirty check -> sample + EMA -> stats.  Returns
        the accumulated image f32[3,H,W] on the scene's device."""
        if self.camera is self._fp_cam_obj:
            cam_fp = self._fp_cam_val
        else:
            cam_fp = _camera_fingerprint(self.camera)
            self._fp_cam_obj, self._fp_cam_val = self.camera, cam_fp
            self._cam_params = camera_params(self.camera, self.film_cfg)
        state = cam_fp + (self.settings,)
        dirty = state != self._prev_state
        self._prev_state = state

        self.timer.frame_start()
        self.film, image = render_frame(
            self.scene, self.camera, self.settings, self.film_cfg, self.film,
            dirty, tracer=self.tracer, cam_params=self._cam_params)
        # Launches are asynchronous: wait only for the frame before last, so
        # the timer measures steady-state throughput.
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            self._inflight.append(ev)
            while len(self._inflight) >= self.frames_in_flight:
                self._inflight.popleft().synchronize()
        self.timer.frame_stop()
        self._image_dev = image
        return image

    def flush(self) -> None:
        """Wait for every frame in flight."""
        while self._inflight:
            self._inflight.popleft().synchronize()

    @property
    def rays_per_frame(self) -> int:
        return (
            self.film_cfg.num_pixels * self.settings.aa * self.settings.max_bounces
        )

    def stats(self) -> dict:
        s = self.timer.stats(self.rays_per_frame)
        s["accumulated_frames"] = int(self.film.frame)
        return s

    def save_image(self, path: str) -> None:
        if self._image_dev is None:
            self.draw()
        write_png(path, to_srgb_u8(self.image).numpy())
