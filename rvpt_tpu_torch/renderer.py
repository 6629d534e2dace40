"""The renderer object (mirror of ``rvpt_tpu/renderer.py``).

Owns the scene, camera, settings and the temporal film; resets
accumulation on any camera or settings change (rvpt.cpp:21-29, 102-111);
keeps up to ``frames_in_flight - 1`` frames outstanding on the card
(rvpt.h:25); reports frame statistics; reloads changed sources (the
analog of reload_shaders, rvpt.cpp:444-468), draws the debug views and
saves and resumes checkpoints.  Frames of any integrator, or of the 4-way
split-screen, go through the kernels of ``ops.pathkernel``; the tracer
that holds their tables (``PathTracer``, or ``BigMeshTracer`` for a big
mesh) is built once per scene.  With a ``(tiles, spp)`` device mesh,
every frame is rendered across its ranks (``parallel.sharded``).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np
import torch

from .config import FilmConfig, RenderSettings
from .models.camera import Camera
from .ops.film import Film, chw_to_hwc, to_srgb_u8
from .ops.pathkernel import camera_params
from .render import make_tracer, render_frame
from .scene.bvh import BvhHost, attach_bvh, build_bvh, triangle_bounds
from .scene.scene import Scene
from .utils import checkpoint as ckpt
from .utils.hot_reload import SourceWatcher
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
    """``use_bvh`` attaches a BVH to the scene (its triangles then take the
    kernels' BVH form); ``mesh``, a ``(tiles, spp)`` ``DeviceMesh``
    (``parallel.mesh.make_mesh``), shards every frame over its ranks; each
    rank then draws, and holds the whole film, so ``image``,
    ``save_image`` and checkpoints work on every rank."""

    def __init__(
        self,
        scene: Scene,
        camera: Camera,
        settings: RenderSettings | None = None,
        film: FilmConfig | None = None,
        use_bvh: bool = False,
        mesh=None,
        frames_in_flight: int = MAX_FRAMES_IN_FLIGHT,
    ) -> None:
        if mesh is not None:
            from .parallel.sharded import mesh_coords

            mesh_coords(mesh)  # a (tiles, spp) DeviceMesh, or raise
        self.mesh = mesh
        # The sharded frame step, made once per (settings, film, mesh).
        self._sharded_step = None
        self._sharded_key = None
        self.settings = settings or RenderSettings()
        self.film_cfg = film or FilmConfig()
        self.camera = camera
        self.set_scene(scene, use_bvh)
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
        # Created now, so that the first reload() sees the edits made since
        # construction (the reference's first R press works).
        self._watcher = SourceWatcher()

    @property
    def device(self) -> torch.device:
        return self.scene.device

    @property
    def image(self):
        """Last accumulated frame as a host HWC f32 tensor."""
        if self._image_dev is None:
            return None
        return chw_to_hwc(self._image_dev).cpu()

    def set_scene(self, scene: Scene, use_bvh: bool = False) -> None:
        self.scene = attach_bvh(scene) if use_bvh else scene
        self.tracer = make_tracer(self.scene)
        self._prev_state = None  # force an accumulation reset
        self._host_bvh: Optional[BvhHost] = None

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
        if self.mesh is not None:
            key = (self.settings, self.film_cfg, self.mesh)
            if self._sharded_key != key:
                from .parallel.sharded import make_render_fn

                self._sharded_step = make_render_fn(
                    self.scene, self.camera, self.settings, self.film_cfg,
                    self.mesh)
                self._sharded_key = key
            self.film, image = self._sharded_step(
                self.scene, self.camera, self.film, dirty, tracer=self.tracer,
                cam_params=self._cam_params)
        else:
            self.film, image = render_frame(
                self.scene, self.camera, self.settings, self.film_cfg,
                self.film, dirty, tracer=self.tracer,
                cam_params=self._cam_params)
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

    def reload(self) -> list[str]:
        """Re-import the package's changed modules and drop the kernel
        libraries (``SourceWatcher``); returns the reloaded modules.  The
        sharded frame step closes over module functions, so a reload drops
        it."""
        dirty = self._watcher.reload_if_changed()
        if dirty:
            self._sharded_step = self._sharded_key = None
        return dirty

    def host_bvh(self) -> BvhHost:
        """A BVH of the scene's triangles built on the host (the BVH debug
        view's boxes)."""
        if self._host_bvh is None:
            if self.scene.num_triangles == 0:
                raise ValueError("scene has no triangles to build a BVH over")
            v0, v1, v2 = (t.detach().cpu().numpy() for t in
                          (self.scene.tri_v0, self.scene.tri_v1, self.scene.tri_v2))
            self._host_bvh = build_bvh(*triangle_bounds(v0, v1, v2))
        return self._host_bvh

    def debug_view(self, kind: str = "triangles", **kw) -> np.ndarray:
        """'triangles' wireframe or 'bvh' boxes-by-depth overlay on the last
        frame -> f32[H, W, 3] (the reference's debug raster and BVH views)."""
        from .utils import debug_draw

        img = self.image
        base = img.numpy() if img is not None else np.zeros(
            (self.film_cfg.height, self.film_cfg.width, 3), np.float32)
        if kind == "triangles":
            return debug_draw.overlay_triangles(base, self.scene, self.camera, **kw)
        if kind == "bvh":
            return debug_draw.overlay_bvh(base, self.host_bvh(), self.camera, **kw)
        raise ValueError(f"unknown debug view {kind!r}")

    def save_image(self, path: str) -> None:
        if self._image_dev is None:
            self.draw()
        write_png(path, to_srgb_u8(self.image).numpy())

    def save_checkpoint(self, path: str) -> None:
        """The film, camera and scene, and the settings as meta, in the JAX
        package's checkpoint format (``utils.checkpoint``)."""
        ckpt.save(path, {"film": self.film, "camera": self.camera,
                         "scene": self.scene},
                  meta={"settings": self.settings.to_json()})

    def load_checkpoint(self, path: str) -> None:
        """Resume a checkpoint of this renderer's tree shape; accumulation
        continues from its film."""
        tree, meta = ckpt.load(path, {"film": self.film, "camera": self.camera,
                                      "scene": self.scene})
        self.film = tree["film"]
        self.camera = tree["camera"]
        self.scene = tree["scene"]
        self.tracer = make_tracer(self.scene)
        self._host_bvh = None
        if meta.get("settings"):
            self.settings = RenderSettings.from_json(meta["settings"])
        # Resuming continues accumulation: mark the state clean.
        self._prev_state = _camera_fingerprint(self.camera) + (self.settings,)
