"""Frame rendering (mirror of ``rvpt_tpu/render.py``, its single-mode half).

Pixel grid, per-sample jitter, camera rays, the Kajiya integrator, AA
averaging and the temporal EMA.  Two routes render a sample:

* ``render_sample_chw``: the plain integrator path (ops.intersect +
  models.integrators), the port of the JAX package's XLA path;
* ``render_sample_fast_chw``: the whole-path tracer (ops.pathkernel), the
  CUDA kernel for a scene on the card and its plain version on the CPU.

Split-screen (several integrator modes at once) and the other integrators
wait for later slices and raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from .config import FilmConfig, RenderSettings
from .core import rng
from .core.device import resolve_device
from .models import camera as camera_mod
from .models.integrators import AA_STRIDE, KAJIYA, eval_integrator
from .ops import film as film_ops

_JITTER_SITE = 0
_INTEGRATOR_SITE = 16


def _pixel_grid(cfg: FilmConfig, device=None):
    """Flat pixel ids and integer coords; id = x + y*W matches the
    reference's seeding index (util.glsl:35), so RNG streams do not depend
    on how the film is cut up.  ``device`` None is the card."""
    device = resolve_device(device)
    ys, xs = torch.meshgrid(
        torch.arange(cfg.height, dtype=torch.int64, device=device),
        torch.arange(cfg.width, dtype=torch.int64, device=device),
        indexing="ij",
    )
    xs = xs.reshape(-1)
    ys = ys.reshape(-1)
    return xs + ys * cfg.width, xs, ys


def _single_mode(settings: RenderSettings) -> int:
    modes = set(settings.modes())
    if len(modes) != 1:
        raise NotImplementedError("split-screen rendering is not ported yet")
    (mode,) = modes
    if mode != KAJIYA:
        raise NotImplementedError(
            f"integrator {mode} is not ported yet; the port serves Kajiya (9)")
    return mode


def jittered_camera_rays(camera, cfg: FilmConfig, pixel, xs, ys, frame, salt0):
    """AA-jittered camera rays for a pixel batch: RNG site, y flip and
    reciprocal film scale of the JAX path."""
    ju, jv = rng.uniform2(pixel, frame, salt0 + _JITTER_SITE)
    # Jittered film coordinates, y flipped (compute_pass.comp:153-154).
    cx = (xs.to(torch.float32) + ju) * (1.0 / cfg.width)
    cy = 1.0 - (ys.to(torch.float32) + jv) * (1.0 / cfg.height)
    return camera_mod.generate_rays(camera, cx, cy)


def render_pixels(scene, camera, settings: RenderSettings, cfg: FilmConfig,
                  frame, pixel, xs, ys, aa_offset=0):
    """Render a batch of pixels -> f32[n,3] samples (plain path).  RNG
    streams depend only on the global pixel id; ``aa_offset`` offsets the
    AA sample index."""
    mode = _single_mode(settings)
    sampled = torch.zeros((pixel.shape[0], 3), dtype=torch.float32,
                          device=pixel.device)
    for i in range(settings.aa):
        salt0 = ((i + int(aa_offset)) * AA_STRIDE) & 0xFFFFFFFF
        ray = jittered_camera_rays(camera, cfg, pixel, xs, ys, frame, salt0)
        sampled = sampled + eval_integrator(
            mode, scene, ray, pixel, frame, settings, salt0 + _INTEGRATOR_SITE)
    return sampled / settings.aa


def render_sample_chw(scene, camera, settings: RenderSettings, cfg: FilmConfig,
                      frame):
    """One frame's sample image f32[3,H,W] through the plain path.
    ``frame`` seeds the stateless RNG (util.glsl:35-36)."""
    pixel, xs, ys = _pixel_grid(cfg, scene.device)
    sampled = render_pixels(scene, camera, settings, cfg, frame, pixel, xs, ys)
    return sampled.T.reshape(3, cfg.height, cfg.width)


def render_sample_fast_chw(scene, camera, settings: RenderSettings,
                           cfg: FilmConfig, frame, tracer=None, cam_params=None):
    """One frame's sample image f32[3,H,W] through the whole-path tracer:
    camera rays are made inside the trace and the film is its only
    ray-sized output.  ``tracer`` is a ``PathTracer`` already built for
    ``scene`` and ``cam_params`` the ``camera_params`` vector of
    ``camera`` and ``cfg`` (each built here when None)."""
    from .ops.pathkernel import PathTracer, camera_params

    _single_mode(settings)
    pt = tracer if tracer is not None else PathTracer(scene)
    if cam_params is None:
        cam_params = camera_params(camera, cfg)
    n = cfg.num_pixels
    acc = None
    for i in range(settings.aa):
        salt0 = i * AA_STRIDE
        out = pt(n, None, None, frame, salt_base=salt0 + _INTEGRATOR_SITE,
                 max_bounces=settings.max_bounces, style=settings.style,
                 gen_rays=True, cam_params=cam_params, cam_mode=camera.mode,
                 jitter_salt=salt0 + _JITTER_SITE)
        acc = out if acc is None else acc + out
    if settings.aa > 1:
        acc = acc * (1.0 / settings.aa)
    return acc.reshape(3, cfg.height, cfg.width)


def _megakernel_eligible(scene, settings: RenderSettings) -> bool:
    """Whether the whole-path tracer and its pullback serve this scene and
    settings (``render.py:119``): pure Kajiya on every quadrant and a
    scene without a BVH of at most 1,024 triangles.  No platform check:
    the tracer picks the kernel or its plain version by the device."""
    from .ops.pathkernel import MAX_BWD_TRIANGLES

    if set(settings.modes()) != {KAJIYA}:
        return False
    return scene.bvh is None and scene.num_triangles <= MAX_BWD_TRIANGLES


def render_frame(scene, camera, settings: RenderSettings, cfg: FilmConfig,
                 film: film_ops.Film, dirty: bool, fast: bool = True,
                 tracer=None, cam_params=None):
    """Sample + temporal EMA; returns (new_film, image f32[3,H,W]).

    ``fast=True`` (display) takes the whole-path tracer, ``fast=False`` the
    plain integrator path."""
    frame = 0 if dirty else int(film.frame)
    if fast:
        sample = render_sample_fast_chw(scene, camera, settings, cfg, frame,
                                        tracer=tracer, cam_params=cam_params)
    else:
        sample = render_sample_chw(scene, camera, settings, cfg, frame)
    new_film = film_ops.accumulate(film, sample, dirty)
    return new_film, new_film.accum
