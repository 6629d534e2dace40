"""Frame rendering (mirror of ``rvpt_tpu/render.py``).

Pixel grid, per-sample jitter, camera rays, integrator evaluation with the
reference's up-to-4-way split-screen comparison, AA averaging and the
temporal EMA.  Two routes render a sample:

* ``render_sample_chw``: the plain integrator path (ops.intersect +
  models.integrators), the port of the JAX package's XLA path;
* ``render_sample_fast_chw``: the kernels of ``ops.pathkernel`` (the
  whole-path tracer for Kajiya/Whitted/Cook, the primary-hit kernel for
  modes 0-6, the Hart march for mode 10, each in its row form or, on a
  BVH scene, its BVH form; on a big mesh, ``BigMeshTracer``: the BVH
  forms on rays made here, and B6's march), CUDA for a scene on the card
  and their plain versions on the CPU; a split-screen frame runs each
  quadrant's kernel on exactly that quadrant's pixels.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .config import FilmConfig, RenderSettings
from .core.device import resolve_device
from .models.integrators import AA_STRIDE, INTEGRATORS, eval_integrator
from .ops import film as film_ops
from .ops.camera_rays import camera_rays
from .utils.profiling import annotate

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


def _mode_masks(settings: RenderSettings, xs, ys, cfg: FilmConfig):
    """Split-screen quadrant selection (compute_pass.comp:134-144): the
    integrator id of each pixel."""
    sx, sy = settings.split_ratio
    px = xs.to(torch.float32) / cfg.width
    py = ys.to(torch.float32) / cfg.height
    bottom = py > sy
    right_t = px > sx
    right_b = ~(px < sx)
    tl, tr, bl, br = settings.modes()
    return torch.where(bottom, torch.where(right_b, br, bl),
                       torch.where(right_t, tr, tl))


def jittered_camera_rays(camera, cfg: FilmConfig, pixel, xs, ys, frame, salt0,
                         divide: bool = False, planes: bool = False):
    """AA-jittered camera rays for a pixel batch: RNG site, y flip and
    reciprocal film scale of the JAX path (``divide``: divided by the film
    size, the trainer's rounding).  ``pixel`` is an int64[N] tensor of
    pixel ids or an int N (the raster ids), ``xs``/``ys`` their integer
    coordinates or None.  On the card one launch of the camera-ray kernel,
    bit for bit the plain arithmetic; ``planes`` asks for the kernel's
    buffer views, for a caller that hands the rays to a kernel
    (``ops.camera_rays.camera_rays``)."""
    with annotate("rays"):
        return camera_rays(camera, cfg, pixel, xs, ys, frame,
                           salt0 + _JITTER_SITE, divide, planes)


def render_pixels(scene, camera, settings: RenderSettings, cfg: FilmConfig,
                  frame, pixel, xs, ys, aa_offset=0):
    """Render a batch of pixels -> f32[n,3] samples (plain path).  RNG
    streams depend only on the global pixel id; ``aa_offset`` offsets the
    AA sample index.  Split-screen evaluates every quadrant's integrator
    on the batch and selects per pixel, as the JAX path does."""
    unique_modes = sorted(set(settings.modes()))
    n = pixel.shape[0]
    sampled = torch.zeros((n, 3), dtype=torch.float32, device=pixel.device)
    for i in range(settings.aa):
        salt0 = ((i + int(aa_offset)) * AA_STRIDE) & 0xFFFFFFFF
        ray = jittered_camera_rays(camera, cfg, pixel, xs, ys, frame, salt0)
        salt_base = salt0 + _INTEGRATOR_SITE
        if len(unique_modes) == 1:
            col = eval_integrator(unique_modes[0], scene, ray, pixel, frame,
                                  settings, salt_base)
        else:
            mode_of_pixel = _mode_masks(settings, xs, ys, cfg)
            col = torch.zeros((n, 3), dtype=torch.float32, device=pixel.device)
            for m in unique_modes:
                cm = eval_integrator(m, scene, ray, pixel, frame, settings,
                                     salt_base)
                col = torch.where((mode_of_pixel == m)[:, None], cm, col)
        sampled = sampled + col
    return sampled / settings.aa


def render_sample_chw(scene, camera, settings: RenderSettings, cfg: FilmConfig,
                      frame):
    """One frame's sample image f32[3,H,W] through the plain path.
    ``frame`` seeds the stateless RNG (util.glsl:35-36)."""
    pixel, xs, ys = _pixel_grid(cfg, scene.device)
    sampled = render_pixels(scene, camera, settings, cfg, frame, pixel, xs, ys)
    return sampled.T.reshape(3, cfg.height, cfg.width)


def render_sample(scene, camera, settings: RenderSettings, cfg: FilmConfig,
                  frame):
    """One frame's sample image f32[H,W,3] (display layout) through the
    plain path."""
    return film_ops.chw_to_hwc(render_sample_chw(scene, camera, settings, cfg,
                                                 frame))


def _megakernel_eligible(scene, settings: RenderSettings) -> bool:
    """Whether the kernels serve this scene and settings
    (``render.py:119``, minus its platform sniffing): every quadrant's
    integrator is one of the eleven and, where a quadrant searches (every
    mode but Hart, whose kernels read triangles in chunks or by the tree),
    the tables the kernels stage fit their shared memory (a BVH scene
    stages no triangles: its walk reads them from device memory).  The
    backward kernel's 1,024-triangle limit is no limit of either: past it
    the trainer's paired trace takes the SoA replay
    (``ops.fast_grad.make_fast_kajiya``).  The tracer picks each kernel or
    its plain version by the device."""
    from .ops.pathkernel import stages_tables

    modes = set(settings.modes())
    if not modes <= set(INTEGRATORS):
        return False
    return modes == {10} or stages_tables(scene)


def _trace_mode_kernel(pt, camera, settings: RenderSettings, cam_params,
                       pixel, frame, salt0, mode):
    """One kernel pass of integrator ``mode`` over a pixel batch -> f32[3,
    n] (``render.py:226``): the Hart march for 10, the primary-hit kernel
    for 0-6, the whole-path tracer for 7-9.  Jitter and camera rays are
    made inside the kernels; the film is the pass's only ray-sized output.
    ``pixel`` is an int64[n] tensor or an int n (the raster ids)."""
    from .ops.pathkernel import PRIMARY_MODES

    kw = dict(cam_params=cam_params, cam_mode=camera.mode,
              jitter_salt=salt0 + _JITTER_SITE)
    if mode == 10:
        return pt.trace_hart(pixel, frame, **kw)
    if mode in PRIMARY_MODES:
        # nrays matters only to AO's probe loop.
        nrays = max(int(settings.max_bounces), 1) if mode == 5 else 1
        return pt.trace_primary(pixel, frame, mode,
                                salt_base=salt0 + _INTEGRATOR_SITE, nrays=nrays,
                                **kw)
    integ = {7: "whitted", 8: "cook"}.get(mode, "kajiya")
    return pt(pixel, None, None, frame, salt_base=salt0 + _INTEGRATOR_SITE,
              max_bounces=settings.max_bounces, style=settings.style,
              gen_rays=True, integ=integ, **kw)


def _trace_mode_bigmesh(bt, camera, settings: RenderSettings, cfg: FilmConfig,
                        pixel, frame, salt0, mode):
    """One big-mesh integrator pass over a pixel batch -> f32[3, n]
    (``render.py:382``): camera rays made here with the jitter salts of
    ``render_pixels``, then ``BigMeshTracer.trace_mode``: the Hart march
    (10), or one launch of B3's (0-6) or K1's (7-9) BVH form on those
    rays.  ``pixel`` is an int64[n] tensor or an int n (the raster ids)."""
    ray = jittered_camera_rays(camera, cfg, pixel, None, None, frame, salt0,
                               planes=True)
    # nrays matters only to AO's probe loop.
    nrays = max(int(settings.max_bounces), 1) if mode == 5 else 1
    return bt.trace_mode(pixel, ray.origin, ray.direction, frame, mode,
                         salt_base=salt0 + _INTEGRATOR_SITE,
                         max_bounces=settings.max_bounces, style=settings.style,
                         nrays=nrays)


@lru_cache(maxsize=8)
def _split_partition(cfg: FilmConfig, settings: RenderSettings):
    """The split-screen partition as quadrant rectangles (mode, (y0, y1,
    x0, x1)) that reproduce ``_mode_masks`` exactly; empty quadrants are
    dropped (``render.py:267``)."""
    sx, sy = settings.split_ratio
    py = np.arange(cfg.height, dtype=np.float32) / cfg.height
    px = np.arange(cfg.width, dtype=np.float32) / cfg.width
    rows_b = np.nonzero(py > sy)[0]
    y_split = int(rows_b[0]) if len(rows_b) else cfg.height
    cols_t = np.nonzero(px > sx)[0]
    x_split_t = int(cols_t[0]) if len(cols_t) else cfg.width
    cols_b = np.nonzero(~(px < sx))[0]
    x_split_b = int(cols_b[0]) if len(cols_b) else cfg.width
    tl, tr, bl, br = settings.modes()
    rects = [
        (int(tl), 0, y_split, 0, x_split_t),
        (int(tr), 0, y_split, x_split_t, cfg.width),
        (int(bl), y_split, cfg.height, 0, x_split_b),
        (int(br), y_split, cfg.height, x_split_b, cfg.width),
    ]
    return tuple((m, (y0, y1, x0, x1)) for m, y0, y1, x0, x1 in rects
                 if y1 > y0 and x1 > x0)


def _rect_pixels(y0, y1, x0, x1, width, device):
    """Raster pixel ids int64[(y1-y0)*(x1-x0)] of a rectangle, row-major."""
    ys = torch.arange(y0, y1, dtype=torch.int64, device=device)
    xs = torch.arange(x0, x1, dtype=torch.int64, device=device)
    return (xs[None, :] + ys[:, None] * width).reshape(-1)


def make_tracer(scene):
    """The tracer of the kernels' route for ``scene``: ``BigMeshTracer`` for
    a big mesh (``pathkernel.is_bigmesh``, the JAX route rule), else
    ``PathTracer``.  Both run a big mesh through K1's and B3's BVH forms;
    ``BigMeshTracer`` takes the rays from the caller (made by
    ``jittered_camera_rays``, as the JAX big-mesh route makes them, which
    differ from the kernels' own camera rays in the last bit) and marches
    Hart frames with B6."""
    from .ops.pathkernel import BigMeshTracer, PathTracer, is_bigmesh

    return BigMeshTracer(scene) if is_bigmesh(scene) else PathTracer(scene)


def render_sample_fast_chw(scene, camera, settings: RenderSettings,
                           cfg: FilmConfig, frame, tracer=None, cam_params=None):
    """One frame's sample image f32[3,H,W] through the kernels
    (``_fast_chw_jit``, minus the TPU block layouts); settings or scenes
    outside their scope (``_megakernel_eligible``) take the plain path.
    ``tracer`` is the ``make_tracer`` tracer already built for ``scene``
    and ``cam_params`` the ``camera_params`` vector of ``camera`` and
    ``cfg`` (each built here when None; a big mesh needs no camera vector,
    its rays are made here).  A split-screen frame runs each quadrant's
    kernel on exactly its own pixels (the RNG keys by global pixel id, so
    values match the plain path's evaluate-and-select) and writes the
    quadrant into its rectangle of the film."""
    if not _megakernel_eligible(scene, settings):
        return render_sample_chw(scene, camera, settings, cfg, frame)
    pt, cam_params = _tracer_and_camera(scene, camera, cfg, tracer, cam_params)
    modes = set(settings.modes())
    if len(modes) == 1:
        (mode,) = modes
        return _sample_mode(pt, camera, settings, cfg, cam_params,
                            cfg.num_pixels, frame, mode).reshape(
                                3, cfg.height, cfg.width)
    out = torch.empty((3, cfg.height, cfg.width), dtype=torch.float32,
                      device=scene.device)
    for m, (y0, y1, x0, x1) in _split_partition(cfg, settings):
        sub = _rect_pixels(y0, y1, x0, x1, cfg.width, scene.device)
        out[:, y0:y1, x0:x1] = _sample_mode(
            pt, camera, settings, cfg, cam_params, sub, frame, m).reshape(
                3, y1 - y0, x1 - x0)
    return out


def _is_big(pt) -> bool:
    from .ops.pathkernel import BigMeshTracer

    return isinstance(pt, BigMeshTracer)


def _tracer_and_camera(scene, camera, cfg: FilmConfig, tracer, cam_params):
    """``tracer`` (or ``make_tracer(scene)``) and the camera vector of
    ``camera`` and ``cfg`` (None for a big mesh, whose rays
    ``jittered_camera_rays`` makes), each built here when the caller has
    none."""
    from .ops.pathkernel import camera_params

    pt = tracer if tracer is not None else make_tracer(scene)
    if cam_params is None and not _is_big(pt):
        cam_params = camera_params(camera, cfg)
    return pt, cam_params


def _sample_mode(pt, camera, settings: RenderSettings, cfg: FilmConfig,
                 cam_params, pixel, frame, mode, aa_offset: int = 0):
    """The AA-averaged kernel pass of integrator ``mode`` over a pixel
    batch -> f32[3, n]; ``aa_offset`` offsets the AA sample index (a spp
    rank's salts, as ``render_pixels``)."""
    big = _is_big(pt)
    acc = None
    for i in range(settings.aa):
        salt0 = ((i + int(aa_offset)) * AA_STRIDE) & 0xFFFFFFFF
        if big:
            out = _trace_mode_bigmesh(pt, camera, settings, cfg, pixel, frame,
                                      salt0, mode)
        else:
            out = _trace_mode_kernel(pt, camera, settings, cam_params, pixel,
                                     frame, salt0, mode)
        acc = out if acc is None else acc + out
    if settings.aa > 1:
        acc = acc * (1.0 / settings.aa)
    return acc


def render_frame(scene, camera, settings: RenderSettings, cfg: FilmConfig,
                 film: film_ops.Film, dirty: bool, fast: bool = True,
                 tracer=None, cam_params=None):
    """Sample + temporal EMA; returns (new_film, image f32[3,H,W]).

    ``fast=True`` (display) takes the kernels, ``fast=False`` the plain
    integrator path."""
    frame = 0 if dirty else int(film.frame)
    with annotate("frame.sample"):
        if fast:
            sample = render_sample_fast_chw(scene, camera, settings, cfg, frame,
                                            tracer=tracer, cam_params=cam_params)
        else:
            sample = render_sample_chw(scene, camera, settings, cfg, frame)
    with annotate("frame.ema"):
        new_film = film_ops.accumulate(film, sample, dirty)
    return new_film, new_film.accum
