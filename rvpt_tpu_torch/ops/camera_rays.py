"""AA-jittered camera rays of a pixel batch: one kernel launch on the card,
the plain PyTorch arithmetic elsewhere.

The JAX package makes these rays with jnp (``rvpt_tpu/render.py``
jittered_camera_rays); no Pallas kernel exists for them.  Here two
versions compute the same bits:

* ``camera_rays_plain``: PCG3D jitter (``core.rng``), the film coordinates
  with the y flip, ``models.camera.generate_rays``: about 109 eager ops;
* ``launch_camera_rays``: ``csrc/camera_rays.cu``, one thread per ray,
  the six ray components written as one f32[6, N] buffer.

``camera_rays`` picks: a camera whose tensors lie on the card takes the
kernel (its matrix and pinhole distance computed by PyTorch on the card
once per camera, ``camera_constants``), a CPU camera or a camera with a
tensor that requires grad the plain arithmetic, the one route gradients
reach the camera through.  Its rays are laid out by rows, bar the
kernel's buffer views that a caller handing them to a kernel asks for
(``planes``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import rng
from ..core.types import Ray
from ..models import camera as camera_mod
from .build import check_cuda, check_launch, load_library
from .pathkernel import _on_device, _pixels, _raster

_MASK = 0xFFFFFFFF
# f32[CAM_LEN] of camera_constants: the rotation of camera_matrix(cam)
# row-major, its translation, the pinhole's w (0 otherwise), the ortho scale.
CAM_LEN = 14


def _camera_tensors(cam):
    return cam.translation, cam.rotation, cam.fov, cam.scale


@torch.no_grad()
def camera_constants(cam) -> torch.Tensor:
    """The f32[CAM_LEN] the kernel reads, on the camera's device: the very
    values ``generate_rays`` computes there.  Kept on the camera object
    (a frozen dataclass: a new camera starts without them) and rebuilt
    when one of its tensors changes in place (its ``_version``), so a
    steady camera costs no launch here."""
    versions = tuple(t._version for t in _camera_tensors(cam))
    kept = getattr(cam, "_ray_constants", None)
    if kept is not None and kept[0] == versions:
        return kept[1]
    m = camera_mod.camera_matrix(cam)
    w = (camera_mod.pinhole_w(cam) if cam.mode == camera_mod.PINHOLE
         else torch.zeros_like(cam.fov))
    consts = torch.cat([m[:3, :3].reshape(-1), m[:3, 3], w.reshape(1),
                        cam.scale.reshape(1)]).contiguous()
    object.__setattr__(cam, "_ray_constants", (versions, consts))
    return consts


def _film_scale(size: int, divide: bool) -> float:
    """The factor a film coordinate is scaled by, rounded as PyTorch rounds
    it on the card: ``1.0 / size`` in double, then to f32 (the display's
    reciprocal multiply), or ``1.0f / f32(size)`` (``t / size``, which
    PyTorch runs on the card as a multiply by that reciprocal)."""
    if divide:
        return float(np.float32(1.0) / np.float32(size))
    return float(np.float32(1.0 / size))


def camera_rays_plain(camera, cfg, pixel, xs, ys, frame, salt,
                      divide: bool = False) -> Ray:
    """The rays in plain PyTorch: ``pixel`` an int64[N] tensor of pixel ids
    or an int N (the raster ids 0..N-1); ``xs``/``ys`` their integer
    coordinates (derived from the ids when None).  ``divide`` divides by
    the film size where the default multiplies by its reciprocal."""
    n, pix = _pixels(pixel)
    pix = _raster(pix, n, camera.device)
    if xs is None:
        xs = pix % cfg.width
        ys = torch.div(pix, cfg.width, rounding_mode="floor")
    ju, jv = rng.uniform2(pix, frame, salt)
    # Jittered film coordinates, y flipped (compute_pass.comp:153-154).
    if divide:
        cx = (xs.to(torch.float32) + ju) / cfg.width
        cy = 1.0 - (ys.to(torch.float32) + jv) / cfg.height
    else:
        cx = (xs.to(torch.float32) + ju) * (1.0 / cfg.width)
        cy = 1.0 - (ys.to(torch.float32) + jv) * (1.0 / cfg.height)
    return camera_mod.generate_rays(camera, cx, cy)


def _lib():
    lib = load_library("camera_rays")
    if not hasattr(lib, "_rvpt_bound"):
        ptr, i32, u32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
        lib.rvpt_camera_rays.argtypes = [ptr, i32, i32, u32, u32, f32, f32, f32,
                                         i32, ptr, ptr, ptr]
        lib.rvpt_camera_rays.restype = i32
        lib._rvpt_bound = True
    return lib


def launch_camera_rays(consts, mode, aspect, pix, n, width, height, frame, salt,
                       divide: bool = False) -> torch.Tensor:
    """The rays of ``n`` pixels on the card -> f32[6, n] (origin x, y, z,
    direction x, y, z): ``pix`` an int64[n] tensor of pixel ids or None
    for the raster ids 0..n-1, ``consts`` from ``camera_constants``.
    Counts one launch in ``launch_camera_rays.launches``.  It opens no span
    of its own: its one caller runs inside ``rvpt.rays``, which then holds
    this launch and nothing else."""
    dev = consts.device
    check_cuda(consts, torch.float32, "camera constants", CAM_LEN)
    if pix is not None:
        check_cuda(pix, torch.int64, "pixel ids", n, dev)
    if width * height >= 2**31:
        raise ValueError(f"film of {width}x{height}: the kernel takes under 2^31 pixels")
    out = torch.empty((6, n), dtype=torch.float32, device=dev)
    lib = _lib()
    err = lib.rvpt_camera_rays(
        None if pix is None else pix.data_ptr(), n, width, int(frame) & _MASK,
        int(salt) & _MASK, _film_scale(width, divide), _film_scale(height, divide),
        float(aspect), int(mode), consts.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(lib, err, "camera-ray kernel")
    launch_camera_rays.launches += 1
    return out


launch_camera_rays.launches = 0


def camera_rays(camera, cfg, pixel, xs, ys, frame, salt, divide: bool = False,
                planes: bool = False) -> Ray:
    """The AA-jittered camera rays of a pixel batch (``camera_rays_plain``'s
    arguments): on the card one launch of the kernel, on the CPU, or when a
    camera tensor requires grad, the plain arithmetic.

    The rays are f32[N, 3] tensors laid out by rows on every device: the
    kernel's copied row-major, the plain arithmetic's as it makes them
    (row-major, or one vector broadcast: the pinhole's and the spherical
    camera's origin, the ortho camera's direction).  With
    ``planes`` the card's rays are instead f32[N, 3] views of the kernel's
    f32[6, N] buffer, so that each one's ``.T`` is contiguous and a tracer's
    rays-in form copies nothing.  That layout is for a caller that hands the
    rays straight to a kernel: on the card PyTorch's reductions over the
    last axis of such a view round in another order, so the views carry
    the same bits but do not sum to the same bits."""
    def kernel():
        n, pix = _pixels(pixel)
        buf = launch_camera_rays(camera_constants(camera), camera.mode,
                                 camera.aspect, pix, n, cfg.width, cfg.height,
                                 frame, salt, divide)
        origin, direction = buf[:3].T, buf[3:].T
        if not planes:
            origin, direction = origin.contiguous(), direction.contiguous()
        return Ray(origin=origin, direction=direction)

    def plain():
        return camera_rays_plain(camera, cfg, pixel, xs, ys, frame, salt, divide)

    if any(t.requires_grad for t in _camera_tensors(camera)):
        return plain()
    return _on_device(camera.device, kernel, plain)
