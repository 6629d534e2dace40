"""Camera model and the three ray generators (mirror of
``rvpt_tpu/models/camera.py``).

The camera holds tensors (translation, rotation in degrees, fov, ortho
scale) on one device plus the plain ``aspect`` and ``mode``.  Matrix
convention (glm, src/rvpt/camera.cpp:17-25):
``M = T(translation) @ R_y(rot.x) @ R_x(rot.y) @ R_z(rot.z)``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..core.device import resolve_device
from ..core.math import PI, TWO_PI, normalize, unit_spherical_to_cartesian
from ..core.types import Ray
from ..utils.checkpoint import STATIC

PINHOLE = 0
ORTHO = 1
SPHERICAL = 2

CAMERA_MODE_NAMES = {"pinhole": PINHOLE, "ortho": ORTHO, "spherical": SPHERICAL}


@dataclass(frozen=True)
class Camera:
    translation: torch.Tensor  # f32[3]
    rotation: torch.Tensor  # f32[3], degrees (yaw about Y, pitch about X, roll about Z)
    fov: torch.Tensor  # f32 scalar, horizontal fov in degrees
    scale: torch.Tensor  # f32 scalar, ortho half-extent scale
    aspect: float = dataclasses.field(default=2.0, metadata=STATIC)
    mode: int = dataclasses.field(default=PINHOLE, metadata=STATIC)

    @staticmethod
    def create(
        translation=(0.0, 0.0, 0.0),
        rotation=(0.0, 0.0, 0.0),
        fov: float = 90.0,
        scale: float = 5.0,
        aspect: float = 2.0,
        mode: int = PINHOLE,
        device=None,
    ) -> "Camera":
        f32 = dict(dtype=torch.float32, device=resolve_device(device))
        return Camera(
            translation=torch.tensor(translation, **f32),
            rotation=torch.tensor(rotation, **f32),
            fov=torch.tensor(fov, **f32),
            scale=torch.tensor(scale, **f32),
            aspect=float(aspect),
            mode=int(mode),
        )

    @property
    def device(self) -> torch.device:
        return self.translation.device


def _axis_rotation(axis: int, radians: torch.Tensor) -> torch.Tensor:
    """3x3 right-handed rotation about a coordinate axis."""
    c, s = torch.cos(radians), torch.sin(radians)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    if axis == 0:  # X
        rows = [(one, zero, zero), (zero, c, -s), (zero, s, c)]
    elif axis == 1:  # Y
        rows = [(c, zero, s), (zero, one, zero), (-s, zero, c)]
    else:  # Z
        rows = [(c, -s, zero), (s, c, zero), (zero, zero, one)]
    return torch.stack([torch.stack(r) for r in rows])


def camera_matrix(cam: Camera) -> torch.Tensor:
    """4x4 camera-to-world matrix (src/rvpt/camera.cpp:17-25 semantics)."""
    rot = cam.rotation * (PI / 180.0)
    r = (_axis_rotation(1, rot[0]) @ _axis_rotation(0, rot[1])
         @ _axis_rotation(2, rot[2]))
    m = torch.eye(4, dtype=torch.float32, device=cam.device)
    m[:3, :3] = r
    m[:3, 3] = cam.translation
    return m


def generate_rays(cam: Camera, x: torch.Tensor, y: torch.Tensor) -> Ray:
    """Rays through film coordinates ``(x, y)`` in [0,1]^2, any batch shape
    (compute_pass.comp:102-118 dispatch over the camera mode)."""
    m = camera_matrix(cam)
    if cam.mode == PINHOLE:
        return _pinhole(cam, m, x, y)
    if cam.mode == ORTHO:
        return _ortho(cam, m, x, y)
    return _spherical(cam, m, x, y)


def pinhole_w(cam: Camera) -> torch.Tensor:
    """The pinhole's image-plane distance 1/tan(hfov/2), a 0-d tensor."""
    hfov = cam.fov * (PI / 180.0)
    return 1.0 / torch.tan(0.5 * hfov)


def _pinhole(cam: Camera, m: torch.Tensor, x, y) -> Ray:
    """Pinhole rays (camera.glsl:29-51)."""
    u = cam.aspect * (2.0 * x - 1.0)
    v = 2.0 * y - 1.0
    w = pinhole_w(cam)
    local = torch.stack([u, v, w.expand(u.shape)], dim=-1)
    direction = local @ m[:3, :3].T
    origin = m[:3, 3].expand(direction.shape)
    return Ray(origin=origin, direction=normalize(direction))


def _ortho(cam: Camera, m: torch.Tensor, x, y) -> Ray:
    """Orthographic rays (camera.glsl:55-76)."""
    u = cam.aspect * (2.0 * x - 1.0)
    v = 2.0 * y - 1.0
    local = torch.stack([cam.scale * u, cam.scale * v, torch.zeros_like(u)], dim=-1)
    origin = local @ m[:3, :3].T + m[:3, 3]
    direction = m[:3, 2].expand(origin.shape)
    return Ray(origin=origin, direction=direction)


def _spherical(cam: Camera, m: torch.Tensor, x, y) -> Ray:
    """Spherical rays (camera.glsl:80-99), with the reference's ``.xzy``
    swizzle so theta sweeps the vertical axis."""
    phi = x * TWO_PI
    theta = y * PI
    p = unit_spherical_to_cartesian(phi, theta)
    local = torch.stack([p[..., 0], p[..., 2], p[..., 1]], dim=-1)
    direction = local @ m[:3, :3].T
    origin = m[:3, 3].expand(direction.shape)
    return Ray(origin=origin, direction=direction)


def translate(cam: Camera, delta) -> Camera:
    """Camera-local translation (src/rvpt/camera.cpp:29-33): the delta is
    rotated into world space by the camera matrix before it is added, so
    +z moves forward, +x strafes right and +y rises."""
    m = camera_matrix(cam)
    world = m[:3, :3] @ torch.as_tensor(delta, dtype=torch.float32, device=cam.device)
    return dataclasses.replace(cam, translation=cam.translation + world)


def rotate(cam: Camera, delta, clamp_vertical: bool = False) -> Camera:
    """Additive rotation in degrees (src/rvpt/camera.cpp:35-39);
    ``clamp_vertical`` clamps the pitch to [-90, 90] as the reference's
    ``vertical_view_angle_clamp`` (off by default, camera.h:46)."""
    rot = cam.rotation + torch.as_tensor(delta, dtype=torch.float32, device=cam.device)
    if clamp_vertical:
        rot = torch.cat([rot[:1], torch.clamp(rot[1:2], -90.0, 90.0), rot[2:]])
    return dataclasses.replace(cam, rotation=rot)
