"""Core vector math on ``f32[..., 3]`` tensors (mirror of
``rvpt_tpu/core/math.py``)."""

from __future__ import annotations

import torch

EPS = 1e-8
PI = 3.141592653589793
TWO_PI = 6.283185307179586
INV_PI = 0.3183098861837907


def vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the trailing xyz axis."""
    return torch.sum(a * b, dim=-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched cross product over the trailing xyz axis."""
    return torch.linalg.cross(a, b, dim=-1)


def length(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(vdot(v, v))


def normalize(v: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Normalize trailing-axis vectors; ``eps`` guards zero vectors."""
    n2 = vdot(v, v)
    inv = torch.where(
        n2 > eps, 1.0 / torch.sqrt(torch.clamp(n2, min=EPS * EPS)),
        torch.zeros_like(n2),
    )
    return v * inv[..., None]


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection of incident ``d`` about unit normal ``n``, with
    dot(d, n) <= 0 for an incoming ray (material.glsl:26-45)."""
    return d - 2.0 * vdot(d, n)[..., None] * n


def refract(d: torch.Tensor, n: torch.Tensor, eta) -> torch.Tensor:
    """Snell refraction, the zero vector on total internal reflection
    (GLSL ``refract``, material.glsl:49-74): ``eta`` is the outside/inside
    index ratio and dot(d, n) <= 0."""
    eta = torch.as_tensor(eta, dtype=d.dtype, device=d.device)
    cos_a = vdot(d, n)
    cos_b_sqr = 1.0 - eta * eta * (1.0 - cos_a * cos_a)
    tir = cos_b_sqr <= 0.0
    cos_b = torch.sqrt(torch.clamp(cos_b_sqr, min=1e-12))
    out = eta[..., None] * d - (eta * cos_a + cos_b)[..., None] * n
    return torch.where(tir[..., None], torch.zeros_like(out), out)


def spherical_to_cartesian(r, phi, theta):
    """x = r cos(phi) sin(theta), y = r sin(phi) sin(theta), z = r
    cos(theta) (util.glsl:54-73)."""
    sin_theta = torch.sin(theta)
    return torch.stack(
        [r * sin_theta * torch.cos(phi), r * sin_theta * torch.sin(phi),
         r * torch.cos(theta)],
        dim=-1,
    )


def unit_spherical_to_cartesian(phi, theta):
    """Unit-sphere point, physics convention (util.glsl:77-96)."""
    sin_theta = torch.sin(theta)
    return torch.stack(
        [sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), torch.cos(theta)],
        dim=-1,
    )


def orthonormal_basis(n: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Branchless orthonormal basis {e0, e1, n} around unit ``n`` (Duff et
    al., JCGT 2017; util.glsl:100-123)."""
    z = n[..., 2]
    sign = torch.where(z < 0.0, -1.0, 1.0)
    a = -1.0 / (sign + z)
    b = n[..., 0] * n[..., 1] * a
    e0 = torch.stack([1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b,
                      -sign * n[..., 0]], dim=-1)
    e1 = torch.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return e0, e1


def hemisphere_around_normal(phi, cos_theta, sin_theta, n):
    """Spherical angles mapped onto the hemisphere around ``n``
    (util.glsl:127-155)."""
    x = torch.cos(phi) * sin_theta
    y = torch.sin(phi) * sin_theta
    e0, e1 = orthonormal_basis(n)
    return x[..., None] * e0 + y[..., None] * e1 + cos_theta[..., None] * n


def mix(a, b, t):
    """GLSL mix: linear blend (extrapolates outside [0,1])."""
    return a + (b - a) * t
