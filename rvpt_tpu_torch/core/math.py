"""Core vector math on ``f32[..., 3]`` tensors (mirror of
``rvpt_tpu/core/math.py``, the subset the integrators use)."""

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


def unit_spherical_to_cartesian(phi, theta):
    """Unit-sphere point, physics convention (util.glsl:77-96)."""
    sin_theta = torch.sin(theta)
    return torch.stack(
        [sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), torch.cos(theta)],
        dim=-1,
    )


def mix(a, b, t):
    """GLSL mix: linear blend (extrapolates outside [0,1])."""
    return a + (b - a) * t
