"""Sample mappings from [0,1)^k to spheres, hemispheres and the ball
(mirror of ``rvpt_tpu/core/sampling.py``; samples_mapping.glsl:39-187),
over any leading batch shape."""

from __future__ import annotations

import torch

from .math import TWO_PI, hemisphere_around_normal, vdot


def map_uniform_sphere(u, v):
    """[0,1)^2 -> uniform density on the unit sphere
    (samples_mapping.glsl:39-60)."""
    phi = TWO_PI * u
    cos_theta = 1.0 - 2.0 * v
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=1e-12))
    return torch.stack(
        [sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta], dim=-1
    )


def map_uniform_hemisphere_simple(u, v, n):
    """Uniform hemisphere around ``n`` by flipping a sphere sample
    (samples_mapping.glsl:64-80)."""
    p = map_uniform_sphere(u, v)
    return torch.where((vdot(n, p) < 0.0)[..., None], -p, p)


def map_uniform_hemisphere(u, v, n):
    """Uniform hemisphere around ``n`` in an orthonormal basis
    (samples_mapping.glsl:84-108)."""
    phi = TWO_PI * u
    cos_theta = v
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=1e-12))
    return hemisphere_around_normal(phi, cos_theta, sin_theta, n)


def map_cosine_hemisphere_simple(u, v, n):
    """Cosine-weighted hemisphere by offsetting a sphere sample with the
    normal; NOT normalized, like the reference (samples_mapping.glsl:112-131)."""
    return n + map_uniform_sphere(u, v)


def map_cosine_hemisphere(u, v, n):
    """Cosine-weighted hemisphere by inverse-transform sampling in an
    orthonormal basis (samples_mapping.glsl:135-159)."""
    phi = TWO_PI * u
    cos_theta = torch.sqrt(torch.clamp(1.0 - v, min=1e-12))
    sin_theta = torch.sqrt(torch.clamp(v, min=1e-12))
    return hemisphere_around_normal(phi, cos_theta, sin_theta, n)


def map_uniform_ball(u, v, w):
    """[0,1)^3 -> uniform density inside the unit ball
    (samples_mapping.glsl:163-187)."""
    phi = TWO_PI * u
    cos_theta = 1.0 - 2.0 * v
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=1e-12))
    r = torch.pow(w, 1.0 / 3.0)
    return r[..., None] * torch.stack(
        [sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta], dim=-1
    )
