"""Sample mappings (mirror of ``rvpt_tpu/core/sampling.py``).  Only the
mapping the Lambert BRDF needs is ported so far."""

from __future__ import annotations

import torch

from .math import TWO_PI


def map_uniform_sphere(u, v):
    """[0,1)^2 -> uniform density on the unit sphere
    (samples_mapping.glsl:39-60)."""
    phi = TWO_PI * u
    cos_theta = 1.0 - 2.0 * v
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=1e-12))
    return torch.stack(
        [sin_theta * torch.cos(phi), sin_theta * torch.sin(phi), cos_theta], dim=-1
    )


def map_cosine_hemisphere_simple(u, v, n):
    """Cosine-weighted hemisphere by offsetting a sphere sample with the
    normal; NOT normalized, like the reference (samples_mapping.glsl:112-131)."""
    return n + map_uniform_sphere(u, v)
