"""Integrators over ray batches (mirror of ``rvpt_tpu/models/integrators.py``).

The Kajiya path tracer (integrators.glsl:547-677) is ported; the other ten
integrators wait for later slices.  Per-ray early returns become
termination masks and the bounce loop a Python loop over [N] tensors.
A path contributes only when it ends inside the bounce budget (the
reference returns black when the loop runs out, integrators.glsl:675);
``style='standard'`` also keeps the emission gathered by unfinished paths.
"""

from __future__ import annotations

import torch

from ..core import rng
from ..core.math import mix, normalize
from ..core.types import Ray
from ..ops.intersect import intersect_scene
from ..scene.materials import gather
from . import brdf

WHITE = (1.0, 1.0, 1.0)
BLUE = (0.2, 0.3, 0.7)
INF = float("inf")

# RNG salt layout: salt = aa_index * AA_STRIDE + bounce * BOUNCE_STRIDE + site.
BOUNCE_STRIDE = 4
AA_STRIDE = 4096

KAJIYA = 9


def _sky(direction, half_shift: bool):
    """Background gradient.  Kajiya shifts d.y into [0,1]
    (integrators.glsl:579); the other integrators use raw d.y."""
    y = direction[..., 1]
    t = y * 0.5 + 0.5 if half_shift else y
    white = torch.tensor(WHITE, dtype=torch.float32, device=direction.device)
    blue = torch.tensor(BLUE, dtype=torch.float32, device=direction.device)
    return mix(white[None, :], blue[None, :], t[..., None])


def _bounce_rands(pixel, frame, salt_base, bounce):
    salt = salt_base + bounce * BOUNCE_STRIDE
    return rng.uniform3(pixel, frame, salt)


def integrator_kajiya(scene, ray, pixel, frame, settings, salt_base=0):
    """Standard path tracing (integrators.glsl:547-677) -> f32[N,3]."""
    n = ray.origin.shape[0]
    dev = ray.origin.device
    o, d = ray.origin, ray.direction
    col = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    thr = torch.ones((n, 3), dtype=torch.float32, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    result = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    zero3 = torch.zeros_like(col)
    for bounce in range(int(settings.max_bounces)):
        isect = intersect_scene(scene, Ray(o, d), 0.0, INF)
        hit = isect.hit
        miss_now = active & ~hit
        sky = _sky(d, half_shift=True)
        result = result + torch.where(miss_now[:, None], col + thr * sky, zero3)
        active = active & hit

        mat = gather(scene.materials, isect.mat)
        col = col + torch.where(active[:, None], thr * mat.emission, zero3)

        dir_in = normalize(d)
        u, v, w = _bounce_rands(pixel, frame, salt_base, bounce)
        pos_out, dir_out, fac = brdf.shade_and_scatter(
            isect.pos, isect.normal, dir_in, mat, u, v, w)
        a3 = active[:, None]
        thr = torch.where(a3, thr * fac, thr)
        o = torch.where(a3, pos_out, o)
        d = torch.where(a3, dir_out, d)
    if settings.style == "standard":
        result = result + torch.where(active[:, None], col, zero3)
    return result


INTEGRATORS = {KAJIYA: integrator_kajiya}


def eval_integrator(mode: int, scene, ray, pixel, frame, settings, salt_base=0):
    """Dispatch by integrator id (compute_pass.comp:68-99)."""
    if int(mode) not in INTEGRATORS:
        raise NotImplementedError(
            f"integrator {mode} is not ported yet; the port serves Kajiya (9)")
    return INTEGRATORS[int(mode)](scene, ray, pixel, frame, settings, salt_base)
